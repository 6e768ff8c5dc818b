"""The card idle between one set and the next, waiting on the host, ms:
from the program's end marker of a set to the start marker of the set
after it (both CUDA events on the sets' stream, the second recorded as the
next ``process`` opens), mean over the pairs of sets its tracer marked one
after the other while it stayed on. Near 0 while the launch queue holds
the next set. Missing unless the program's tracer marked such a pair in
the run, and where it left a set unmarked (``unmarked_sets``: more sets
pending on the device than it keeps), since the mean would then cover only
some of the pairs."""

from isp_bench import program_tracer


def read(run):
  markers = (program_tracer.snapshot() or {}).get("markers")
  if (not markers or markers.get("unmarked_sets")
      or not markers.get("waited_sets")):
    return None
  return markers["wait_ns"] / markers["waited_sets"] / 1e6
