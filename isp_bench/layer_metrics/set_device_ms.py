"""The card's span of a set, ms: from the program's start marker of a set
(a CUDA event on the set's stream as its ``process`` opens) to its end
marker (as it returns), mean over the sets its tracer marked and resolved:
the set's kernels and the gaps between them, on the card's own clock.
Missing unless the program's tracer marked a set in the run, and where
it left a set unmarked (``unmarked_sets``: more sets pending on the device
than it keeps), since the mean would then cover only some of the sets."""

from isp_bench import program_tracer


def read(run):
  markers = (program_tracer.snapshot() or {}).get("markers")
  if (not markers or not markers.get("sets")
      or markers.get("unmarked_sets")):
    return None
  return markers["set_device_ns"] / markers["sets"] / 1e6
