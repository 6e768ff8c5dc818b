"""The program's sets enqueued on the card and not finished when a new set
opens, mean over the sets its tracer marked and resolved (read from the
sets' end markers without waiting): near 0 the launch queue is empty and
the card waits on the host, in the tens it is full. Missing unless the
program's tracer marked a set in the run, and where it left a set unmarked
(``unmarked_sets``: more sets pending on the device than it keeps), since
the mean would then cover only some of the sets."""

from isp_bench import program_tracer


def read(run):
  markers = (program_tracer.snapshot() or {}).get("markers")
  if (not markers or not markers.get("sets")
      or markers.get("unmarked_sets")):
    return None
  return markers["in_flight"] / markers["sets"]
