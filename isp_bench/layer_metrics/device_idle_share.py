"""Share of the traced slices in which no kernel, memset or copy ran on
the device (the union of their intervals, not a sum), in %, over the
slices that hold every kernel the program launched in them; missing
where none does."""

from isp_bench import reduce


def read(run):
  slices = reduce.complete(run.slices)
  if not slices:
    return None
  busy, window = reduce.busy_window_s(slices)
  return 100.0 * (1.0 - busy / window)
