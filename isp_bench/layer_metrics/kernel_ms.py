"""Summed device time per set of every kernel and memset in the trace
slices that hold every kernel the program launched in them; missing
where none does."""

from isp_bench import reduce


def read(run):
  slices = reduce.complete(run.slices)
  if not slices:
    return None
  return reduce.ms_per_set(slices, (reduce.KERNEL, reduce.MEMSET))
