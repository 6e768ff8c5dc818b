"""The least time a set's work needs over ``kernel_ms``, in %. The least
time is the larger of the set's irreducible bytes over the memory rate
and its operations over the float32 rate (``work/isp_set.py``): it does
not depend on which kernels carry the work, so a fusion reads higher and
a removed kernel leaves it defined. Over the slices ``kernel_ms`` reads."""

from isp_bench import peaks, reduce
from isp_bench.work import isp_set


def read(run):
  slices = reduce.complete(run.slices)
  if not slices:
    return None
  ms = reduce.ms_per_set(slices, (reduce.KERNEL, reduce.MEMSET))
  if ms is None:
    return None
  color = run.traffic["color_format"]
  least_s = max(isp_set.irreducible_bytes(run.cfg, color) / peaks.HBM_BYTES_S,
                isp_set.ops(run.cfg, color) / peaks.F32_FLOPS)
  return 100.0 * least_s * 1e3 / ms
