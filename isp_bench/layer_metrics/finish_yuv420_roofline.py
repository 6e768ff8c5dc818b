"""K4's I420 mode's share of its bound, in %: the least time its work
needs (``work/finish_yuv420.py``) over its mean device time a launch, in
the slices that hold every kernel the program launched in them, by the
arithmetic of ``resize_roofline``. The kernel is no trace family, so its
launches are the kernels whose label holds the whole word
``finish_yuv420_kernel``. Missing where no complete slice holds one."""

import re

from isp_bench import manifest, peaks, reduce

KERNEL = re.compile(r"\bfinish_yuv420_kernel\b")


def read(run):
  durs = [op.dur for sl in reduce.complete(run.slices) for op in sl.device
          if op.kind == reduce.KERNEL and KERNEL.search(op.label)]
  if not durs:
    return None
  work = manifest.module("work", "finish_yuv420")
  color = run.traffic["color_format"]
  bound_s = max(work.logical_bytes(run.cfg, color) / peaks.HBM_BYTES_S,
                work.ops(run.cfg, color) / peaks.F32_FLOPS)
  return 100.0 * bound_s * 1e6 / (sum(durs) / len(durs))
