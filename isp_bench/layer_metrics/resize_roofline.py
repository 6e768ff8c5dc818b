"""K12's share of its bound, in %: the least time its work needs over its
mean device time a launch, in the slices that hold every kernel the
program launched in them. The least time is the larger of the family's
logical bytes over the memory rate and its operations over the float32
rate (``work/resize.py``), as the run's kernel notes compute it. Missing
where no complete slice holds a K12 launch."""

from isp_bench import manifest, peaks, reduce

FAMILY = "resize"


def share(run, family: str):
  """``family``'s bound over its mean device time a launch, in %, over
  the complete slices; None where they hold no launch of it."""
  durs = [op.dur for sl in reduce.complete(run.slices) for op in sl.device
          if op.kind == reduce.KERNEL and op.label == family]
  if not durs:
    return None
  work = manifest.module("work", family)
  color = run.traffic["color_format"]
  bound_s = max(work.logical_bytes(run.cfg, color) / peaks.HBM_BYTES_S,
                work.ops(run.cfg, color) / peaks.F32_FLOPS)
  return 100.0 * bound_s * 1e6 / (sum(durs) / len(durs))


def read(run):
  return share(run, FAMILY)
