"""Host time per set inside the ISP instance's ``process`` (the staging
copy into the pinned ring included), from the benchmark's own span,
averaged over every set of the window."""

from isp_bench import reduce


def read(run):
  return reduce.span_ms_per_set(run.spans, "process")
