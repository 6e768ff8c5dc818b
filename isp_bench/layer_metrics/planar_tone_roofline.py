"""P's share of its bound, in %: the least time its work needs over its
mean device time a launch, in the slices that hold every kernel the
program launched in them, from ``work/planar_tone.py`` by the arithmetic
of ``resize_roofline``. Missing where no complete slice holds a P
launch."""

from isp_bench import manifest

FAMILY = "planar_tone"


def read(run):
  return manifest.module("layer_metrics", "resize_roofline").share(run,
                                                                   FAMILY)
