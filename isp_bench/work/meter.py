"""M, the EMA metering (``meter_<T>``; its split form's three kernels on a
device whose SMs cannot hold its grid): the sample of the output (the
resized image on the resize route) in, 21 floats out (chip_smoke's stage
table)."""

from isp_bench.work.isp_set import STAGE_OPS, item_bytes, sample_pixels

SYMBOLS = ("meter_kernel", "bounds_kernel", "stats_kernel",
           "finalize_kernel")


def logical_bytes(cfg: dict, color_format: str) -> int:
  # the sample, the previous vec9 in; vec9, the map's and the linear
  # tonemap's vectors out
  return 3 * sample_pixels(cfg) * item_bytes(cfg) + 4 * (9 + 21)


def ops(cfg: dict, color_format: str) -> float:
  return STAGE_OPS["meter_per_sample_pixel"] * sample_pixels(cfg)
