"""M, the EMA metering (``meter_<T>``; its split form's three kernels on a
device whose SMs cannot hold its grid): the sample in, 21 floats out
(chip_smoke's stage table)."""

from isp_bench.work.isp_set import STAGE_OPS, item_bytes

SYMBOLS = ("meter_kernel", "bounds_kernel", "stats_kernel",
           "finalize_kernel")


def _sample_pixels(cfg: dict) -> int:
  s = cfg["metering_stride"]
  return cfg["cameras"] * -(-cfg["height"] // s) * -(-cfg["width"] // s)


def logical_bytes(cfg: dict, color_format: str) -> int:
  # the sample, the previous vec9 in; vec9, the map's and the linear
  # tonemap's vectors out
  return 3 * _sample_pixels(cfg) * item_bytes(cfg) + 4 * (9 + 21)


def ops(cfg: dict, color_format: str) -> float:
  return STAGE_OPS["meter_per_sample_pixel"] * _sample_pixels(cfg)
