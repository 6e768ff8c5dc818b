"""K1, the packed12 decode (``decode_<T>``): raws in, the four CFA phase
planes of the working dtype out (chip_smoke's stage table)."""

from isp_bench.work.isp_set import STAGE_OPS, item_bytes, pixels

SYMBOLS = ("decode12_kernel",)


def logical_bytes(cfg: dict, color_format: str) -> int:
  return pixels(cfg) * 3 // 2 + pixels(cfg) * item_bytes(cfg)


def ops(cfg: dict, color_format: str) -> float:
  return STAGE_OPS["decode"] * pixels(cfg)
