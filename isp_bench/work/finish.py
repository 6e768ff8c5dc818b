"""K4, the tail (``finish_<T>``): p and each image's max in, planar u8
RGB out, the transform in its stores (chip_smoke's stage table)."""

from isp_bench.work.isp_set import item_bytes, pixels, tone_ops

SYMBOLS = ("finish_rows_kernel", "finish_swap_kernel")


def logical_bytes(cfg: dict, color_format: str) -> int:
  return 3 * pixels(cfg) * (item_bytes(cfg) + 1) + 4 * cfg["cameras"]


def ops(cfg: dict, color_format: str) -> float:
  return 3 * tone_ops(cfg) * pixels(cfg)
