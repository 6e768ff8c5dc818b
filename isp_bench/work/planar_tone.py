"""P, the resize route's RGB tail (``finish_planar_tone_<T>``): p and
each image's max in, planar u8 RGB out, the transform in its stores
(chip_smoke's stage table)."""

from isp_bench.work.isp_set import item_bytes, out_pixels, tone_ops

SYMBOLS = ("planar_tone_rows_kernel", "planar_tone_swap_kernel")


def logical_bytes(cfg: dict, color_format: str) -> int:
  return 3 * out_pixels(cfg) * (item_bytes(cfg) + 1) + 4 * cfg["cameras"]


def ops(cfg: dict, color_format: str) -> float:
  return 3 * tone_ops(cfg) * out_pixels(cfg)
