"""K3, the Reinhard map (``reinhard_<T>``): the phase RGB (the resized
planar RGB on the resize route) and the map's six scalars in, p of the
working dtype and each image's max out (chip_smoke's stage table)."""

from isp_bench.work.isp_set import STAGE_OPS, item_bytes, out_pixels

SYMBOLS = ("map_kernel",)


def logical_bytes(cfg: dict, color_format: str) -> int:
  return 2 * 3 * out_pixels(cfg) * item_bytes(cfg) + 4 * (6 + cfg["cameras"])


def ops(cfg: dict, color_format: str) -> float:
  return STAGE_OPS["map"] * out_pixels(cfg)
