"""K4's I420 mode (``finish_yuv420_<T>``): p and each image's max in,
planar I420 u8 out (Y a pixel, V and U a 2x2 block), the tone and the
conversion in one pass (chip_smoke's stage table).

No ``SYMBOLS``: the kernel is no trace family, so its trace label stays
its own name, which ``layer_metrics/finish_yuv420_roofline.py`` selects."""

from isp_bench.work.isp_set import STAGE_OPS, item_bytes, pixels, tone_ops


def logical_bytes(cfg: dict, color_format: str) -> int:
  n = pixels(cfg)
  return 3 * n * item_bytes(cfg) + n * 3 // 2 + 4 * cfg["cameras"]


def ops(cfg: dict, color_format: str) -> float:
  return (3 * tone_ops(cfg) + STAGE_OPS["i420"]) * pixels(cfg)
