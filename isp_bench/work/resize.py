"""K12, the bilinear resize (``resize_<T>``): the 12-channel phase RGB
that its taps touch in, the resized planar RGB of the working dtype out
(chip_smoke's stage table)."""

import torch

from isp_bench.reference import isp as ref
from isp_bench.work.isp_set import STAGE_OPS, item_bytes, out_pixels

SYMBOLS = ("resize_kernel",)


def _touched(n_out: int, n_in: int, scale: float) -> int:
  """Full-resolution rows (or columns) that the taps of one axis read."""
  lo, hi, _ = ref.resize_samples(n_out, n_in, scale)
  return torch.cat([lo, hi]).unique().numel()


def logical_bytes(cfg: dict, color_format: str) -> int:
  h, w = cfg["height"], cfg["width"]
  h_out, w_out, scale = ref.resize_plan(h, w, int(cfg["resize_width"]))
  x12 = (cfg["cameras"] * 3 * _touched(h_out, h, scale)
         * _touched(w_out, w, scale))
  return (x12 + 3 * out_pixels(cfg)) * item_bytes(cfg)


def ops(cfg: dict, color_format: str) -> float:
  return STAGE_OPS["resize"] * out_pixels(cfg)
