"""Image transforms (counterpart of ``taichi_image_tpu/ops/interpolate.py``).

Only the enum is here: the ISP constructor takes it. Resize and the
seven non-identity transforms are ROADMAP.md queue 1, item 7.
"""

from __future__ import annotations

from enum import Enum

__all__ = ["ImageTransform"]


class ImageTransform(Enum):
  none = "none"
  rotate_90 = "rotate_90"
  rotate_180 = "rotate_180"
  rotate_270 = "rotate_270"
  transpose = "transpose"
  flip_horiz = "flip_horiz"
  flip_vert = "flip_vert"
  transverse = "transverse"
