"""Host-side raw buffer validation (counterpart of
``taichi_image_tpu/utils/debug.py:37-75``).

Runs before any kernel launch, so a mis-shaped buffer raises a clear
``ValueError`` instead of reaching the decode kernel as an out-of-bounds
read.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["validate_raw"]


def _is_u8(dtype) -> bool:
  if isinstance(dtype, torch.dtype):
    return dtype == torch.uint8
  return np.dtype(dtype) == np.uint8


def validate_raw(raws, fmt: str, batch: bool = True) -> None:
  """Validate a raw frame (batch) against its claimed format.

  ``raws``: a torch tensor or numpy array, (N, H, W_bytes) if ``batch``
  else (H, W_bytes).
  """
  ndim = 3 if batch else 2
  if raws.ndim != ndim:
    raise ValueError(
        f"{fmt} raw batch must be {ndim}-D (N, H, W_bytes), got shape "
        f"{tuple(raws.shape)}")
  h, wb = raws.shape[-2], raws.shape[-1]
  if fmt in ("packed12", "packed16") and not _is_u8(raws.dtype):
    raise ValueError(f"{fmt} raw must be uint8 bytes, got {raws.dtype}")
  if fmt == "packed12":
    if wb % 3 != 0:
      raise ValueError(
          f"packed12 row stride must be a multiple of 3 bytes (2 pixels "
          f"per 3 bytes), got {wb}")
    w = wb * 2 // 3
  elif fmt == "packed16":
    if wb % 2 != 0:
      raise ValueError(
          f"packed16 row stride must be a multiple of 2 bytes, got {wb}")
    w = wb // 2
  elif fmt in ("u16", "f16", "f32"):
    w = wb
  else:
    raise ValueError(f"unknown raw format {fmt!r}")
  if h % 2 != 0 or w % 2 != 0:
    raise ValueError(
        f"CFA dimensions must be even for a 2x2 Bayer pattern, got "
        f"{h}x{w} (from {h}x{wb} raw bytes as {fmt}).")
