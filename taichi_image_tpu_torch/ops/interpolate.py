"""Bilinear/nearest resize and the eight axis-aligned image transforms
(counterpart of ``taichi_image_tpu/ops/interpolate.py``).

Images are HWC (the public API's layout). The sample positions come
from :func:`_axis_samples`, built in numpy and bitwise the same as the
JAX package's; the bilinear gather is separable (rows, then columns),
each a gather plus ``lo + f * (hi - lo)`` in f32. The ISP's resize runs
on phase planes instead (the K12 kernel, ``ops/hopper/resize.py``) with
the same taps.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from taichi_image_tpu_torch import types

__all__ = [
    "ImageTransform", "transform", "transformed_size",
    "resize_bilinear", "resize_nearest", "resize_width", "scale_bilinear",
]


class ImageTransform(Enum):
  none = "none"
  rotate_90 = "rotate_90"
  rotate_180 = "rotate_180"
  rotate_270 = "rotate_270"
  transpose = "transpose"
  flip_horiz = "flip_horiz"
  flip_vert = "flip_vert"
  transverse = "transverse"


def transformed_size(size, t: ImageTransform):
  """Output (a, b) under transform for input size (a, b)."""
  a, b = size
  if t in (ImageTransform.rotate_90, ImageTransform.rotate_270,
           ImageTransform.transpose, ImageTransform.transverse):
    return (b, a)
  return (a, b)


def transform_axes(x: torch.Tensor, t: ImageTransform, ay: int,
                   ax: int) -> torch.Tensor:
  """One of the eight transforms on axes (``ay``, ``ax``) of ``x``:
  rotate_90 is clockwise (dst[i, j] = src[H-1-j, i]), transverse the
  anti-transpose. A view where torch allows one."""
  if t == ImageTransform.none:
    return x
  if t == ImageTransform.rotate_90:
    return torch.rot90(x, -1, (ay, ax))
  if t == ImageTransform.rotate_180:
    return torch.rot90(x, 2, (ay, ax))
  if t == ImageTransform.rotate_270:
    return torch.rot90(x, 1, (ay, ax))
  if t == ImageTransform.transpose:
    return x.transpose(ay, ax)
  if t == ImageTransform.flip_horiz:
    return x.flip(ax)
  if t == ImageTransform.flip_vert:
    return x.flip(ay)
  if t == ImageTransform.transverse:
    return x.transpose(ay, ax).flip((ay, ax))
  raise ValueError(f"unknown transform {t}")


def transform(src, t: ImageTransform) -> torch.Tensor:
  """Apply one of the eight axis-aligned transforms to an HWC image."""
  return transform_axes(torch.as_tensor(src), t, 0, 1)


def _axis_samples(n_out: int, n_in: int, scale: float):
  """Truncation-split sample positions along one axis: p = i/scale,
  i0 = trunc(p), frac = p - i0, taps clamped to [0, n_in-1]. numpy, the
  JAX package's arithmetic: (lo int32, hi int32, frac f32)."""
  p = np.arange(n_out, dtype=np.float32) / np.float32(scale)
  i0 = p.astype(np.int32)
  frac = p - i0.astype(np.float32)
  lo = np.clip(i0, 0, n_in - 1)
  hi = np.clip(i0 + 1, 0, n_in - 1)
  return lo, hi, frac


def _taps(n_out, n_in, scale, device):
  lo, hi, f = _axis_samples(n_out, n_in, scale)
  return (torch.from_numpy(lo.astype(np.int64)).to(device),
          torch.from_numpy(hi.astype(np.int64)).to(device),
          torch.from_numpy(f).to(device))


def bilinear_axes(x: torch.Tensor, h_out: int, w_out: int, sy: float,
                  sx: float, ay: int, ax: int) -> torch.Tensor:
  """The f32 bilinear resample of axes (``ay``, ``ax``) of ``x`` to
  (h_out, w_out): rows first (the reference's frac.x mixes rows), then
  columns, each a gather plus ``lo + f * (hi - lo)``."""
  r_lo, r_hi, r_f = _taps(h_out, x.shape[ay], sy, x.device)
  c_lo, c_hi, c_f = _taps(w_out, x.shape[ax], sx, x.device)
  x = x.to(torch.float32)
  along_y = [-1 if d == ay else 1 for d in range(x.ndim)]
  along_x = [-1 if d == ax else 1 for d in range(x.ndim)]
  top, bot = x.index_select(ay, r_lo), x.index_select(ay, r_hi)
  rows = top + r_f.reshape(along_y) * (bot - top)
  left, right = rows.index_select(ax, c_lo), rows.index_select(ax, c_hi)
  return left + c_f.reshape(along_x) * (right - left)


def _resize_bilinear(src, size, scale, in_dtype, out_dtype):
  w_out, h_out = size
  sy, sx = scale
  out = bilinear_axes(src, h_out, w_out, sy, sx, 0, 1)
  intensity_scale = types.scale_of(out_dtype) / types.scale_of(in_dtype)
  out = out * float(np.float32(intensity_scale))
  out_dt = types.canonical_dtype(out_dtype)
  if not out_dt.is_floating_point:
    out = torch.clamp(out, 0, types.scale_of(out_dtype))
  return out.to(out_dt)


def _resize_nearest(src, size, scale, in_dtype, out_dtype):
  h_in, w_in = src.shape[:2]
  w_out, h_out = size
  sy, sx = scale
  r_lo, _, _ = _taps(h_out, h_in, sy, src.device)
  c_lo, _, _ = _taps(w_out, w_in, sx, src.device)
  out = src.index_select(0, r_lo).index_select(1, c_lo)
  intensity_scale = types.scale_of(out_dtype) / types.scale_of(in_dtype)
  if intensity_scale != 1.0:
    out = out.to(torch.float32) * float(np.float32(intensity_scale))
  out_dt = types.canonical_dtype(out_dtype)
  if not out_dt.is_floating_point and intensity_scale != 1.0:
    out = torch.clamp(out, 0, types.scale_of(out_dtype))
  return out.to(out_dt)


def _norm_scale_hw(h, w, size, scale):
  """Per-axis (scale_y, scale_x) for a resize: None derives from the
  target size; a scalar applies to both axes."""
  if scale is None:
    return (size[1] / h, size[0] / w)
  if isinstance(scale, (int, float)) or np.ndim(scale) == 0:
    return (float(scale), float(scale))
  return (float(scale[0]), float(scale[1]))


def _norm_scale(src, size, scale):
  h, w = src.shape[:2]
  return _norm_scale_hw(h, w, size, scale)


def _resize(fn, src, size, scale, dtype):
  src = torch.as_tensor(src)
  in_dtype = types.dtype_of(src)
  out_dtype = in_dtype if dtype is None else types.canonical_dtype(dtype)
  size = (int(size[0]), int(size[1]))
  return fn(src, size, _norm_scale(src, size, scale), in_dtype, out_dtype)


def resize_bilinear(src, size, scale=None, dtype=None) -> torch.Tensor:
  """Resize an HWC image to ``size=(w, h)`` with the reference's
  truncation-anchored 4-tap bilinear sampling."""
  return _resize(_resize_bilinear, src, size, scale, dtype)


def resize_nearest(src, size, scale=None, dtype=None) -> torch.Tensor:
  """Nearest-neighbour resize (the low tap of each axis)."""
  return _resize(_resize_nearest, src, size, scale, dtype)


def resize_width(src, width: int, dtype=None) -> torch.Tensor:
  """Aspect-preserving resize to a target width."""
  h, w = src.shape[:2]
  scale = width / w
  size = (width, int(h * scale))
  return resize_bilinear(src, size, scale, dtype)


def scale_bilinear(src, scale, dtype=None) -> torch.Tensor:
  """Scale-factor resize."""
  h, w = src.shape[:2]
  size = (int(w * scale), int(h * scale))
  return resize_bilinear(src, size, scale, dtype=dtype)
