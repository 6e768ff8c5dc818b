"""Color conversions: grayscale, sRGB helpers and planar YUV420 (I420).

Counterpart of ``taichi_image_tpu/ops/color.py``, in plain torch on the
tensor's device (the JAX package leaves this math to XLA). Images are
channels-last (..., 3) tensors; a host array is moved to ``device`` (the
card by default), a tensor is taken on its own device.

The reference's quirks are kept:
  * the conversion matrix is applied to the channel-reversed vector
    (``rgb_YCrCb(rgb) = M @ rgb.bgr``) and inverted on the way back;
  * the UV planes are written V then U (plane 0 is V);
  * the clamp is ``min(1, x)``, an upper clamp only.

A 3x3 matrix is applied as ``(x0 * m0 + x1 * m1) + x2 * m2`` per row, with
every product and sum rounded in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from taichi_image_tpu_torch import types

__all__ = [
    "rgb_gray", "bgr_gray", "rgb_linear", "rgb_ciexyz",
    "rgb_yuv420", "yuv420_rgb", "split_yuv_420",
    "rgb_yuv420_image", "yuv420_rgb_image",
    "bgr_YCrCb", "rgb_YCrCb", "YCrCb_bgr", "YCrCb_rgb",
]

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)

# Full-range BT.601, applied to the channel-reversed input vector.
_YUV_M = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
], np.float32)
_YUV_M_INV = np.linalg.inv(_YUV_M.astype(np.float64)).astype(np.float32)
_YUV_OFFSET = np.array([0.0, 0.5, 0.5], np.float32)

_XYZ_M = np.array([
    [0.4124564, 0.3575761, 0.1804375],
    [0.2126729, 0.7151522, 0.0721750],
    [0.0193339, 0.1191920, 0.9503041],
], np.float32)


def _mat3(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
  """(..., 3) -> (..., 3): row d is (x0 m[d, 0] + x1 m[d, 1]) + x2 m[d, 2]
  in f32."""
  x = x.to(torch.float32)
  c = [x[..., k] for k in range(3)]
  return torch.stack([(c[0] * float(m[d, 0]) + c[1] * float(m[d, 1]))
                      + c[2] * float(m[d, 2]) for d in range(3)], dim=-1)


def _offset(like: torch.Tensor) -> torch.Tensor:
  return torch.from_numpy(_YUV_OFFSET).to(like.device)


def bgr_YCrCb(bgr, device="cuda"):
  """(..., 3) BGR in [0, 1] -> full-range YCrCb with the +0.5 chroma
  offset."""
  bgr = types.as_tensor(bgr, device)
  return _mat3(bgr, _YUV_M) + _offset(bgr)


def rgb_YCrCb(rgb, device="cuda"):
  """(..., 3) RGB -> YCrCb: the matrix applies to the channel-reversed
  vector."""
  return bgr_YCrCb(types.as_tensor(rgb, device).flip(-1))


def YCrCb_bgr(ycrcb, device="cuda"):
  """Inverse of :func:`bgr_YCrCb` (the inverse matrix is computed in
  float64 at import, then rounded to f32)."""
  ycrcb = types.as_tensor(ycrcb, device).to(torch.float32)
  return _mat3(ycrcb - _offset(ycrcb), _YUV_M_INV)


def YCrCb_rgb(ycrcb, device="cuda"):
  return YCrCb_bgr(ycrcb, device).flip(-1)


def rgb_gray(rgb, device="cuda"):
  """Rec.601 luma: 0.299 R + 0.587 G + 0.114 B."""
  rgb = types.as_tensor(rgb, device)
  return (rgb[..., 0] * float(_GRAY[0]) + rgb[..., 1] * float(_GRAY[1])
          + rgb[..., 2] * float(_GRAY[2]))


def bgr_gray(bgr, device="cuda"):
  bgr = types.as_tensor(bgr, device)
  return (bgr[..., 0] * float(_GRAY[2]) + bgr[..., 1] * float(_GRAY[1])
          + bgr[..., 2] * float(_GRAY[0]))


def rgb_linear(rgb, device="cuda"):
  """sRGB EOTF linearization."""
  rgb = types.as_tensor(rgb, device)
  return torch.where(rgb <= 0.04045, rgb / 12.92,
                     torch.pow((rgb + 0.055) / 1.055, 2.4))


def rgb_ciexyz(rgb, device="cuda"):
  """sRGB -> CIEXYZ."""
  return _mat3(rgb_linear(rgb, device), _XYZ_M)


def _cast(v: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
  """Normalized f32 -> ``out_dtype``: scaled, clipped to [0, scale] for
  integers, truncated."""
  scale = types.scale_of(out_dtype)
  v = v * scale
  if not out_dtype.is_floating_point:
    v = torch.clamp(v, 0, scale)
  return v.to(out_dtype)


def _rgb_yuv420(src: torch.Tensor, in_dtype, out_dtype):
  h, w = src.shape[:2]
  x = src.to(torch.float32) / types.scale_of(in_dtype)
  yuv = _mat3(x.flip(-1), _YUV_M) + _offset(x)
  y = torch.clamp_max(yuv[..., 0], 1.0)
  uv = yuv[..., 1:].reshape(h // 2, 2, w // 2, 2, 2).sum(dim=(1, 3)) / 4.0
  uv = torch.clamp_max(uv, 1.0)
  # V-then-U plane order
  return (_cast(y, out_dtype),
          torch.stack([_cast(uv[..., 1], out_dtype),
                       _cast(uv[..., 0], out_dtype)], dim=0))


def _yuv420_rgb(y_img: torch.Tensor, uv_img: torch.Tensor, in_dtype,
                out_dtype):
  y = y_img.to(torch.float32)
  u = uv_img[1].to(torch.float32).repeat_interleave(2, 0).repeat_interleave(
      2, 1)
  v = uv_img[0].to(torch.float32).repeat_interleave(2, 0).repeat_interleave(
      2, 1)
  yuv = torch.stack([y, u, v], dim=-1) / types.scale_of(in_dtype)
  rgb = _mat3(yuv - _offset(yuv), _YUV_M_INV).flip(-1)
  return _cast(torch.clamp_max(rgb, 1.0), out_dtype)


def _out_dtype(in_dtype, dtype):
  return in_dtype if dtype is None else types.canonical_dtype(dtype)


def rgb_yuv420(src, dtype=None, device="cuda"):
  """(H, W, 3) RGB -> (Y (H, W), chroma (2, H/2, W/2)): per 2x2 block,
  4 Y samples and the mean of the 4 chroma samples, V then U."""
  src = types.as_tensor(src, device)
  in_dtype = types.dtype_of(src)
  return _rgb_yuv420(src, in_dtype, _out_dtype(in_dtype, dtype))


def yuv420_rgb(y_img, uv_img, dtype=None, device="cuda"):
  """(Y, UV planes) -> (H, W, 3) RGB."""
  y_img = types.as_tensor(y_img, device)
  uv_img = types.as_tensor(uv_img, device)
  in_dtype = types.dtype_of(y_img)
  return _yuv420_rgb(y_img, uv_img, in_dtype, _out_dtype(in_dtype, dtype))


def split_yuv_420(yuv):
  """Slice a single (3H/2, W) I420 buffer into Y and (2, H/2, W/2) UV."""
  height = yuv.shape[0] * 2 // 3
  width = yuv.shape[1]
  y = yuv[:height]
  uv = yuv[height:].reshape(2, height // 2, width // 2)
  return y, uv, (width, height)


def rgb_yuv420_image(src, dtype=None, device="cuda"):
  """(H, W, 3) RGB -> one (3H/2, W) planar I420 buffer."""
  src = types.as_tensor(src, device)
  y, uv = rgb_yuv420(src, dtype)
  h, w = src.shape[:2]
  return torch.cat([y, uv.reshape(h // 2, w)], dim=0)


def yuv420_rgb_image(yuv, dtype=None, device="cuda"):
  """(3H/2, W) planar I420 buffer -> (H, W, 3) RGB."""
  y, uv, _ = split_yuv_420(types.as_tensor(yuv, device))
  return yuv420_rgb(y, uv, dtype)
