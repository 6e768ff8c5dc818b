"""I420 (planar YUV 4:2:0) from tonemapped u8 RGB: the plain forms of the
JAX package's two conversions, and the planar kernel (``csrc/yuv420.cu``).

The JAX package converts in XLA (taichi_image_tpu/models/camera_isp.py):

  * ``yuv420_from_planar_u8`` (:1406): planar u8 (N, 3, H, W) -> Y, VU,
    the matrix per pixel and then the 2x2 block mean. Its kernels are
    :func:`yuv420_planar` (u8 in, the odd-stride route) and
    :func:`yuv420_planar_tone`, which also takes in the resize route's
    tonemap and transform before it (``reinhard_apply_ca`` or
    ``linear_apply_ca``, ``_transform_planar``: :1721-1727, :1790-1792) and
    never writes the u8 RGB.
  * ``yuv420_from_phases_u8`` (:1485): u8 phase-RGB (N, 12, hh, wh) -> Y,
    VU. The block mean is the mean over the four phases, taken before the
    matrix; the bf16 pipeline computes the whole conversion as one bf16
    dot (``_yuv420_phases_dot_bf16``, :1457, over ``_yuv420_w6``, :1435)
    and the others as f32 chains. On the card this runs inside K4's I420
    mode (``ops/hopper/finish.py`` ``finish_yuv420``), which never writes
    the u8 RGB.

Both keep the reference's quirks: the matrix applies to the
channel-reversed (b, g, r) vector, the chroma planes are V then U, and
the clamp is ``min(1, x)`` before the u8 truncation.

The sums run in one fixed order that the kernels share, every product and
sum rounded in f32 (the kernels are built with ``--fmad=false``):

  * a matrix row on (b, g, r): ``(m0 b + m1 g) + m2 r``, + the offset;
  * planar block mean: ``((tl + tr) + bl) + br`` of the output's block,
    after the transform, then * 0.25;
  * phase mean (f32 chains): the four phases in the output's phase order
    (after the transform's permutation), sequentially, then * 0.25;
  * the bf16 dot: the channels in ascending order, (r, g, b) within a
    phase and the phases in the output's order, its zero coefficients
    skipped (adding a zero product cannot change an f32 sum of these
    terms).

``u8 / 255`` and ``sum / 255`` are true divisions on both sides: on a CUDA
tensor, torch divides by a Python scalar as a multiplication by its
reciprocal, so the twins divide by a 0-d tensor on the device. The
kernels read ``u8 / 255`` from :func:`inv255_table`, made once per device.

While tracing is on, each launch of :func:`yuv420_planar` and
:func:`yuv420_planar_tone` counts its path, ``planar_u8`` or
``planar_tone`` (``utils/profiling.py`` ``i420_paths``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from taichi_image_tpu_torch.ops import hopper, interpolate
from taichi_image_tpu_torch.ops.bayer import _TRANSFORM_SFF
from taichi_image_tpu_torch.ops.color import _YUV_M, _YUV_OFFSET
# finish imports this module too; only its functions are used, at call time
from taichi_image_tpu_torch.ops.hopper import finish
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.utils import profiling

__all__ = ["yuv420_w6", "yuv420_from_phases_u8", "yuv420_phases_dot_bf16",
           "yuv420_planar", "yuv420_planar_plain", "yuv420_planar_tone",
           "yuv420_planar_tone_plain", "check_even", "coefficients",
           "coefficients_ptr", "inv255_table"]

KERNEL = hopper.register(
    "yuv420_planar", "yuv420.cu", "tit_yuv420_planar",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p],
    "taichi_image_tpu/models/camera_isp.py:1406")
TONE_KERNELS = hopper.register_per_dtype(
    "yuv420_planar_tone", "yuv420.cu", "tit_yuv420_planar_tone",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    dict.fromkeys(hopper.DTYPE_SUFFIX,
                  "taichi_image_tpu/models/camera_isp.py:1721"))


def yuv420_w6() -> np.ndarray:
  """(6, 12) channel-contraction matrix of the bf16 dot: rows 0-3 the Y of
  phase p (BT.601 row 0 on that phase's channel-reversed vector), rows 4-5
  V and U of the phase mean (rows 2 and 1, each coefficient / 4). Channel
  layout: 12 = 4 phases x (r, g, b)."""
  w = np.zeros((6, 12), np.float32)
  for p in range(4):
    w[p, 3 * p + 2] = float(_YUV_M[0, 0])   # b
    w[p, 3 * p + 1] = float(_YUV_M[0, 1])   # g
    w[p, 3 * p + 0] = float(_YUV_M[0, 2])   # r
  for row, mrow in ((4, 2), (5, 1)):        # V then U
    for p in range(4):
      w[row, 3 * p + 2] = float(_YUV_M[mrow, 0]) / 4.0
      w[row, 3 * p + 1] = float(_YUV_M[mrow, 1]) / 4.0
      w[row, 3 * p + 0] = float(_YUV_M[mrow, 2]) / 4.0
  return w


@functools.cache
def _dot_rows():
  """The bf16-rounded (r, g, b) coefficients of Y, V and U, as f32
  values."""
  w = torch.from_numpy(yuv420_w6()).to(torch.bfloat16).float().numpy()
  return w[0, 0:3], w[4, 0:3], w[5, 0:3]


@functools.cache
def coefficients(dot: bool) -> np.ndarray:
  """The (12,) f32 block the kernels take: the Y, U and V rows, then the
  Y, U and V offsets. f32 chains: the BT.601 rows on (b, g, r). The bf16
  dot: its bf16-rounded rows on (r, g, b)."""
  if dot:
    y, v, u = _dot_rows()
    rows = [y, u, v]
  else:
    rows = [_YUV_M[0], _YUV_M[1], _YUV_M[2]]
  return np.ascontiguousarray(np.concatenate([*rows, _YUV_OFFSET]),
                              np.float32)


@functools.cache
def coefficients_ptr(dot: bool) -> ctypes.c_void_p:
  """:func:`coefficients` as the launchers' pointer, made once (numpy's
  ``ctypes`` view costs tens of microseconds a call, as long as the
  planar kernels themselves); the cached array stays alive."""
  return coefficients(dot).ctypes.data_as(ctypes.c_void_p)


@functools.cache
def inv255_table(device: torch.device) -> torch.Tensor:
  """(256,) f32 k / 255 on ``device``, each the IEEE quotient: the table
  the I420 kernels read ``u8 / 255`` from (one per device, so no block
  divides before its first load)."""
  return torch.from_numpy(np.arange(256, dtype=np.float32)
                          / np.float32(255)).to(device)


def _div255(x: torch.Tensor) -> torch.Tensor:
  """x / 255 as a true division on either device."""
  return x / torch.full((), 255.0, device=x.device)


def _u8(v: torch.Tensor) -> torch.Tensor:
  """trunc(clip(min(1, v) * 255, 0, 255)) as u8."""
  return torch.clamp(torch.clamp_max(v, 1.0) * 255.0, 0.0, 255.0).to(
      torch.uint8)


def _row(m, b, g, r, off):
  """``(m0 b + m1 g) + m2 r + off``, f32."""
  return ((b * float(m[0]) + g * float(m[1])) + r * float(m[2])) + float(off)


def _phases_to_plane(x4: torch.Tensor) -> torch.Tensor:
  """(N, 4, hh, wh) single-channel phases -> (N, H, W); phase p holds
  (row, col) parity (p % 2, p // 2)."""
  n, _, hh, wh = x4.shape
  return x4.reshape(n, 2, 2, hh, wh).permute(0, 3, 2, 4, 1).reshape(
      n, 2 * hh, 2 * wh)


def check_even(h: int, w: int) -> None:
  if h % 2 or w % 2:
    raise ValueError(f"yuv420 output needs even output dims, got {(h, w)}")


def yuv420_phases_dot_bf16(out12: torch.Tensor):
  """The bf16 pipeline's I420 from u8 phase-RGB (N, 12, hh, wh): the sums
  of u8 x the bf16-rounded :func:`yuv420_w6` coefficients in f32, / 255,
  + the offset, ``min(1, .)``, u8. Returns (Y (N, H, W), VU (N, 2, hh,
  wh))."""
  n, _, hh, wh = out12.shape
  x = out12.to(torch.float32).reshape(n, 4, 3, hh, wh)
  wy, wv, wu = _dot_rows()
  r, g, b = x[:, :, 0], x[:, :, 1], x[:, :, 2]
  y = (r * float(wy[0]) + g * float(wy[1])) + b * float(wy[2])

  def chroma(w):
    acc = None
    for p in range(4):
      for c in range(3):
        t = x[:, p, c] * float(w[c])
        acc = t if acc is None else acc + t
    return acc

  off = _YUV_OFFSET
  y_u8 = _u8(_div255(y) + float(off[0]))
  vu = torch.stack([_div255(chroma(wv)) + float(off[2]),
                    _div255(chroma(wu)) + float(off[1])], dim=1)
  return _phases_to_plane(y_u8), _u8(vu)


def yuv420_from_phases_u8(out12: torch.Tensor, mxu: bool = False):
  """Tonemapped u8 phase-RGB (N, 12, hh, wh), in the output's phase order
  -> planar I420 u8 (Y (N, H, W), VU (N, 2, hh, wh)). ``mxu`` (the bf16
  pipeline) takes the dot formulation; otherwise the f32 chains: Y per
  phase from x = u8 / 255, and the chroma of the phase means."""
  if mxu:
    return yuv420_phases_dot_bf16(out12)
  n, _, hh, wh = out12.shape
  x = _div255(out12.to(torch.float32)).reshape(n, 4, 3, hh, wh)
  b, g, r = x[:, :, 2], x[:, :, 1], x[:, :, 0]
  m, off = _YUV_M, _YUV_OFFSET
  y_u8 = _phases_to_plane(_u8(_row(m[0], b, g, r, off[0])))

  def phase_mean(c):
    return (((c[:, 0] + c[:, 1]) + c[:, 2]) + c[:, 3]) * 0.25

  mb, mg, mr = phase_mean(b), phase_mean(g), phase_mean(r)
  vu = torch.stack([_row(m[2], mb, mg, mr, off[2]),
                    _row(m[1], mb, mg, mr, off[1])], dim=1)
  return y_u8, _u8(vu)


def yuv420_planar_plain(rgb: torch.Tensor):
  """Plain PyTorch twin of the planar kernel: planar u8 (N, 3, H, W) ->
  (Y (N, H, W), VU (N, 2, H/2, W/2)); the matrix per pixel on x = u8 /
  255, then the block mean."""
  n, _, h, w = rgb.shape
  x = _div255(rgb.to(torch.float32))
  b, g, r = x[:, 2], x[:, 1], x[:, 0]
  m, off = _YUV_M, _YUV_OFFSET

  def block_mean(p):
    p = p.reshape(n, h // 2, 2, w // 2, 2)
    return (((p[:, :, 0, :, 0] + p[:, :, 0, :, 1]) + p[:, :, 1, :, 0])
            + p[:, :, 1, :, 1]) * 0.25

  vu = torch.stack([block_mean(_row(m[2], b, g, r, off[2])),
                    block_mean(_row(m[1], b, g, r, off[1]))], dim=1)
  return _u8(_row(m[0], b, g, r, off[0])), _u8(vu)


def yuv420_planar(rgb: torch.Tensor, backend: str = "auto"):
  """Planar u8 RGB (N, 3, H, W), H and W even -> planar I420 u8 (Y (N, H,
  W), VU (N, 2, H/2, W/2)); bitwise equal to the plain twin."""
  if rgb.ndim != 4 or rgb.shape[1] != 3:
    raise ValueError(f"yuv420 input must be (N, 3, H, W), got "
                     f"{tuple(rgb.shape)}")
  if rgb.dtype != torch.uint8:
    raise ValueError(f"yuv420 input must be uint8, got {rgb.dtype}")
  n, _, h, w = rgb.shape
  check_even(h, w)
  if not hopper.use_kernel(backend, rgb):
    return yuv420_planar_plain(rgb)
  hopper.check_tensor("rgb", rgb, torch.uint8, 4, rgb.device)
  hopper.check_int32_extent(f"a {h}x{w} planar RGB image", 3 * h * w)
  y = torch.empty((n, h, w), dtype=torch.uint8, device=rgb.device)
  vu = torch.empty((n, 2, h // 2, w // 2), dtype=torch.uint8,
                   device=rgb.device)
  KERNEL.launch(rgb.device, hopper.ptr(rgb), hopper.ptr(y), hopper.ptr(vu), n,
                h, w, coefficients_ptr(False),
                hopper.ptr(inv255_table(rgb.device)))
  if profiling.ON:
    profiling.count_i420_path("planar_u8")
  return y, vu


def yuv420_planar_tone_plain(x: torch.Tensor, scal: torch.Tensor,
                             gamma: float, mode: str = "reinhard",
                             transform: ImageTransform = ImageTransform.none):
  """Plain PyTorch twin of the tonemap form: the finish's u8 of the
  planar ``x``, the transform, then :func:`yuv420_planar_plain`."""
  u8 = interpolate.transform_axes(finish._tone_u8(x, scal, gamma, mode),
                                  transform, 2, 3)
  return yuv420_planar_plain(u8.contiguous())


def yuv420_planar_tone(x: torch.Tensor, scal: torch.Tensor, gamma: float,
                       mode: str = "reinhard",
                       transform: ImageTransform = ImageTransform.none,
                       backend: str = "auto"):
  """The resize route's I420 tail in one pass: untransformed planar
  (N, 3, h, w) of the working dtype (bf16, f16 or f32), h and w even ->
  planar I420 u8 ``(Y (N, h', w'), VU (N, 2, h'/2, w'/2))`` of the
  transformed image, V then U; bitwise equal to the plain twin.

  ``mode="reinhard"``: ``x`` is K3's p and ``scal`` its per-image f32 max
  (N, 1, 1, 1). ``mode="linear"``: ``x`` is the image and ``scal`` is
  ``finish.linear_scal`` of the metrics."""
  finish._check_finish(x, scal, mode, channels=3)
  n, _, h, w = x.shape
  check_even(h, w)
  if not hopper.use_kernel(backend, x):
    return yuv420_planar_tone_plain(x, scal, gamma, mode, transform)
  hopper.check_tensor("x", x, x.dtype, 4, x.device)
  hopper.check_tensor("scal", scal, torch.float32, scal.ndim, x.device)
  hopper.check_int32_extent(f"a {h}x{w} planar image", 3 * h * w)
  swap, fy, fx = _TRANSFORM_SFF[transform]
  ho, wo = (w, h) if swap else (h, w)
  dev = x.device
  y = torch.empty((n, ho, wo), dtype=torch.uint8, device=dev)
  vu = torch.empty((n, 2, ho // 2, wo // 2), dtype=torch.uint8, device=dev)
  linear, tone, inv_gamma = finish.tone_args(gamma, mode)
  TONE_KERNELS[x.dtype].launch(
      dev, hopper.ptr(x), hopper.ptr(scal), hopper.ptr(y), hopper.ptr(vu), n,
      h, w, linear, tone, inv_gamma, int(swap), int(fy), int(fx),
      coefficients_ptr(False), hopper.ptr(inv255_table(dev)))
  finish.count_tone(tone)
  if profiling.ON:
    profiling.count_i420_path("planar_tone")
  return y, vu
