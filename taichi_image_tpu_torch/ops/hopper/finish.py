"""K4: the tonemap finish — the Reinhard gamma or the linear tonemap, u8
truncation, the 2x2 phase->planar interleave and the output transform
(``csrc/finish.cu``, one instantiation per working dtype of the input),
and its I420 mode (:func:`finish_yuv420`), which turns the same u8 RGB
into planar I420 without writing it.

Replaces ``taichi_image_tpu/ops/pallas/finish.py::finish_planar_u8``, both
its modes. In JAX this step is the XLA tail of the phase route
(``reinhard_gamma_ca`` or ``linear_apply_ca``, then
``planar_from_phases_transformed``); the Pallas form is opt-in there
only because Mosaic cannot store u8. Hopper writes u8 directly, so here
it is the phase route's tail, with the transform folded into the store
addresses. The I420 mode replaces the JAX phase route's XLA I420 tail
(``taichi_image_tpu/models/camera_isp.py:1774-1784``: the gamma or linear
u8, the phase transform, ``yuv420_from_phases_u8``).

:func:`finish_planar_tone` (P, ``finish_planar_tone_<T>``) is the resize
route's RGB tail in one pass: the same tone on the planar image (K3's map
or the resized image) and its store under the transform. It replaces the
JAX resize route's XLA tail (``reinhard_apply_ca`` or ``linear_apply_ca``,
then ``_transform_planar``: ``camera_isp.py:1721-1727``, ``:1790``); its
twin is that chain in torch, :func:`gamma_u8` or :func:`linear_u8` then
the transformed copy.

These kernels and the planar I420 tonemap form (``yuv420.py``) tone in one
of three compiled forms that :func:`tone_form` picks from gamma
(:data:`TONE_FORMS`): no pow at gamma 1; the pow of the Reinhard quotient
taken without a division for 0 < gamma < 7 (and the linear tone's pow);
the pow of the true division otherwise. Each gives its twin's byte
(``csrc/finish.cuh`` ``tone_u8``). While tracing is on, each launch counts
its form (``utils/profiling.py`` ``tone_forms``).

K4 takes a table form where :func:`table_form` says so (bf16 or f16 at
gamma != 1, no axis swap), and no other form there: the same launcher
call tones each of the 65,536 bit patterns of the dtype once an image
into a table of bytes (``tone_table_kernel``, the same ``tone_u8``) and
the rows kernel gives each value its byte from the table; the call counts
as two launches. The
tables live in a scratch kept per (device, stream) and grown only when the
images grow in number (:func:`_tables`). Its plain twin is
:func:`finish_planar_u8_table_plain`; a table launch also counts
``tone_forms["table"]``.

K4's I420 mode takes the same table form under the same rule, and no
other form there: the same tables, each value's byte gathered from them,
then its conversion to Y and VU; its plain twin is
:func:`finish_yuv420_table_plain`, and a table launch counts as K4's does.
P takes the same table form where :func:`planar_table_form` says so (the
same rule, and each image at least :data:`TABLE_BYTES` values), and its
direct form elsewhere; its plain twin is
:func:`finish_planar_tone_table_plain`, and a table launch counts as K4's
does.

Under a transform that swaps the axes K4 runs its axis-swap kernel, a
persistent grid that walks tiles with the next tile's loads in flight
(``csrc/finish.cu`` ``finish_swap_kernel``). While tracing is on each K4
launch also counts the layout of its output, ``rows`` or ``swap``
(``utils/profiling.py`` ``finish_layouts``), and each launch of its I420
mode counts its path, ``rows``, or ``swap`` for the I420 tile kernel
(``i420_paths``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.ops.bayer import (_TRANSFORM_SFF,
                                              planar_from_phases_transformed,
                                              transform_phases)
from taichi_image_tpu_torch.ops.hopper import yuv420
from taichi_image_tpu_torch.ops.hopper.meter import linear_scal
from taichi_image_tpu_torch.ops.interpolate import (ImageTransform,
                                                    transform_axes)
from taichi_image_tpu_torch.utils import profiling

__all__ = ["finish_planar_u8", "finish_planar_u8_plain",
           "finish_planar_u8_table_plain", "finish_yuv420",
           "finish_yuv420_plain", "finish_yuv420_table_plain",
           "finish_planar_tone",
           "finish_planar_tone_plain", "finish_planar_tone_table_plain",
           "gamma_u8", "linear_scal", "linear_u8", "planar_table_form",
           "table_form", "tone_tables_plain"]

MODES = ("reinhard", "linear")

_REPLACES = "taichi_image_tpu/ops/pallas/finish.py:199"
KERNELS = hopper.register_per_dtype(
    "finish", "finish.cu", "tit_finish_planar_u8",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p],
    dict.fromkeys(hopper.DTYPE_SUFFIX, _REPLACES))
YUV420_KERNELS = hopper.register_per_dtype(
    "finish_yuv420", "finish.cu", "tit_finish_yuv420",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    dict.fromkeys(hopper.DTYPE_SUFFIX,
                  "taichi_image_tpu/models/camera_isp.py:1485"))
PLANAR_TONE_KERNELS = hopper.register_per_dtype(
    "finish_planar_tone", "finish.cu", "tit_finish_planar_tone",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p],
    dict.fromkeys(hopper.DTYPE_SUFFIX,
                  "taichi_image_tpu/models/camera_isp.py:1721-1727"))


def _inv_gamma(gamma: float):
  """None for gamma == 1 (the pow is skipped, as in JAX), else
  f32(1.0 / gamma) computed in Python double."""
  gamma = float(gamma)
  if gamma == 1.0:
    return None
  return float(np.float32(1.0 / gamma))


# The tone's forms (csrc/finish.cuh Tone), by the int the launchers take.
TONE_FORMS = ("gamma1", "pow_rcp", "pow_div")

# Below this gamma the pow of the division-free quotient gives the
# division's byte (csrc/finish.cuh tone_u8: exact while 0 < gamma < 7.88).
POW_RCP_MAX_GAMMA = 7.0


def tone_form(gamma: float, mode: str) -> int:
  """The tone form the kernels take at ``gamma`` (an index of
  :data:`TONE_FORMS`): gamma 1 takes no pow; the linear tone's pow has no
  quotient; the Reinhard pow takes the division-free quotient for
  0 < gamma < :data:`POW_RCP_MAX_GAMMA` and the true division otherwise."""
  gamma = float(gamma)
  if gamma == 1.0:
    return 0
  if mode == "linear" or 0.0 < gamma < POW_RCP_MAX_GAMMA:
    return 1
  return 2


@functools.lru_cache(maxsize=64)
def tone_args(gamma: float, mode: str) -> tuple[int, int, float]:
  """The launchers' (linear, tone, inv_gamma) for ``gamma`` and ``mode``;
  cached, as a step asks it every set."""
  inv_gamma = _inv_gamma(gamma)
  return (int(mode == "linear"), tone_form(gamma, mode),
          1.0 if inv_gamma is None else inv_gamma)


def count_tone(tone: int, table: bool = False) -> None:
  """Count one launch of the tone form ``tone``, and of the table form
  where ``table``, while tracing is on."""
  if profiling.ON:
    profiling.count_tone(TONE_FORMS[tone])
    if table:
      profiling.count_tone("table")


# K4's table form (csrc/finish.cu): a byte per bit pattern of a 16-bit
# dtype, an image's table
TABLE_BYTES = 65536


def table_form(dtype: torch.dtype, gamma: float, mode: str,
               transform: ImageTransform) -> bool:
  """Whether K4 (RGB or I420) tones ``dtype`` through a byte table: a
  16-bit dtype, a pow form of the tone (gamma != 1) and no axis swap."""
  return (dtype in (torch.bfloat16, torch.float16)
          and tone_form(gamma, mode) != 0
          and not _TRANSFORM_SFF[transform][0])


def planar_table_form(dtype: torch.dtype, gamma: float, mode: str,
                      transform: ImageTransform, h: int, w: int) -> bool:
  """Whether P tones ``dtype`` through a byte table: where
  :func:`table_form` holds and each (3, h, w) image holds at least
  :data:`TABLE_BYTES` values, so that its table tones no more patterns than
  the direct form would tone values."""
  return (table_form(dtype, gamma, mode, transform)
          and 3 * h * w >= TABLE_BYTES)


# {(device, stream): the table scratch}: launches on one stream run in
# order, so one scratch serves them all; it is replaced by a larger one
# only when the images grow in number
_TABLES: dict = {}


def _tables(device: torch.device, n: int) -> torch.Tensor:
  """The table scratch of ``device``'s current stream, for ``n`` images."""
  key = (device, hopper.stream_of(device))
  buf = _TABLES.get(key)
  if buf is None or buf.numel() < n * TABLE_BYTES:
    buf = _TABLES[key] = torch.empty(n * TABLE_BYTES, dtype=torch.uint8,
                                     device=device)
  return buf


def gamma_u8(p: torch.Tensor, max_out: torch.Tensor,
             gamma: float) -> torch.Tensor:
  """The gamma stage on any layout: (N, ...) working-dtype ``p`` and the
  per-image f32 max (N, 1, ...) -> u8 of ``p``'s shape:
  trunc(clip(255 * (p / max(1e-6, max_out))^(1/gamma), 0, 255)), a NaN
  (log2 of a negative p) giving 0."""
  mx = torch.clamp_min(max_out.to(torch.float32), 1e-6)
  o = p.to(torch.float32) / mx.reshape(-1, *([1] * (p.ndim - 1)))
  inv_gamma = _inv_gamma(gamma)
  if inv_gamma is not None:
    o = torch.exp2(torch.log2(o) * inv_gamma)
  v = torch.nan_to_num(torch.clamp(255.0 * o, 0.0, 255.0), nan=0.0)
  return v.to(torch.uint8)


def linear_u8(x: torch.Tensor, lin: torch.Tensor,
              gamma: float) -> torch.Tensor:
  """The linear tonemap on any layout: u8 of ``x``'s shape,
  trunc(clip(clip(y, 0, 1) * 255, 0, 255)) with
  y = max((x - m0) * inv_range, 0)^(1/gamma) and ``lin`` =
  :func:`linear_scal`; a NaN gives 0."""
  y = torch.clamp_min((x.to(torch.float32) - lin[0]) * lin[1], 0.0)
  inv_gamma = _inv_gamma(gamma)
  if inv_gamma is not None:
    y = torch.exp2(torch.log2(y) * inv_gamma)
  v = torch.clamp(torch.clamp(y, 0.0, 1.0) * 255.0, 0.0, 255.0)
  return torch.nan_to_num(v, nan=0.0).to(torch.uint8)


def _tone_u8(x12, scal, gamma, mode):
  return (gamma_u8(x12, scal, gamma) if mode == "reinhard"
          else linear_u8(x12, scal, gamma))


def finish_planar_u8_plain(x12: torch.Tensor, scal: torch.Tensor,
                           gamma: float, mode: str = "reinhard",
                           transform: ImageTransform = ImageTransform.none
                           ) -> torch.Tensor:
  """Plain PyTorch twin of K4: the mode's u8 in phase layout, then
  :func:`planar_from_phases_transformed`."""
  return planar_from_phases_transformed(_tone_u8(x12, scal, gamma, mode),
                                        transform)


def tone_tables_plain(dtype: torch.dtype, scal: torch.Tensor, gamma: float,
                      mode: str, n: int) -> torch.Tensor:
  """Plain twin of K4's tables: (n, 65536) u8 whose [b, u] is image b's
  tone (:func:`gamma_u8` under its max, or :func:`linear_u8`) of the
  ``dtype`` value with bits u."""
  u = torch.arange(TABLE_BYTES, dtype=torch.int32, device=scal.device)
  bits = (u - (u >= 0x8000) * 0x10000).to(torch.int16).view(dtype)
  return _tone_u8(bits.expand(n, TABLE_BYTES), scal, gamma, mode)


def _table_u8(x: torch.Tensor, scal: torch.Tensor, gamma: float,
              mode: str) -> torch.Tensor:
  """u8 of the bf16 or f16 ``x`` (N, ...) through the tables: each
  image's table (:func:`tone_tables_plain`), each value's byte gathered
  from it at its 16 bits."""
  n = x.shape[0]
  tables = tone_tables_plain(x.dtype, scal, gamma, mode, n)
  bits = x.contiguous().view(torch.int16).reshape(n, -1).to(torch.int64)
  return torch.gather(tables, 1, bits & 0xFFFF).reshape(x.shape)


def finish_planar_u8_table_plain(x12: torch.Tensor, scal: torch.Tensor,
                                 gamma: float, mode: str = "reinhard",
                                 transform: ImageTransform =
                                 ImageTransform.none) -> torch.Tensor:
  """Plain twin of K4's table form (bf16 or f16 ``x12``): each value's
  byte from its image's table, then
  :func:`planar_from_phases_transformed`."""
  return planar_from_phases_transformed(_table_u8(x12, scal, gamma, mode),
                                        transform)


def finish_yuv420_plain(x12: torch.Tensor, scal: torch.Tensor, gamma: float,
                        mode: str = "reinhard",
                        transform: ImageTransform = ImageTransform.none):
  """Plain PyTorch twin of K4's I420 mode: the mode's u8 in phase layout,
  the phase transform, then ``yuv420_from_phases_u8`` (the bf16 dot for a
  bf16 input, the f32 chains otherwise)."""
  u8 = transform_phases(_tone_u8(x12, scal, gamma, mode), transform)
  return yuv420.yuv420_from_phases_u8(u8, mxu=x12.dtype == torch.bfloat16)


def finish_yuv420_table_plain(x12: torch.Tensor, scal: torch.Tensor,
                              gamma: float, mode: str = "reinhard",
                              transform: ImageTransform = ImageTransform.none):
  """Plain twin of the table form of K4's I420 mode (bf16 or f16
  ``x12``): each value's byte from its image's table, the phase transform,
  then ``yuv420_from_phases_u8`` as :func:`finish_yuv420_plain` takes
  it."""
  u8 = transform_phases(_table_u8(x12, scal, gamma, mode), transform)
  return yuv420.yuv420_from_phases_u8(u8, mxu=x12.dtype == torch.bfloat16)


def _check_finish(x12: torch.Tensor, scal: torch.Tensor, mode: str,
                  channels: int = 12) -> None:
  """The finish's guards on both routes: ``x12``'s layout (12 phase
  channels, or 3 planar ones), the mode, the dtype and ``scal``'s
  shape."""
  if x12.ndim != 4 or x12.shape[1] != channels:
    layout = "(N, 12, hh, wh)" if channels == 12 else "(N, 3, h, w)"
    raise ValueError(f"finish input must be {layout}, got "
                     f"{tuple(x12.shape)}")
  if mode not in MODES:
    raise ValueError(f"unknown finish mode {mode!r}; expected one of {MODES}")
  hopper.check_dtype("the finish's input", x12.dtype)
  n = x12.shape[0]
  if mode == "reinhard" and scal.numel() != n:
    raise ValueError(f"max_out must hold one value per image ({n}), got "
                     f"shape {tuple(scal.shape)}")
  if mode == "linear" and scal.shape != (2,):
    raise ValueError(f"the linear finish takes [m0, inv_range] (2,), got "
                     f"shape {tuple(scal.shape)}")


def _check_launch(x12: torch.Tensor, scal: torch.Tensor) -> None:
  hopper.check_tensor("x12", x12, x12.dtype, 4, x12.device)
  hopper.check_tensor("scal", scal, torch.float32, scal.ndim, x12.device)
  hopper.check_frame_size(*x12.shape[2:])


def finish_planar_u8(x12: torch.Tensor, scal: torch.Tensor, gamma: float,
                     mode: str = "reinhard",
                     transform: ImageTransform = ImageTransform.none,
                     backend: str = "auto") -> torch.Tensor:
  """(N, 12, hh, wh) input (bf16, f16 or f32) -> transformed planar u8
  (N, 3, h', w'); bitwise equal to the plain twin.

  ``mode="reinhard"``: the input is the pre-gamma p and ``scal`` its
  per-image f32 max (N, 1, 1, 1). ``mode="linear"``: the input is x12 and
  ``scal`` is :func:`linear_scal` of the metrics. Where :func:`table_form`
  holds, the launch tones through each image's byte table."""
  _check_finish(x12, scal, mode)
  if not hopper.use_kernel(backend, x12):
    return finish_planar_u8_plain(x12, scal, gamma, mode, transform)
  _check_launch(x12, scal)
  n, _, hh, wh = x12.shape
  swap, fy, fx = _TRANSFORM_SFF[transform]
  shape = (n, 3, 2 * wh, 2 * hh) if swap else (n, 3, 2 * hh, 2 * wh)
  out = torch.empty(shape, dtype=torch.uint8, device=x12.device)
  linear, tone, inv_gamma = tone_args(gamma, mode)
  table = table_form(x12.dtype, gamma, mode, transform)
  KERNELS[x12.dtype].launch(x12.device, hopper.ptr(x12), hopper.ptr(scal),
                            hopper.ptr(out), n, hh, wh, linear, tone,
                            inv_gamma, int(swap), int(fy), int(fx),
                            hopper.ptr(_tables(x12.device, n)) if table
                            else None, kernels=2 if table else 1)
  count_tone(tone, table)
  if profiling.ON:
    profiling.count_finish_layout("swap" if swap else "rows")
  return out


def finish_yuv420(x12: torch.Tensor, scal: torch.Tensor, gamma: float,
                  mode: str = "reinhard",
                  transform: ImageTransform = ImageTransform.none,
                  backend: str = "auto"):
  """K4's I420 mode: the input and ``scal`` as :func:`finish_planar_u8`
  takes them -> planar I420 u8 ``(Y (N, h', w'), VU (N, 2, h'/2, w'/2))``
  of the transformed image, V then U; bitwise equal to the plain twin.
  A bf16 input takes the bf16 pipeline's dot formulation, f16 and f32
  the f32 chains (as JAX picks them by the working dtype). Where
  :func:`table_form` holds, the launch tones through each image's byte
  table."""
  _check_finish(x12, scal, mode)
  if not hopper.use_kernel(backend, x12):
    return finish_yuv420_plain(x12, scal, gamma, mode, transform)
  _check_launch(x12, scal)
  n, _, hh, wh = x12.shape
  swap, fy, fx = _TRANSFORM_SFF[transform]
  bh, bw = (wh, hh) if swap else (hh, wh)  # the output's 2x2 blocks
  dev = x12.device
  y = torch.empty((n, 2 * bh, 2 * bw), dtype=torch.uint8, device=dev)
  vu = torch.empty((n, 2, bh, bw), dtype=torch.uint8, device=dev)
  linear, tone, inv_gamma = tone_args(gamma, mode)
  table = table_form(x12.dtype, gamma, mode, transform)
  YUV420_KERNELS[x12.dtype].launch(
      dev, hopper.ptr(x12), hopper.ptr(scal), hopper.ptr(y), hopper.ptr(vu),
      n, hh, wh, linear, tone, inv_gamma, int(swap), int(fy), int(fx),
      yuv420.coefficients_ptr(x12.dtype == torch.bfloat16),
      hopper.ptr(yuv420.inv255_table(dev)),
      hopper.ptr(_tables(dev, n)) if table else None,
      kernels=2 if table else 1)
  count_tone(tone, table)
  if profiling.ON:
    profiling.count_i420_path("swap" if swap else "rows")
  return y, vu


def finish_planar_tone_plain(x: torch.Tensor, scal: torch.Tensor,
                             gamma: float, mode: str = "reinhard",
                             transform: ImageTransform = ImageTransform.none
                             ) -> torch.Tensor:
  """Plain PyTorch twin of P: the mode's u8 of the planar ``x``, then the
  transform as a contiguous copy."""
  return transform_axes(_tone_u8(x, scal, gamma, mode), transform, 2,
                        3).contiguous()


def finish_planar_tone_table_plain(x: torch.Tensor, scal: torch.Tensor,
                                   gamma: float, mode: str = "reinhard",
                                   transform: ImageTransform =
                                   ImageTransform.none) -> torch.Tensor:
  """Plain twin of P's table form (bf16 or f16 planar ``x``): each value's
  byte from its image's table, then the transform as a contiguous copy."""
  return transform_axes(_table_u8(x, scal, gamma, mode), transform, 2,
                        3).contiguous()


def finish_planar_tone(x: torch.Tensor, scal: torch.Tensor, gamma: float,
                       mode: str = "reinhard",
                       transform: ImageTransform = ImageTransform.none,
                       backend: str = "auto") -> torch.Tensor:
  """P: untransformed planar (N, 3, h, w) of the working dtype (bf16, f16
  or f32) -> planar u8 (N, 3, h', w') of the transformed image; bitwise
  equal to the plain twin.

  ``mode="reinhard"``: ``x`` is K3's p and ``scal`` its per-image f32 max
  (N, 1, 1, 1). ``mode="linear"``: ``x`` is the image and ``scal`` the
  linear vector [m0, inv_range]. Where :func:`planar_table_form` holds,
  the launch tones through each image's byte table."""
  _check_finish(x, scal, mode, channels=3)
  if not hopper.use_kernel(backend, x):
    return finish_planar_tone_plain(x, scal, gamma, mode, transform)
  hopper.check_tensor("x", x, x.dtype, 4, x.device)
  hopper.check_tensor("scal", scal, torch.float32, scal.ndim, x.device)
  n, _, h, w = x.shape
  hopper.check_int32_extent(f"a {h}x{w} planar image", 3 * h * w)
  swap, fy, fx = _TRANSFORM_SFF[transform]
  out = torch.empty((n, 3, w, h) if swap else (n, 3, h, w),
                    dtype=torch.uint8, device=x.device)
  linear, tone, inv_gamma = tone_args(gamma, mode)
  table = planar_table_form(x.dtype, gamma, mode, transform, h, w)
  PLANAR_TONE_KERNELS[x.dtype].launch(
      x.device, hopper.ptr(x), hopper.ptr(scal), hopper.ptr(out), n, h, w,
      linear, tone, inv_gamma, int(swap), int(fy), int(fx),
      hopper.ptr(_tables(x.device, n)) if table else None,
      kernels=2 if table else 1)
  count_tone(tone, table)
  return out
