"""K12: bilinear resize from 12-channel phase form to planar RGB
(``csrc/resize.cu``, one instantiation per working dtype).

Replaces ``taichi_image_tpu/ops/pallas/resize.py::resize_x12_bf16`` (bf16)
and, for f16 and f32, the XLA gather route that the JAX package keeps for
them (``models/camera_isp.py::_resize_from_phases``). The TPU kernel
approximates that route with bf16 weight matrices on the MXU; this one
computes it exactly, in f32 with one rounding to the working dtype, and
is bitwise equal to its plain twin :func:`resize_x12_plain`.

The taps come from ``ops/interpolate._axis_samples`` and are copied to
the device once per (shape, scale, device) by :func:`resize_taps`, so a
step makes no host-to-device copy after its first. :func:`plan` picks
the kernel's path: a resize that halves both axes exactly (the resize to
1920 from 3840) has the half-res grid for taps (``ResizeTaps.aligned``)
and takes the aligned path where its rows are whole 16-byte runs; any
other takes the direct one; each launch counts its path in the tracer's
``resize_paths`` while tracing is on. A block's tile is ``TILE_H`` output
rows by :func:`tile_w` columns, which the kernel is built with (``-D``
flags).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.ops.interpolate import _axis_samples
from taichi_image_tpu_torch.utils import profiling

__all__ = ["ResizeTaps", "band_taps", "plan", "resize_taps", "resize_x12",
           "resize_x12_plain", "tile_w"]

# csrc/resize.cu's tile: TILE_H output rows by RUNS_X runs of
# 16 // itemsize columns (one 16-byte store per color and row)
RUNS_X = 32
TILE_H = 16

_XLA_ROUTE = "taichi_image_tpu/models/camera_isp.py:1315"
KERNELS = hopper.register_per_dtype(
    "resize", "resize.cu", "tit_resize_x12",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    {torch.bfloat16: "taichi_image_tpu/ops/pallas/resize.py:205",
     torch.float16: _XLA_ROUTE, torch.float32: _XLA_ROUTE},
    defines={"TIT_RESIZE_RUNS_X": RUNS_X, "TIT_RESIZE_TILE_H": TILE_H})


def tile_w(itemsize: int) -> int:
  """Output columns of a K12 tile for a working dtype of ``itemsize``
  bytes."""
  return RUNS_X * (16 // itemsize)


def _on_half_grid(lo: np.ndarray, hi: np.ndarray, n_half: int) -> bool:
  """Whether output i's taps along an axis are full-res 2i and 2i + 1 for
  every i of n_half outputs: half-res position i, both parities."""
  i = np.arange(n_half)
  return (len(lo) == n_half and np.array_equal(lo, 2 * i)
          and np.array_equal(hi, 2 * i + 1))


class ResizeTaps(NamedTuple):
  """Device tables of one resize: full-res tap rows/cols (int32, for the
  kernel), their positions in the twin's merged parity axes (int64) and
  the fractions (f32), for input phase planes hh x wh; and whether the
  taps are the half-res grid itself."""
  hh: int
  wh: int
  h_out: int
  w_out: int
  aligned: bool
  r_lo: torch.Tensor
  r_hi: torch.Tensor
  r_f: torch.Tensor
  c_lo: torch.Tensor
  c_hi: torch.Tensor
  c_f: torch.Tensor
  ri_lo: torch.Tensor
  ri_hi: torch.Tensor
  ci_lo: torch.Tensor
  ci_hi: torch.Tensor


@functools.lru_cache(maxsize=32)
def resize_taps(hh: int, wh: int, size, scale_yx, device) -> ResizeTaps:
  """The taps of resizing (2hh, 2wh) to ``size`` = (w_out, h_out) with
  per-axis ``scale_yx`` = (sy, sx), on ``device``; cached."""
  w_out, h_out = size
  sy, sx = scale_yx
  return _device_taps(hh, wh, _axis_samples(h_out, 2 * hh, sy),
                      _axis_samples(w_out, 2 * wh, sx), device)


@functools.lru_cache(maxsize=64)
def band_taps(hh: int, wh: int, size, scale_yx, out_rows, in_rows,
              device) -> ResizeTaps:
  """The taps of output rows ``out_rows`` = (o0, o1) of
  ``resize_taps(hh, wh, size, scale_yx)`` for an x12 band that holds only
  the half-res rows ``in_rows`` = (p0, p1) of the frame: the same
  positions and fractions, the rows counted from the band's first
  (a row band of the large-frame loop, models/large.py); cached."""
  w_out, h_out = size
  sy, sx = scale_yx
  (o0, o1), (p0, p1) = out_rows, in_rows
  r_lo, r_hi, r_f = _axis_samples(h_out, 2 * hh, sy)
  r_lo, r_hi = r_lo[o0:o1] - 2 * p0, r_hi[o0:o1] - 2 * p0
  if o1 > o0 and (r_lo.min() < 0 or r_hi.max() >= 2 * (p1 - p0)):
    raise ValueError(f"output rows {out_rows} tap input rows outside the "
                     f"band's half-res rows {in_rows}")
  return _device_taps(p1 - p0, wh, (r_lo, r_hi, r_f[o0:o1]),
                      _axis_samples(w_out, 2 * wh, sx), device)


def _device_taps(hh: int, wh: int, rows, cols, device) -> ResizeTaps:
  """:class:`ResizeTaps` on ``device`` from the (lo, hi, frac) full-res
  samples of the rows and the columns, for phase planes hh x wh."""
  r_lo, r_hi, r_f = rows
  c_lo, c_hi, c_f = cols
  h_out, w_out = len(r_lo), len(c_lo)

  def dev(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

  return ResizeTaps(
      hh, wh, h_out, w_out,
      _on_half_grid(r_lo, r_hi, hh) and _on_half_grid(c_lo, c_hi, wh),
      dev(r_lo, np.int32), dev(r_hi, np.int32),
      dev(r_f, np.float32), dev(c_lo, np.int32), dev(c_hi, np.int32),
      dev(c_f, np.float32),
      dev((r_lo % 2) * hh + r_lo // 2, np.int64),
      dev((r_hi % 2) * hh + r_hi // 2, np.int64),
      dev((c_lo % 2) * wh + c_lo // 2, np.int64),
      dev((c_hi % 2) * wh + c_hi // 2, np.int64))


def plan(x12: torch.Tensor, taps: ResizeTaps) -> str:
  """K12's path for resizing ``x12`` with ``taps``: "aligned" where the
  taps are the half-res grid and x12's rows (and so the output's) are
  whole 16-byte runs from an aligned start, else "direct"."""
  run = 16 // x12.element_size()
  if taps.aligned and taps.wh % run == 0 and x12.data_ptr() % 16 == 0:
    return "aligned"
  return "direct"


def resize_x12_plain(x12: torch.Tensor, taps: ResizeTaps,
                     dtype=None) -> torch.Tensor:
  """Plain PyTorch twin of K12, the JAX package's ``_resize_from_phases``:
  a channel permutation to (c, cp, rp) merges (rp, hh) for the row taps,
  a swap merges (cp, wh) for the column taps; f32 lerps, one cast (to
  ``dtype``, by default x12's)."""
  n, _, hh, wh = x12.shape
  perm = [(cp * 2 + rp) * 3 + c
          for c in range(3) for cp in range(2) for rp in range(2)]
  z = x12[:, perm].reshape(n, 3, 2, 2 * hh, wh)
  top = z.index_select(3, taps.ri_lo).to(torch.float32)
  bot = z.index_select(3, taps.ri_hi).to(torch.float32)
  rows = top + taps.r_f[None, None, None, :, None] * (bot - top)
  rows = rows.transpose(2, 3).reshape(n, 3, taps.h_out, 2 * wh)
  left = rows.index_select(3, taps.ci_lo)
  right = rows.index_select(3, taps.ci_hi)
  out = left + taps.c_f[None, None, None, :] * (right - left)
  return out.to(dtype or x12.dtype)


def resize_x12(x12: torch.Tensor, taps: ResizeTaps,
               backend: str = "auto") -> torch.Tensor:
  """(N, 12, hh, wh) x12 of the working dtype (bf16, f16 or f32) ->
  planar (N, 3, h_out, w_out) of that dtype; bitwise equal to the plain
  twin."""
  if x12.ndim != 4 or x12.shape[1] != 12:
    raise ValueError(f"resize input must be (N, 12, hh, wh), got "
                     f"{tuple(x12.shape)}")
  hopper.check_dtype("the resize's input", x12.dtype)
  if (taps.hh, taps.wh) != tuple(x12.shape[2:]):
    raise ValueError(f"taps are for {taps.hh}x{taps.wh} phase planes, x12 "
                     f"is {tuple(x12.shape)}")
  if taps.r_lo.device != x12.device:
    raise ValueError(f"taps are on {taps.r_lo.device}, x12 on {x12.device}")
  if not hopper.use_kernel(backend, x12):
    return resize_x12_plain(x12, taps)
  hopper.check_tensor("x12", x12, x12.dtype, 4, x12.device)
  hopper.check_frame_size(taps.hh, taps.wh)
  hopper.check_int32_extent("the resize's output", 3 * taps.h_out * taps.w_out)
  return _launch(x12, taps, plan(x12, taps))


def _launch(x12: torch.Tensor, taps: ResizeTaps, path: str) -> torch.Tensor:
  """Launch K12 on ``path`` ("aligned" only where :func:`plan` allows
  it, "direct" on any resize)."""
  n, _, hh, wh = x12.shape
  out = torch.empty((n, 3, taps.h_out, taps.w_out), dtype=x12.dtype,
                    device=x12.device)
  KERNELS[x12.dtype].launch(
      x12.device, hopper.ptr(x12), hopper.ptr(out), n, hh, wh, taps.h_out,
      taps.w_out,
      hopper.ptr(taps.r_lo), hopper.ptr(taps.r_hi), hopper.ptr(taps.r_f),
      hopper.ptr(taps.c_lo), hopper.ptr(taps.c_hi), hopper.ptr(taps.c_f),
      int(path == "aligned"))
  if profiling.ON:
    profiling.count_resize_path(path)
  return out
