"""Bayer demosaic on phase planes (counterpart of
``taichi_image_tpu/ops/bayer.py``).

The CFA is split into its four half-resolution phase planes; every tap
of the full-resolution 13-tap diamond stencils then lands on one phase
plane at an offset in {-1, 0, 1}, so the demosaic is a 3x3 stencil from
4 input channels (phases) to 12 output channels (4 output phases x RGB).
Border renormalization is exact: the dropped (zero-padded) taps of the
four border strips are renormalized by precomputed strip factors plus
four corner corrections.

The tables here are built in numpy and equal the JAX package's values
exactly; ``demosaic_phases`` runs the K2 stencil (``ops/hopper/demosaic``)
with the finish (renorm, optional CCM, clip, cast) fused in, and
``demosaic_samples`` evaluates the same arithmetic on the metering grid
only (the metering pre-pass that K7, the front-fused kernel, needs).
Frames under 4x4 pixels (a phase plane one row or one column wide) take
the JAX package's own route for them, the dropped taps' weights divided
out per pixel (``_demosaic_denominator``), in torch on either device.

The HWC API of the reference (``bayer_to_rgb``, ``bayer_to_rgb_batch``,
``rgb_to_bayer``) runs on the same core, on the card by default (a host
array is moved to ``device``, a tensor taken on its own device), so
``bayer_to_rgb`` launches K2.
"""

from __future__ import annotations

import enum
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.ops.interpolate import (ImageTransform,
                                                    transform_axes)
from taichi_image_tpu_torch.ops.kernel import symmetrical, zip_tuple

__all__ = [
    "BayerPattern", "pixel_orders", "kernel_patterns", "diamond_kernel",
    "make_bayer_kernels", "make_bilinear_kernels", "scale_kernel",
    "cfa_phases", "demosaic_phases", "demosaic_samples",
    "edge_renorm_factor", "edge_renorm_factor_sampled", "phases_to_plane",
    "phases_to_planar", "phases_to_planar_stack", "planar_to_phases",
    "planar_from_phases_transformed", "planar_subsample", "subsample_hw",
    "transform_phases", "bayer_to_rgb", "bayer_to_rgb_batch",
    "rgb_to_bayer",
]


def diamond_kernel(weights):
  """13 diamond-shaped (offset, weight) taps over a 5x5 support.
  Offsets are (row, col)."""
  diamond = [(0, 1), (-1, 2), (-2, 3), (-1, 2), (0, 1)]
  offsets = [(i - 2, x) for i, r in enumerate(diamond) for x in range(*r)]
  if len(offsets) != len(weights):
    raise ValueError(f"incorrect weight length {len(offsets)} != "
                     f"{len(weights)}")
  return tuple(zip(offsets, weights))


def make_bayer_kernels():
  """Four per-phase vec3 Malvar-He-Cutler weight tables, integer weights
  summing to 16 per channel."""
  g_rb, r_g1, r_g2, rb_br, ident = [
      symmetrical(w) for w in [
          [(-2,), (0, 4), (-2, 4, 8)],   # G at R,B locations
          [(-2,), (-2, 8), (1, 0, 10)],  # R at G1 and B at G2
          [(1,), (-2, 0), (-2, 8, 10)],  # B at G1 and R at G2
          [(-3,), (4, 0), (-3, 0, 12)],  # R at B and B at R
          [(0,), (0, 0), (0, 0, 16)],    # Identity
      ]
  ]
  b_g1 = r_g2
  b_g2 = r_g1
  vec_weights = [
      zip_tuple(ident, g_rb, rb_br),  # R phase
      zip_tuple(r_g1, ident, b_g1),   # G1 phase
      zip_tuple(r_g2, ident, b_g2),   # G2 phase
      zip_tuple(rb_br, g_rb, ident),  # B phase
  ]
  return tuple(diamond_kernel(w) for w in vec_weights)


def make_bilinear_kernels():
  """Four per-phase vec3 bilinear weight tables on the same support."""
  ident = symmetrical([(0,), (0, 0), (0, 0, 4)])
  cross = symmetrical([(0,), (0, 1), (0, 1, 0)])
  vert = symmetrical([(0,), (0, 2), (0, 0, 0)])
  horiz = symmetrical([(0,), (0, 0), (0, 2, 0)])
  diag = symmetrical([(0,), (1, 0), (0, 0, 0)])
  vec_weights = [
      zip_tuple(ident, cross, diag),
      zip_tuple(vert, ident, horiz),
      zip_tuple(horiz, ident, vert),
      zip_tuple(diag, cross, ident),
  ]
  return tuple(diamond_kernel(w) for w in vec_weights)


def scale_kernel(kernel, scale):
  """Scale a kernel's vec3 weights, keeping its offsets."""
  return tuple(
      (offset, tuple(w * s for w, s in zip(weight, scale)))
      for offset, weight in kernel)


bayer_kernels = make_bayer_kernels()
bilinear_kernels = make_bilinear_kernels()


class BayerPattern(enum.Enum):
  """CFA layout of the top-left 2x2 quad."""
  RGGB = 0
  GRBG = 1
  GBRG = 2
  BGGR = 3

  @property
  def pixel_order(self):
    return pixel_orders[self]


# pattern -> RGB channel sampled at (even,even), (even,odd), (odd,even),
# (odd,odd) of (row, col)
pixel_orders = {
    BayerPattern.RGGB: (0, 1, 1, 2),
    BayerPattern.GRBG: (1, 0, 2, 1),
    BayerPattern.GBRG: (1, 2, 0, 1),
    BayerPattern.BGGR: (2, 1, 1, 0),
}

# pattern -> permutation of the 4 phase kernels, in the order
# (even,even), (odd,even), (even,odd), (odd,odd) of (row, col)
kernel_patterns = {
    BayerPattern.RGGB: (0, 1, 2, 3),
    BayerPattern.GBRG: (1, 0, 3, 2),
    BayerPattern.GRBG: (2, 3, 0, 1),
    BayerPattern.BGGR: (3, 2, 1, 0),
}

# Output phase p of the 12-channel layout -> (row parity, col parity).
# Input phases use the other, row-major order: q = (row%2)*2 + col%2.
_PHASE_PARITY = ((0, 0), (1, 0), (0, 1), (1, 1))


def _phase_conv_weights(kernels) -> np.ndarray:
  """Four full-res 13-tap vec3 kernels -> dense (12, 4, 3, 3) phase-plane
  stencil weights. Out channel = out_phase * 3 + rgb (``_PHASE_PARITY``
  order); in channel = row-major input phase."""
  w = np.zeros((12, 4, 3, 3), np.float32)
  for p, (dy, dx) in enumerate(_PHASE_PARITY):
    for (oy, ox), weight in kernels[p]:
      sy, sx = dy + oy, dx + ox
      in_phase = (sy % 2) * 2 + (sx % 2)
      u, v = sy // 2, sx // 2  # floor division: in {-1, 0, 1}
      for c in range(3):
        w[p * 3 + c, in_phase, u + 1, v + 1] += weight[c]
  return w


def _edge_sums(w: np.ndarray, hh: int, wh: int):
  """Per-channel surviving-weight sums of the four border strips:
  (interior (12,), top (12, wh), bottom (12, wh), left (12, hh),
  right (12, hh)) float32. Assumes hh >= 2 and wh >= 2."""
  ws = w.sum(axis=1)  # (12, 3, 3)

  def rsum(rows, cols):
    return ws[:, rows, :][:, :, cols].sum(axis=(1, 2))

  full = rsum([0, 1, 2], [0, 1, 2])
  t_mid = rsum([1, 2], [0, 1, 2])
  b_mid = rsum([0, 1], [0, 1, 2])
  l_mid = rsum([0, 1, 2], [1, 2])
  r_mid = rsum([0, 1, 2], [0, 1])
  tl = rsum([1, 2], [1, 2])
  tr = rsum([1, 2], [0, 1])
  bl = rsum([0, 1], [1, 2])
  br = rsum([0, 1], [0, 1])

  top = np.tile(t_mid[:, None], (1, wh))
  top[:, 0], top[:, -1] = tl, tr
  bottom = np.tile(b_mid[:, None], (1, wh))
  bottom[:, 0], bottom[:, -1] = bl, br
  left = np.tile(l_mid[:, None], (1, hh))
  left[:, 0], left[:, -1] = tl, bl
  right = np.tile(r_mid[:, None], (1, hh))
  right[:, 0], right[:, -1] = tr, br
  return full, top, bottom, left, right


@functools.cache
def _demosaic_tables(pattern: BayerPattern, method: str) -> np.ndarray:
  base = bayer_kernels if method == "mhc" else bilinear_kernels
  kernels = tuple(base[i] for i in kernel_patterns[pattern])
  return _phase_conv_weights(kernels)


def _stencil_finish_spec(weights, hh, wh, cc, out_dtype, top_row=0,
                         bot_row=None):
  """Constants of the stencil's fused finish: per-channel border factors
  (full/strip sums), corner corrections and the optional CCM, as numpy
  float32 — the same values as the JAX package's spec."""
  if bot_row is None:
    bot_row = hh - 1
  full, top, bottom, left, right = _edge_sums(weights, hh, wh)
  t_mid, b_mid = top[:, 1], bottom[:, 1]
  l_mid, r_mid = left[:, 1], right[:, 1]
  tl, tr_ = top[:, 0], top[:, -1]
  bl, br = bottom[:, 0], bottom[:, -1]
  topf, botf = full / t_mid, full / b_mid
  leftf, rightf = full / l_mid, full / r_mid
  cvals = np.stack([
      (full / tl) / (topf * leftf),
      (full / tr_) / (topf * rightf),
      (full / bl) / (botf * leftf),
      (full / br) / (botf * rightf),
  ]).astype(np.float32)
  ccm = None if cc is None else np.array(cc, np.float32).reshape(3, 3)
  return dict(hh=hh, wh=wh, top_row=int(top_row), bot_row=int(bot_row),
              topf=topf.astype(np.float32),
              botf=botf.astype(np.float32),
              leftf=leftf.astype(np.float32),
              rightf=rightf.astype(np.float32), cvals=cvals, cc=ccm,
              out_dtype=types.canonical_dtype(out_dtype))


@functools.lru_cache(maxsize=64)
def _finish_spec_for(pattern, method, hh, wh, cc, out_dtype, top_row=0,
                     bot_row=None):
  """:func:`_stencil_finish_spec` per configuration, frame size and edge
  rows, built once instead of on every step (the strip sums are host
  work the step would otherwise pay each frame). Shared between calls:
  never mutated."""
  return _stencil_finish_spec(_demosaic_tables(pattern, method), hh, wh, cc,
                              out_dtype, top_row, bot_row)


def demosaic_phases(phases: torch.Tensor, pattern: BayerPattern, cc=None,
                    method: str = "mhc", out_dtype=torch.float32,
                    backend: str = "auto", sample_step: int = 0):
  """Demosaic normalized phase planes (N, 4, hh, wh) -> clamped
  (N, 12, hh, wh) phase-RGB in [0, 1] of ``out_dtype``.

  The 12-channel layout is out_phase * 3 + rgb with output phases in
  (0,0), (1,0), (0,1), (1,1) (row, col) parity order. ``cc`` is an
  optional row-major 3x3 CCM (9 floats). ``sample_step`` > 0 also returns
  ``out[:, 0:3, ::step, ::step]`` (the metering sample grid) as
  ``(out, sample)``, emitted by the stencil itself.

  ``backend``: ``"auto"`` runs the K2 kernel on CUDA tensors and its
  plain twin on CPU tensors; ``"kernel"``/``"plain"`` force a route.
  """
  from taichi_image_tpu_torch.ops.hopper import demosaic as hopper_dm
  if method not in ("mhc", "bilinear"):
    raise ValueError(f"unknown demosaic method {method!r}")
  _, _, hh, wh = phases.shape
  weights = _demosaic_tables(pattern, method)
  if hh < 2 or wh < 2:
    # the JAX package's route for frames under 4x4 (its own routing, on
    # either backend): no border strips to renormalise, so the surviving
    # taps' weights are divided out per pixel
    if backend not in hopper.BACKENDS:
      raise ValueError(f"unknown backend {backend!r}")
    out = _demosaic_denominator(phases, weights, cc,
                                types.canonical_dtype(out_dtype))
    if not sample_step:
      return out
    return out, out[:, 0:3, ::sample_step, ::sample_step]
  fin = _finish_spec_for(pattern, method, hh, wh,
                         None if cc is None else tuple(cc),
                         types.canonical_dtype(out_dtype))
  out, samp = hopper_dm.demosaic_stencil(phases, weights, fin, sample_step,
                                         backend=backend)
  if not sample_step:
    return out
  return out, samp


def _shifted_sums(xp: torch.Tensor, weights: np.ndarray, oc: int, hh: int,
                  wh: int, step: int = 1) -> torch.Tensor:
  """Channel ``oc``'s weighted taps over the zero-padded f32 phase planes
  ``xp`` (N, 4, hh + 2, wh + 2), each tap a multiply and the taps added
  in (q, u, v) order (K2's order), at every ``step``-th pixel."""
  a = None
  for q in range(4):
    for u in range(3):
      for v in range(3):
        w = float(weights[oc, q, u, v])
        if w == 0.0:
          continue
        t = xp[:, q, u:u + hh:step, v:v + wh:step] * w
        a = t if a is None else a + t
  return a


def _demosaic_denominator(phases: torch.Tensor, weights: np.ndarray, cc,
                          out_dtype: torch.dtype) -> torch.Tensor:
  """The demosaic of frames under 4x4 pixels: per channel the weighted
  sum of the in-frame taps over the sum of their weights (the JAX
  package's num / denom, ``ops/bayer.py:472-482``), then the optional CCM
  as v0*c0 + v1*c1 + v2*c2, the clip and one cast. Explicit shifted sums
  in f32, not a convolution, whose summation order (and, in cuDNN, TF32)
  would be the library's."""
  n, _, hh, wh = phases.shape
  xp = F.pad(phases.to(torch.float32), (1, 1, 1, 1))
  ones = F.pad(torch.ones((1, 4, hh, wh), dtype=torch.float32,
                          device=phases.device), (1, 1, 1, 1))
  vals = [_shifted_sums(xp, weights, oc, hh, wh)
          / _shifted_sums(ones, weights, oc, hh, wh) for oc in range(12)]
  if cc is not None:
    ccm = np.array(cc, np.float32).reshape(3, 3)
    vals = [vals[3 * p] * float(ccm[d, 0]) + vals[3 * p + 1]
            * float(ccm[d, 1]) + vals[3 * p + 2] * float(ccm[d, 2])
            for p in range(4) for d in range(3)]
  return torch.clamp(torch.stack(vals, dim=1), 0.0, 1.0).to(out_dtype)


def cfa_phases(cfa: torch.Tensor) -> torch.Tensor:
  """(N, H, W) CFA -> (N, 4, H/2, W/2) phase planes of its dtype, in-phase
  order (row % 2) * 2 + col % 2 (pure data movement)."""
  n, h, w = cfa.shape
  b = cfa.reshape(n, h, w // 2, 2)
  even, odd = b[..., 0], b[..., 1]
  return torch.stack([even[:, 0::2], odd[:, 0::2],
                      even[:, 1::2], odd[:, 1::2]], dim=1)


def phases_to_plane(x4: torch.Tensor, dtype=None) -> torch.Tensor:
  """(N, 4, hh, wh) single-channel phases -> full-res (N, H, W) plane
  (pure data movement)."""
  n, _, hh, wh = x4.shape
  x = x4.reshape(n, 2, 2, hh, wh)        # (n, pc, pr, hh, wh)
  t = x.permute(0, 3, 2, 4, 1)           # (n, hh, pr, wh, pc)
  return t.reshape(n, 2 * hh, 2 * wh).to(dtype or x4.dtype)


def phases_to_planar(x12: torch.Tensor, dtype=None) -> torch.Tensor:
  """(N, 12, hh, wh) phase-RGB -> full-res planar (N, 3, H, W); pure data
  movement."""
  n, _, hh, wh = x12.shape
  x = x12.reshape(n, 2, 2, 3, hh, wh)    # (n, pc, pr, c, hh, wh)
  t = x.permute(0, 3, 4, 2, 5, 1)        # (n, c, hh, pr, wh, pc)
  return t.reshape(n, 3, 2 * hh, 2 * wh).to(dtype or x12.dtype)


# The JAX package keeps a second, stack-interleave form of
# phases_to_planar because XLA on the TPU compiles the two at different
# speeds; in torch they are one function.
phases_to_planar_stack = phases_to_planar


def planar_to_phases(planar: torch.Tensor) -> torch.Tensor:
  """(N, 3, H, W) planar -> (N, 12, hh, wh) phase-RGB (the inverse of
  :func:`phases_to_planar`)."""
  return torch.cat([planar[:, :, dy::2, dx::2] for dy, dx in _PHASE_PARITY],
                   dim=1)


def subsample_hw(x: torch.Tensor, sr: int, sc: int) -> torch.Tensor:
  """``x[..., ::sr, ::sc]`` (a view; the JAX package's reshape-select form
  of it exists for the TPU's strided-slice lowering)."""
  return x[..., ::sr, ::sc]


def edge_renorm_factor(weights: np.ndarray, hh: int, wh: int,
                       is_top: bool = True,
                       is_bot: bool = True) -> torch.Tensor:
  """The elementwise border-renormalization factor, (1, 12, hh, wh) f32:
  per-row times per-column factors, with the four corners corrected to
  exactly full / corner. ``is_top`` / ``is_bot`` say whether the frame's
  first / last row is an image edge (a row band's is not). Bitwise the
  JAX package's values."""
  return torch.from_numpy(edge_renorm_factor_sampled(
      weights, hh, wh, 1, is_top=is_top, is_bot=is_bot))


def edge_renorm_factor_sampled(weights: np.ndarray, hh: int, wh: int,
                               step: int, is_top: bool = True,
                               is_bot: bool = True) -> np.ndarray:
  """The border-renormalization factor evaluated on the (::step, ::step)
  sample grid, (1, 12, hs, ws) float32 in numpy, with the stencil's f32
  arithmetic (rvf * cvv, then the corner multiplies): bitwise the K2
  kernel's factor at those pixels and the JAX package's values."""
  full, top, bottom, left, right = _edge_sums(weights, hh, wh)
  t_mid, b_mid = top[:, 1], bottom[:, 1]
  l_mid, r_mid = left[:, 1], right[:, 1]
  tl, tr_ = top[:, 0], top[:, -1]
  bl, br = bottom[:, 0], bottom[:, -1]

  hs, ws = -(-hh // step), -(-wh // step)
  rows = np.arange(hs) * step
  cols = np.arange(ws) * step
  on_top = (rows == 0) & bool(is_top)
  on_bot = (rows == hh - 1) & bool(is_bot)
  one = np.float32(1.0)
  rvf = (np.where(on_top[None, :], (full / t_mid)[:, None], one)
         * np.where(on_bot[None, :], (full / b_mid)[:, None], one))
  cv_full = np.ones((12, wh), np.float32)
  cv_full[:, 0] = full / l_mid
  cv_full[:, -1] = full / r_mid
  cv = cv_full[:, cols]
  f = rvf[:, :, None] * cv[:, None, :]
  for corner, rvec, rmask, cpos in (
      (tl, full / t_mid, on_top, 0), (tr_, full / t_mid, on_top, wh - 1),
      (bl, full / b_mid, on_bot, 0), (br, full / b_mid, on_bot, wh - 1)):
    cval = (full / corner) / (rvec * cv_full[:, cpos])
    mask = rmask[:, None] & (cols == cpos)[None, :]
    f = np.where(mask[None, :, :], f * cval[:, None, None], f)
  return f[None].astype(np.float32)


@functools.lru_cache(maxsize=32)
def _sample_factor(pattern, method, hh, wh, step, device) -> torch.Tensor:
  """(3, hs, ws) f32 factor of channels 0..2 on ``device``, made once per
  configuration (the step then makes no host-to-device copy)."""
  f = edge_renorm_factor_sampled(_demosaic_tables(pattern, method), hh, wh,
                                 step)[0, 0:3]
  return torch.from_numpy(np.ascontiguousarray(f)).to(device)


def demosaic_samples(phases: torch.Tensor, pattern: BayerPattern, cc=None,
                     method: str = "mhc", out_dtype=torch.float32,
                     sample_step: int = 4) -> torch.Tensor:
  """Metering-sample pre-pass: the demosaic of output channels 0..2
  evaluated only on the ``(::step, ::step)`` grid, (N, 3, hs, ws) of
  ``out_dtype``. K7 (``demosaic_reinhard_front``) needs its metrics
  before it runs, so it cannot take the stencil's own sample emission.

  The arithmetic is K2's plain twin at the sampled pixels, in its tap
  order (taps in (q, u, v) order, * inv_full, * border factor, CCM as
  v0*c0 + v1*c1 + v2*c2, clip, one cast): bitwise equal to
  ``demosaic_phases(..., sample_step=step)``'s sample on either device.
  The JAX package's strided convolution sums the taps in another order
  (within one ulp of the working dtype)."""
  from taichi_image_tpu_torch.ops.hopper.demosaic import _inv_full
  n, _, hh, wh = phases.shape
  s = sample_step
  if s < 1:
    raise ValueError(f"sample_step must be >= 1, got {s}")
  weights = _demosaic_tables(pattern, method)
  inv_full = _inv_full(weights)
  factor = _sample_factor(pattern, method, hh, wh, s, phases.device)
  xp = F.pad(phases.to(torch.float32), (1, 1, 1, 1))
  vals = [_shifted_sums(xp, weights, oc, hh, wh, s) * float(inv_full[oc])
          * factor[oc] for oc in range(3)]
  if cc is not None:
    ccm = np.array(cc, np.float32).reshape(3, 3)
    vals = [vals[0] * float(ccm[d, 0]) + vals[1] * float(ccm[d, 1])
            + vals[2] * float(ccm[d, 2]) for d in range(3)]
  return torch.stack([torch.clamp(v, 0.0, 1.0) for v in vals],
                     dim=1).to(types.canonical_dtype(out_dtype))


@functools.lru_cache(maxsize=32)
def _planar_sample_index(hh, wh, step, device) -> torch.Tensor:
  """Flat (c, hh, wh) indices into one image's x12 of the full-res planar
  pixels (c, y, x) for y, x multiples of ``step``; (3 * hs * ws,) int64."""
  ys = np.arange(0, 2 * hh, step)
  xs = np.arange(0, 2 * wh, step)
  c = np.arange(3)[:, None, None]
  y, x = ys[None, :, None], xs[None, None, :]
  chan = ((x % 2) * 2 + y % 2) * 3 + c
  idx = (chan * hh + y // 2) * wh + x // 2
  return torch.from_numpy(idx.reshape(-1).astype(np.int64)).to(device)


def planar_subsample(x12: torch.Tensor, step: int) -> torch.Tensor:
  """``phases_to_planar(x12)[..., ::step, ::step]`` without the planar
  image: one gather from x12 through a cached index (the odd metering
  strides, whose samples fall on every phase)."""
  n, _, hh, wh = x12.shape
  idx = _planar_sample_index(hh, wh, step, x12.device)
  hs, ws = -(-2 * hh // step), -(-2 * wh // step)
  return x12.reshape(n, -1).index_select(1, idx).reshape(n, 3, hs, ws)


# (swap, flip_y_axes, flip_x_axes) per transform: swap puts the input
# rows (ih, pr) in the output's x slot and (iw, pc) in its y slot; a flip
# reverses an axis pair (H-1-(2a+b) == 2(hh-1-a) + (1-b) for even H).
_TRANSFORM_SFF = {
    ImageTransform.none:       (False, False, False),
    ImageTransform.rotate_90:  (True,  True,  False),
    ImageTransform.rotate_270: (True,  False, True),
    ImageTransform.transpose:  (True,  False, False),
    ImageTransform.transverse: (True,  True,  True),
    ImageTransform.rotate_180: (False, True,  True),
    ImageTransform.flip_vert:  (False, True,  False),
    ImageTransform.flip_horiz: (False, False, True),
}


# The ImageTransform of a phase-form image: the same geometric op on the
# half-res planes plus this permutation of the four phases (output phase
# p comes from input phase perm[p]).
_PHASE_TRANSFORM_PERM = {
    ImageTransform.rotate_90: (1, 3, 0, 2),
    ImageTransform.rotate_180: (3, 2, 1, 0),
    ImageTransform.rotate_270: (2, 0, 3, 1),
    ImageTransform.transpose: (0, 2, 1, 3),
    ImageTransform.flip_horiz: (2, 3, 0, 1),
    ImageTransform.flip_vert: (1, 0, 3, 2),
    ImageTransform.transverse: (3, 1, 2, 0),
}


def transform_phases(x12: torch.Tensor, t: ImageTransform) -> torch.Tensor:
  """ImageTransform on 12-channel phase form (N, 12, hh, wh): equal to
  the transform of the planar image, kept in phase form."""
  if t == ImageTransform.none:
    return x12
  perm4 = _PHASE_TRANSFORM_PERM[t]
  perm12 = [p * 3 + c for p in perm4 for c in range(3)]
  return transform_axes(x12, t, 2, 3)[:, perm12]


def planar_from_phases_transformed(out12: torch.Tensor, t: ImageTransform,
                                   out_dtype=None) -> torch.Tensor:
  """(N, 12, hh, wh) -> transformed planar (N, 3, h', w'), equal to the
  transform of ``phases_to_planar(out12)``: the interleave, the
  transform's axis swap and its flips are one permute plus flips (the
  same store addresses as the K4 kernel's transform)."""
  if t == ImageTransform.none:
    return phases_to_planar(out12, out_dtype)
  n, _, hh, wh = out12.shape
  x6 = out12.reshape(n, 2, 2, 3, hh, wh)   # (n, pc, pr, c, ih, iw)
  swap, fy, fx = _TRANSFORM_SFF[t]
  if swap:
    z = x6.permute(0, 3, 5, 1, 4, 2)       # (n, c, iw, pc, ih, pr)
    ho, wo = 2 * wh, 2 * hh
    ysl, xsl = (4, 5), (2, 3)              # where (ih,pr)/(iw,pc) landed
  else:
    z = x6.permute(0, 3, 4, 2, 5, 1)       # (n, c, ih, pr, iw, pc)
    ho, wo = 2 * hh, 2 * wh
    ysl, xsl = (2, 3), (4, 5)
  if fy:
    z = z.flip(ysl)
  if fx:
    z = z.flip(xsl)
  return z.reshape(n, 3, ho, wo).to(out_dtype or out12.dtype)


def _bayer_to_rgb(cfa: torch.Tensor, pattern: BayerPattern, cc, in_dtype,
                  out_dtype, method: str) -> torch.Tensor:
  """(N, H, W) CFAs -> (N, H, W, 3) RGB through the phase-plane core:
  normalised f32 phases, the demosaic in f32 (K2 on a CUDA tensor), the
  interleave, then the rescale and cast of ``out_dtype``."""
  phases = cfa_phases(cfa)
  if phases.dtype == torch.uint16:  # few torch ops take uint16
    phases = phases.view(torch.int16).to(torch.int32) & 0xFFFF
  phases = phases.to(torch.float32)
  in_scale = types.scale_of(in_dtype)
  if in_scale != 1.0:
    # a 0-d tensor: on CUDA torch turns a division by a Python scalar
    # into a multiply by its reciprocal
    phases = phases / torch.tensor(in_scale, dtype=torch.float32,
                                   device=phases.device)
  x12 = demosaic_phases(phases, pattern, cc=cc, method=method,
                        out_dtype=torch.float32)
  rgb = phases_to_planar(x12, torch.float32).permute(0, 2, 3, 1)
  return types.from_float(rgb, out_dtype)


def _cc_tuple(correct_colors):
  if correct_colors is None:
    return None
  return tuple(np.asarray(correct_colors, np.float32).flatten().tolist())


def bayer_to_rgb(bayer, pattern: BayerPattern = BayerPattern.RGGB,
                 correct_colors: Optional[np.ndarray] = None, dtype=None,
                 method: str = "mhc", device="cuda") -> torch.Tensor:
  """Demosaic a 2-D CFA image to (H, W, 3) RGB: the 13-tap stencils
  ("mhc", the reference's, or "bilinear") with border renormalization,
  the optional 3x3 color correction (``cc @ rgb``), clamp to [0, 1] and
  the rescale and cast to ``dtype`` (the input's by default). A host
  array is moved to ``device`` (the card by default: K2 runs there); a
  tensor is taken on its own device."""
  bayer = types.as_tensor(bayer, device)
  if bayer.ndim != 2:
    raise ValueError(
        f"image must be mono bayer, got shape {tuple(bayer.shape)}")
  if bayer.shape[0] % 2 or bayer.shape[1] % 2:
    raise ValueError(f"image must be even size, got {tuple(bayer.shape)}")
  in_dtype = types.dtype_of(bayer)
  out_dtype = in_dtype if dtype is None else types.canonical_dtype(dtype)
  return _bayer_to_rgb(bayer[None], pattern, _cc_tuple(correct_colors),
                       in_dtype, out_dtype, method)[0]


def bayer_to_rgb_batch(bayer, pattern: BayerPattern = BayerPattern.RGGB,
                       correct_colors=None, dtype=None,
                       method: str = "mhc", device="cuda") -> torch.Tensor:
  """Batched demosaic: (N, H, W) -> (N, H, W, 3), on ``device`` as
  :func:`bayer_to_rgb`."""
  bayer = types.as_tensor(bayer, device)
  if bayer.ndim != 3:
    raise ValueError(f"expected batch of mono bayer images, got shape "
                     f"{tuple(bayer.shape)}")
  in_dtype = types.dtype_of(bayer)
  out_dtype = in_dtype if dtype is None else types.canonical_dtype(dtype)
  return _bayer_to_rgb(bayer, pattern, _cc_tuple(correct_colors), in_dtype,
                       out_dtype, method)


def rgb_to_bayer(image, pattern: BayerPattern = BayerPattern.RGGB,
                 device="cuda") -> torch.Tensor:
  """Mosaic an RGB image (H, W, 3) to a single-channel CFA by 2x2 phase
  sampling (a host array on ``device``, a tensor on its own)."""
  image = types.as_tensor(image, device)
  if image.ndim != 3 or image.shape[2] != 3:
    raise ValueError(f"image must be RGB (H, W, 3), got "
                     f"{tuple(image.shape)}")
  h, w = image.shape[:2]
  p1, p2, p3, p4 = pattern.pixel_order
  x = image.reshape(h // 2, 2, w // 2, 2, 3)
  quad = torch.stack([
      torch.stack([x[:, 0, :, 0, p1], x[:, 0, :, 1, p2]], dim=-1),
      torch.stack([x[:, 1, :, 0, p3], x[:, 1, :, 1, p4]], dim=-1),
  ], dim=1)  # (hh, 2, wh, 2)
  return quad.reshape(h, w)
