"""K2: the demosaic stencil with fused finish and metering samples
(``csrc/demosaic.cu``, one instantiation per working dtype).

Replaces ``taichi_image_tpu/ops/pallas/demosaic.py::demosaic_stencil``
with ``finish`` and ``sample_step``: its bf16 and f32 finishes and, as
the f16 instantiation, its ``q16_io`` branch (the Camera16 route, whose
16-bit codes stand in for the f16 the TPU cannot load or store).
The weights, ``inv_full``, border factors, corner corrections and CCM
travel as one f32 block in the kernel's parameters; which of the 13
diamond taps of each channel are summed is fixed at compile time, one
kernel per (pattern, method) variant (:func:`tap_variant`). The rows that
take the top and bottom factors are the finish spec's ``top_row`` and
``bot_row``, so a row band read with a halo row on each side gates its
factors at the image's own edges; ``rows`` stores only the band's rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.ops.bayer import (_PHASE_PARITY, BayerPattern,
                                              _demosaic_tables,
                                              _shifted_sums, diamond_kernel)

__all__ = ["demosaic_stencil", "demosaic_stencil_plain", "stencil_params",
           "tap_variant"]

KERNELS = hopper.register_per_dtype(
    "demosaic", "demosaic.cu", "tit_demosaic_stencil",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p],
    # one pallas_call serves the bf16 and f32 finishes and the q16 branch
    dict.fromkeys(hopper.DTYPE_SUFFIX,
                  "taichi_image_tpu/ops/pallas/demosaic.py:377"))

# layout of csrc/stencil.cuh StencilParams (without has_ccm)
PARAM_FLOATS = 12 * 13 + 12 * 5 + 4 * 12 + 9


def _diamond_taps() -> np.ndarray:
  """(4, 13): for each output phase, its 13 diamond taps as positions
  q*9 + u*3 + v of the 4 x 3 x 3 neighbourhood, ascending — the
  kernel's compile-time kTaps table (csrc/stencil.cuh)."""
  offsets = [o for o, _ in diamond_kernel([0] * 13)]
  taps = []
  for dy, dx in _PHASE_PARITY:
    ks = []
    for oy, ox in offsets:
      sy, sx = dy + oy, dx + ox
      ks.append(((sy % 2) * 2 + sx % 2) * 9 + (sy // 2 + 1) * 3 + sx // 2 + 1)
    taps.append(sorted(ks))
  return np.array(taps)


DIAMOND_TAPS = _diamond_taps()


def _inv_full(weights: np.ndarray) -> np.ndarray:
  """f32(1 / sum of weights) per out channel, as the JAX stencil takes it
  (a Python double rounded to f32)."""
  full = weights.sum(axis=(1, 2, 3))
  return (1.0 / full.astype(np.float64)).astype(np.float32)


# Flat indices of each channel's diamond taps in a (12, 36) weight table,
# and the bit of each tap in a channel's mask. The wrapper gathers the
# diamond weights and the masks on every launch, in numpy: a Python loop
# there took longer than the kernel.
_W13_INDEX = (np.arange(12)[:, None] * 36
              + DIAMOND_TAPS[np.arange(12) // 3]).ravel()
_TAP_BITS = 1 << np.arange(13)


def _w13(weights: np.ndarray) -> np.ndarray:
  """(12, 13): each channel's weights at its phase's diamond taps, in
  DIAMOND_TAPS order."""
  w = np.asarray(weights).reshape(-1)
  w13 = w[_W13_INDEX]
  if np.count_nonzero(w) != np.count_nonzero(w13):
    raise ValueError("stencil weights fall outside the diamond taps")
  return w13.reshape(12, 13)


def tap_masks(weights: np.ndarray) -> tuple[int, ...]:
  """Per channel, the 13-bit mask of its nonzero diamond taps (bit k for
  DIAMOND_TAPS[oc // 3][k])."""
  return tuple(((_w13(weights) != 0) @ _TAP_BITS).tolist())


# The stencil's compile-time variants (csrc/stencil.cuh kTapMasks), in its
# order: variant = pattern * 2 + method.
VARIANTS = tuple((pattern, method)
                 for pattern in (BayerPattern.RGGB, BayerPattern.GRBG,
                                 BayerPattern.GBRG, BayerPattern.BGGR)
                 for method in ("mhc", "bilinear"))
TAP_MASKS = tuple(tap_masks(_demosaic_tables(pattern, method))
                  for pattern, method in VARIANTS)
_VARIANT_OF = {masks: v for v, masks in enumerate(TAP_MASKS)}


def tap_variant(weights: np.ndarray) -> int:
  """The kernel variant whose compile-time tap masks are the nonzero
  pattern of ``weights``; raises ValueError for a pattern no variant
  has (the kernel sums only the masked taps, so it cannot take it)."""
  masks = tap_masks(weights)
  if masks not in _VARIANT_OF:
    raise ValueError("the stencil weights' nonzero taps match no compiled "
                     "variant (a Bayer pattern x {mhc, bilinear}); got "
                     f"masks {[hex(m) for m in masks]}")
  return _VARIANT_OF[masks]


def stencil_params(weights: np.ndarray, finish: dict) -> np.ndarray:
  """The kernel's f32 parameter block: weights at each phase's diamond
  taps (12 x 13), inv_full, topf, botf, leftf, rightf (12 each), cvals
  (4 x 12), CCM (9)."""
  w13 = _w13(weights)
  ccm = finish["cc"]
  parts = [w13, _inv_full(weights), finish["topf"],
           finish["botf"], finish["leftf"], finish["rightf"],
           finish["cvals"],
           np.zeros(9, np.float32) if ccm is None else ccm]
  block = np.concatenate([np.asarray(p, np.float32).ravel() for p in parts])
  if block.size != PARAM_FLOATS:
    raise ValueError(f"stencil parameter block has {block.size} floats, "
                     f"the kernel takes {PARAM_FLOATS}")
  return block


# {(id(weights), id(finish)): (weights, finish, variant, parameter block,
# its pointer)}: the launch arguments of a configuration, made once. The
# step's weights and finish specs come from caches
# (ops/bayer._demosaic_tables, _finish_spec_for: the pattern, the CCM, the
# dtype and the frame), so the same objects return every frame; an entry
# holds them, so their ids cannot be reused while it lives. The specs are
# never mutated.
_LAUNCH_ARGS: dict = {}
_LAUNCH_ARGS_MAX = 64


def _launch_args(weights: np.ndarray, finish: dict):
  """(variant, parameter block's pointer) of a configuration: the same
  values as :func:`tap_variant` and :func:`stencil_params` give, without
  their numpy work after the first launch."""
  key = (id(weights), id(finish))
  hit = _LAUNCH_ARGS.get(key)
  if hit is None:
    if len(_LAUNCH_ARGS) >= _LAUNCH_ARGS_MAX:
      _LAUNCH_ARGS.pop(next(iter(_LAUNCH_ARGS)))
    params = stencil_params(weights, finish)
    hit = _LAUNCH_ARGS[key] = (weights, finish, tap_variant(weights), params,
                               params.ctypes.data_as(ctypes.c_void_p))
  return hit[2], hit[4]


def _border_factor(oc: int, hh: int, wh: int, finish: dict, device):
  """(hh, wh) f32 renorm factor of channel ``oc``: rvf * cvv, then the
  corner multiplies (the kernel's order). Python-float operands act as
  their f32 values, and every table value is an f32."""
  rows = torch.arange(hh, device=device)
  cols = torch.arange(wh, device=device)
  on_top, on_bot = rows == finish["top_row"], rows == finish["bot_row"]
  on_left, on_right = cols == 0, cols == wh - 1

  def pick(mask, key):
    return torch.where(mask, float(finish[key][oc]), 1.0)

  rvf = pick(on_top, "topf") * pick(on_bot, "botf")
  cvv = pick(on_left, "leftf") * pick(on_right, "rightf")
  f = rvf[:, None] * cvv[None, :]
  for k, (rmask, cmask) in enumerate(((on_top, on_left), (on_top, on_right),
                                      (on_bot, on_left), (on_bot, on_right))):
    mask = rmask[:, None] & cmask[None, :]
    f = torch.where(mask, f * float(finish["cvals"][k, oc]), f)
  return f


def demosaic_stencil_plain(phases: torch.Tensor, weights: np.ndarray,
                           finish: dict, sample_step: int = 0, rows=None):
  """Plain PyTorch twin of K2, in the kernel's arithmetic order: returns
  ``(x12 (N, 12, ho, wh) finish["out_dtype"], sample (N, 3, hs, ws) or
  None)``, rows ``rows`` = (r0, r1) of the frame (all of them for
  None) and the sample taken from those rows."""
  n, _, hh, wh = phases.shape
  xp = F.pad(phases.to(torch.float32), (1, 1, 1, 1))
  inv_full = _inv_full(weights)
  ccm = finish["cc"]
  outs = []
  for ph in range(4):
    vals = []
    for c in range(3):
      oc = ph * 3 + c
      val = _shifted_sums(xp, weights, oc, hh, wh) * float(inv_full[oc])
      vals.append(val * _border_factor(oc, hh, wh, finish, phases.device))
    if ccm is not None:
      vals = [vals[0] * float(ccm[d, 0]) + vals[1] * float(ccm[d, 1])
              + vals[2] * float(ccm[d, 2]) for d in range(3)]
    outs += [torch.clamp(v, 0.0, 1.0).to(finish["out_dtype"]) for v in vals]
  x12 = torch.stack(outs, dim=1)
  if rows is not None:
    x12 = x12[:, :, rows[0]:rows[1]].contiguous()
  samp = None
  if sample_step:
    s = sample_step
    samp = x12[:, 0:3, ::s, ::s].contiguous()
  return x12, samp


def demosaic_stencil(phases: torch.Tensor, weights: np.ndarray,
                     finish: dict, sample_step: int = 0,
                     backend: str = "auto", rows=None):
  """(N, 4, hh, wh) phase planes -> ``(x12 (N, 12, hh, wh), sample)``:
  the finished stencil (border renorm, optional CCM, clip, cast) and,
  with ``sample_step`` > 0, ``x12[:, 0:3, ::s, ::s]`` (else None).

  Phases, x12 and sample share one working dtype (bf16, f16 or f32),
  ``finish["out_dtype"]``. The top and bottom factors apply at rows
  ``finish["top_row"]`` and ``finish["bot_row"]`` (-1: none). ``rows`` =
  (r0, r1) stores rows r0 .. r1 - 1 only, as (N, 12, r1 - r0, wh) with
  the sample taken from them: a band read with a halo row on each side
  stores its own rows with (1, hh - 1).
  """
  if phases.ndim != 4 or phases.shape[1] != 4:
    raise ValueError(f"phases must be (N, 4, hh, wh), got "
                     f"{tuple(phases.shape)}")
  if sample_step < 0:
    raise ValueError(f"sample_step must be >= 0, got {sample_step}")
  n, _, hh, wh = phases.shape
  if (finish["hh"], finish["wh"]) != (hh, wh):
    raise ValueError(f"finish spec is for {finish['hh']}x{finish['wh']}, "
                     f"phases are {hh}x{wh}")
  r0, r1 = (0, hh) if rows is None else rows
  if not 0 <= r0 <= r1 <= hh:
    raise ValueError(f"rows {rows} fall outside the frame's {hh} rows")
  dtype = finish["out_dtype"]
  hopper.check_dtype("the stencil's output dtype", dtype)
  if phases.dtype != dtype:
    raise ValueError(f"phases are {phases.dtype} but the stencil writes "
                     f"{dtype}: the kernels take one working dtype")
  if not hopper.use_kernel(backend, phases):
    return demosaic_stencil_plain(phases, weights, finish, sample_step,
                                  rows)
  hopper.check_tensor("phases", phases, dtype, 4, phases.device)
  hopper.check_frame_size(hh, wh)
  variant, params = _launch_args(weights, finish)
  dev = phases.device
  ho = r1 - r0
  x12 = torch.empty((n, 12, ho, wh), dtype=dtype, device=dev)
  s = sample_step
  samp = (torch.empty((n, 3, -(-ho // s), -(-wh // s)), dtype=dtype,
                      device=dev) if s else None)
  KERNELS[dtype].launch(dev, hopper.ptr(phases), hopper.ptr(x12),
                        hopper.ptr(samp) if s else None, n, hh, wh, s,
                        params, int(finish["cc"] is not None), variant,
                        finish["top_row"], finish["bot_row"], r0, ho)
  return x12, samp
