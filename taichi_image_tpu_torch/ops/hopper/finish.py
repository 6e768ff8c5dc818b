"""K4: the tonemap finish — gamma, u8 truncation and the 2x2
phase->planar interleave (``csrc/finish.cu``, one instantiation per
working dtype of the p it reads).

Replaces ``taichi_image_tpu/ops/pallas/finish.py::finish_planar_u8``
(Reinhard mode). In JAX this step is the XLA tail of the main path
(``reinhard_gamma_ca`` + ``phases_to_planar``); the Pallas form is
opt-in there only because Mosaic cannot store u8. Hopper writes u8
directly, so here it is the main path's tail.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.ops.bayer import phases_to_planar

__all__ = ["finish_planar_u8", "finish_planar_u8_plain", "gamma_u8"]

_REPLACES = "taichi_image_tpu/ops/pallas/finish.py:199"
KERNELS = hopper.register_per_dtype(
    "finish", "finish.cu", "tit_finish_planar_u8",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_void_p],
    dict.fromkeys(hopper.DTYPE_SUFFIX, _REPLACES))


def _inv_gamma(gamma: float):
  """None for gamma == 1 (the pow is skipped, as in JAX), else
  f32(1.0 / gamma) computed in Python double."""
  gamma = float(gamma)
  if gamma == 1.0:
    return None
  return float(np.float32(1.0 / gamma))


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


def finish_planar_u8_plain(x12: torch.Tensor, max_out: torch.Tensor,
                           gamma: float) -> torch.Tensor:
  """Plain PyTorch twin of K4: (N, 12, hh, wh) -> (N, 3, 2hh, 2wh) u8."""
  return phases_to_planar(gamma_u8(x12, max_out, gamma))


def finish_planar_u8(x12: torch.Tensor, max_out: torch.Tensor,
                     gamma: float, backend: str = "auto") -> torch.Tensor:
  """(N, 12, hh, wh) pre-gamma p (bf16, f16 or f32) + per-image f32 max
  (N, 1, 1, 1) -> planar (N, 3, 2hh, 2wh) u8; bitwise equal to the plain
  twin."""
  if x12.ndim != 4 or x12.shape[1] != 12:
    raise ValueError(f"finish input must be (N, 12, hh, wh), got "
                     f"{tuple(x12.shape)}")
  hopper.check_dtype("the finish's input", x12.dtype)
  n, _, hh, wh = x12.shape
  if max_out.numel() != n:
    raise ValueError(f"max_out must hold one value per image ({n}), got "
                     f"shape {tuple(max_out.shape)}")
  if not hopper.use_kernel(backend, x12):
    return finish_planar_u8_plain(x12, max_out, gamma)
  hopper.check_tensor("x12", x12, x12.dtype, 4, x12.device)
  hopper.check_tensor("max_out", max_out, torch.float32, 4, x12.device)
  out = torch.empty((n, 3, 2 * hh, 2 * wh), dtype=torch.uint8,
                    device=x12.device)
  inv_gamma = _inv_gamma(gamma)
  KERNELS[x12.dtype].launch(hopper.ptr(x12), hopper.ptr(max_out),
                            hopper.ptr(out), n, hh, wh,
                            int(inv_gamma is not None),
                            1.0 if inv_gamma is None else inv_gamma,
                            hopper.stream_of(x12.device))
  return out
