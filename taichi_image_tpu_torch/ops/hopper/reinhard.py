"""K3: the Reinhard map with the per-image max (``csrc/reinhard.cu``,
one instantiation per working dtype).

Replaces the TPU map kernels of ``taichi_image_tpu/ops/pallas/reinhard.py``:
``reinhard_map_bf16_dma`` (bf16), ``reinhard_map_pallas`` (f32) and, as
the f16 instantiation, ``reinhard_map_q16_dma`` (the Camera16 route) and
``reinhard_map_packed(_dma)``, whose i32 containers stand in for the f16
the TPU cannot load or store. The scalar vector is M's (``meter.py``:
the metering kernel writes it beside the new vec9, or ``meter_vectors``
from metrics the caller holds), handed to the kernel as a device
pointer: the main path makes no host sync. :func:`reinhard_scal` and
:func:`reinhard_scal_ca` are its plain twins, kept in ``meter.py``.
"""

from __future__ import annotations

import ctypes

import torch

from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.ops.hopper.meter import (reinhard_scal,
                                                     reinhard_scal_ca)

__all__ = ["reinhard_scal", "reinhard_scal_ca", "reinhard_map",
           "reinhard_map_plain", "reinhard_map_f32"]

_PALLAS = "taichi_image_tpu/ops/pallas/reinhard.py"
KERNELS = hopper.register_per_dtype(
    "reinhard", "reinhard.cu", "tit_reinhard_map",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    # f16 also covers reinhard_map_packed_dma (:441) and _packed (:482)
    {torch.bfloat16: f"{_PALLAS}:274", torch.float16: f"{_PALLAS}:625",
     torch.float32: f"{_PALLAS}:124"})


def reinhard_map_f32(x: torch.Tensor, scal: torch.Tensor,
                     ca_mode: bool) -> torch.Tensor:
  """The f32 pre-gamma map ``p`` of (N, C, hh, wh), C % 3 == 0, with the
  kernel's expressions (pow as exp2(k * log2(b))) and NaN zeroed."""
  n, nc, hh, wh = x.shape
  xf = x.to(torch.float32).reshape(n, nc // 3, 3, hh, wh)
  m0, rng, mk, mean, eni, la = (scal[i] for i in range(6))
  scaled = (xf - m0) / rng
  r, g, b = scaled[:, :, 0], scaled[:, :, 1], scaled[:, :, 2]
  gray = (0.299 * r + 0.587 * g + 0.114 * b)[:, :, None]
  if not ca_mode:
    adapt = torch.exp2(mk * torch.log2(eni * (mean + la * (gray - mean))))
  else:
    ca = scal[6]
    cmean = scal[7:10].reshape(1, 1, 3, 1, 1)
    adapt_color = gray + ca * (scaled - gray)
    adapt = torch.exp2(
        mk * torch.log2(eni * (cmean + la * (adapt_color - cmean))))
  p = scaled * (1.0 / (adapt + scaled))
  p = torch.where(torch.isnan(p), 0.0, p)
  return p.reshape(n, nc, hh, wh)


def reinhard_map_plain(x: torch.Tensor, scal: torch.Tensor, ca_mode: bool,
                       dtype: torch.dtype):
  """Plain PyTorch twin of K3: ``(p (N, C, hh, wh) of dtype, per-image max
  of the f32 p (N, 1, 1, 1))``."""
  p = reinhard_map_f32(x, scal, ca_mode)
  return p.to(dtype), p.amax(dim=(1, 2, 3)).reshape(-1, 1, 1, 1)


def reinhard_map(x: torch.Tensor, scal: torch.Tensor, ca_mode: bool,
                 backend: str = "auto"):
  """(N, C, hh, wh) x12 of the working dtype (bf16, f16 or f32),
  C % 3 == 0 -> ``(p of x's dtype and shape, per-image f32 max
  (N, 1, 1, 1))``; the max is over the f32 p before the cast. ``scal`` is
  the (6,) or, with ``ca_mode``, (10,) vector."""
  if x.ndim != 4 or x.shape[1] % 3 != 0 or x.shape[1] == 0:
    raise ValueError(f"map input must be (N, 3k, hh, wh), got "
                     f"{tuple(x.shape)}")
  hopper.check_dtype("the map's input", x.dtype)
  want = 10 if ca_mode else 6
  if scal.shape != (want,):
    raise ValueError(f"scal must be ({want},), got {tuple(scal.shape)}")
  n, nc, hh, wh = x.shape
  hopper.check_int32_extent(f"a ({nc}, {hh}, {wh}) map image", nc * hh * wh)
  if not hopper.use_kernel(backend, x):
    return reinhard_map_plain(x, scal, ca_mode, x.dtype)
  hopper.check_tensor("x", x, x.dtype, 4, x.device)
  hopper.check_tensor("scal", scal, torch.float32, 1, x.device)
  p = torch.empty_like(x)
  # the encoded maxima, then the block counters: one memset clears both
  scratch = torch.empty((2 * n,), dtype=torch.int32, device=x.device)
  mx = torch.empty((n, 1, 1, 1), dtype=torch.float32, device=x.device)
  KERNELS[x.dtype].launch(x.device, hopper.ptr(x), hopper.ptr(p),
                          hopper.ptr(scratch), hopper.ptr(mx), n, nc // 3, hh,
                          wh, hopper.ptr(scal), int(bool(ca_mode)))
  return p, mx
