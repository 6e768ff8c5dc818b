"""K1: packed12 decode to CFA phase planes of the working dtype
(``csrc/decode.cu``, one instantiation per dtype).

Replaces ``taichi_image_tpu/ops/pallas/decode.py``: the bf16 kernel
``decode12_phases_bf16`` and, as the f16 instantiation, the Camera16
route's ``decode12_phases_q16`` (whose raw codes in i32 stand in for the
f16 the TPU cannot store); the f32 instantiation replaces the XLA decode
of ``camera_isp.py:960-972``. Any even H and any row of 3k bytes: there
is no tiling gate.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from taichi_image_tpu_torch.ops import hopper

__all__ = ["decode12_phases", "decode12_phases_plain", "DECODE_SCALE"]

# f32(1/4095): both JAX routes multiply by it (camera_isp.py:971-972,
# decode.py:143); dividing by 4095 would round differently.
DECODE_SCALE = float(np.float32(1.0 / 4095.0))

_PALLAS = "taichi_image_tpu/ops/pallas/decode.py"
KERNELS = hopper.register_per_dtype(
    "decode", "decode.cu", "tit_decode12",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    {torch.bfloat16: f"{_PALLAS}:145", torch.float16: f"{_PALLAS}:185",
     torch.float32: "taichi_image_tpu/models/camera_isp.py:960-972"})


def _check_raws(raws: torch.Tensor) -> None:
  if raws.dtype != torch.uint8 or raws.ndim != 3:
    raise ValueError(f"packed12 raws must be (N, H, W_bytes) uint8, got "
                     f"{tuple(raws.shape)} {raws.dtype}")
  _, h, wb = raws.shape
  if h % 2 or wb % 3 or (wb // 3) < 1:
    raise ValueError(f"packed12 raws need an even H and a row of 3k "
                     f"bytes, got H={h}, W_bytes={wb}")


def decode12_phases_plain(raws: torch.Tensor, ids_format: bool,
                          dtype: torch.dtype) -> torch.Tensor:
  """Plain PyTorch twin: (N, H, 1.5W) u8 -> (N, 4, H/2, W/2) ``dtype``."""
  _check_raws(raws)
  b = raws.to(torch.int32)
  b0, b1, b2 = b[:, :, 0::3], b[:, :, 1::3], b[:, :, 2::3]
  if not ids_format:
    even = ((b1 & 0xF) << 8) | b0
    odd = (b2 << 4) | (b1 >> 4)
  else:
    even = (b0 << 4) | (b2 & 0xF)
    odd = (b1 << 4) | (b2 >> 4)
  phases = torch.stack([even[:, 0::2], odd[:, 0::2],
                        even[:, 1::2], odd[:, 1::2]], dim=1)
  # DECODE_SCALE is an f32 value: the Python float multiplies as that f32
  return (phases.to(torch.float32) * DECODE_SCALE).to(dtype)


def decode12_phases(raws: torch.Tensor, ids_format: bool,
                    dtype: torch.dtype,
                    backend: str = "auto") -> torch.Tensor:
  """(N, H, 1.5W) u8 packed12 -> (N, 4, H/2, W/2) phase planes of
  ``dtype`` (bf16, f16 or f32), phase order (row % 2) * 2 + col % 2;
  bitwise equal to the plain twin and to the JAX decode."""
  _check_raws(raws)
  hopper.check_dtype("the decode's output dtype", dtype)
  n, h, wb = raws.shape
  # the bytes of an image in, and its 4 phase planes out
  hopper.check_int32_extent(f"a {h}x{wb}-byte packed12 frame",
                            max(h * wb, 4 * (h // 2) * (wb // 3)))
  if not hopper.use_kernel(backend, raws):
    return decode12_phases_plain(raws, ids_format, dtype)
  hopper.check_tensor("raws", raws, torch.uint8, 3, raws.device)
  out = torch.empty((n, 4, h // 2, wb // 3), dtype=dtype, device=raws.device)
  KERNELS[dtype].launch(hopper.ptr(raws), hopper.ptr(out), n, h, wb,
                        int(bool(ids_format)), DECODE_SCALE,
                        hopper.stream_of(raws.device))
  return out
