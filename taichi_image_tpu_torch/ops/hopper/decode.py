"""K1: packed12 decode to bf16 CFA phase planes (``csrc/decode.cu``).

Replaces ``taichi_image_tpu/ops/pallas/decode.py::decode12_phases_bf16``.
Any even H and any row of 3k bytes: there is no tiling gate.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from taichi_image_tpu_torch.ops import hopper

__all__ = ["decode12_phases_bf16", "decode12_phases_plain", "DECODE_SCALE"]

# f32(1/4095): both JAX routes multiply by it (camera_isp.py:971-972,
# decode.py:143); dividing by 4095 would round differently.
DECODE_SCALE = float(np.float32(1.0 / 4095.0))

KERNEL = hopper.register(hopper.Kernel(
    name="decode", source="decode.cu", symbol="tit_decode12_bf16",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    replaces="taichi_image_tpu/ops/pallas/decode.py:145"))


def _check_raws(raws: torch.Tensor) -> None:
  if raws.dtype != torch.uint8 or raws.ndim != 3:
    raise ValueError(f"packed12 raws must be (N, H, W_bytes) uint8, got "
                     f"{tuple(raws.shape)} {raws.dtype}")
  _, h, wb = raws.shape
  if h % 2 or wb % 3 or (wb // 3) < 1:
    raise ValueError(f"packed12 raws need an even H and a row of 3k "
                     f"bytes, got H={h}, W_bytes={wb}")


def decode12_phases_plain(raws: torch.Tensor,
                          ids_format: bool = False) -> torch.Tensor:
  """Plain PyTorch twin: (N, H, 1.5W) u8 -> (N, 4, H/2, W/2) bf16."""
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
  return (phases.to(torch.float32) * DECODE_SCALE).to(torch.bfloat16)


def decode12_phases_bf16(raws: torch.Tensor, ids_format: bool = False,
                         backend: str = "auto") -> torch.Tensor:
  """(N, H, 1.5W) u8 packed12 -> (N, 4, H/2, W/2) bf16 phase planes,
  phase order (row % 2) * 2 + col % 2; bitwise equal to the plain twin
  and to the JAX decode."""
  _check_raws(raws)
  if not hopper.use_kernel(backend, raws):
    return decode12_phases_plain(raws, ids_format)
  hopper.check_tensor("raws", raws, torch.uint8, 3, raws.device)
  n, h, wb = raws.shape
  out = torch.empty((n, 4, h // 2, wb // 3), dtype=torch.bfloat16,
                    device=raws.device)
  KERNEL.launch(hopper.ptr(raws), hopper.ptr(out), n, h, wb,
                int(bool(ids_format)), DECODE_SCALE,
                hopper.stream_of(raws.device))
  return out
