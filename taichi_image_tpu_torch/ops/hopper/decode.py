"""K1: packed12 decode to CFA phase planes of the working dtype
(``csrc/decode.cu``, one instantiation per dtype); the CFA phase split of
the unpacked u16, f16 and f32 raws (``split_<S>_<T>``, ``csrc/split.cu``)
and K1's packed16 mode (``decode16_<T>``), the split's source mode for
packed16 bytes read as little-endian u16 pixels.

Replaces ``taichi_image_tpu/ops/pallas/decode.py``: the bf16 kernel
``decode12_phases_bf16`` and, as the f16 instantiation, the Camera16
route's ``decode12_phases_q16`` (whose raw codes in i32 stand in for the
f16 the TPU cannot store); the f32 instantiation replaces the XLA decode
of ``camera_isp.py:960-972``. Any even H and any row of 3k bytes: there
is no tiling gate. The packed16 mode and the split replace the XLA
decodes of ``camera_isp.py:973-991``; no TPU kernel existed for them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.ops.bayer import cfa_phases

__all__ = ["decode12_phases", "decode12_phases_plain", "DECODE_SCALE",
           "decode16_phases", "decode16_phases_plain", "DECODE16_SCALE",
           "split_phases", "split_phases_plain", "SPLIT_SOURCES"]

# f32(1/4095): both JAX routes multiply by it (camera_isp.py:971-972,
# decode.py:143); dividing by 4095 would round differently.
DECODE_SCALE = float(np.float32(1.0 / 4095.0))
# f32(1/65535): the JAX packed16 decode multiplies by it
# (camera_isp.py:985-986)
DECODE16_SCALE = float(np.float32(1.0 / 65535.0))

_PALLAS = "taichi_image_tpu/ops/pallas/decode.py"
KERNELS = hopper.register_per_dtype(
    "decode", "decode.cu", "tit_decode12",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    {torch.bfloat16: f"{_PALLAS}:145", torch.float16: f"{_PALLAS}:185",
     torch.float32: "taichi_image_tpu/models/camera_isp.py:960-972"})

_JAX_ISP = "taichi_image_tpu/models/camera_isp.py"
DECODE16_KERNELS = hopper.register_per_dtype(
    "decode16", "split.cu", "tit_decode16",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p],
    dict.fromkeys(hopper.DTYPE_SUFFIX, f"{_JAX_ISP}:973-986"))

# the split's source dtypes and their names in csrc/split.cu's launchers
SPLIT_SOURCES = {torch.uint16: "u16", torch.float16: "f16",
                 torch.float32: "f32"}
SPLIT_KERNELS = {
    (src, dtype): hopper.register(
        f"split_{s}_{t}", "split.cu", f"tit_split_{s}_{t}",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p], f"{_JAX_ISP}:987-991")
    for src, s in SPLIT_SOURCES.items()
    for dtype, t in hopper.DTYPE_SUFFIX.items()}


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
  KERNELS[dtype].launch(raws.device, hopper.ptr(raws), hopper.ptr(out), n, h,
                        wb, int(bool(ids_format)), DECODE_SCALE)
  return out


def _check_packed16(raws: torch.Tensor) -> None:
  if raws.dtype != torch.uint8 or raws.ndim != 3:
    raise ValueError(f"packed16 raws must be (N, H, W_bytes) uint8, got "
                     f"{tuple(raws.shape)} {raws.dtype}")
  _, h, wb = raws.shape
  if h % 2 or wb % 4:
    raise ValueError(f"packed16 raws need an even H and an even pixel "
                     f"width (W_bytes % 4 == 0), got H={h}, W_bytes={wb}")


def decode16_phases_plain(raws: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
  """Plain PyTorch twin of K1's packed16 mode: (N, H, 2W) u8 ->
  (N, 4, H/2, W/2) ``dtype``; each u16 assembled as hi * 256 + lo in
  exact f32, then one multiply by f32(1/65535) and one cast."""
  _check_packed16(raws)
  n, h, wb = raws.shape
  b = raws.reshape(n, h, wb // 4, 4).to(torch.float32)
  even = b[..., 1] * 256.0 + b[..., 0]
  odd = b[..., 3] * 256.0 + b[..., 2]
  phases = torch.stack([even[:, 0::2], odd[:, 0::2],
                        even[:, 1::2], odd[:, 1::2]], dim=1)
  return (phases * DECODE16_SCALE).to(dtype)


def decode16_phases(raws: torch.Tensor, dtype: torch.dtype,
                    backend: str = "auto") -> torch.Tensor:
  """(N, H, 2W) u8 packed16 (little-endian u16 pixels) -> (N, 4, H/2,
  W/2) phase planes of ``dtype`` (bf16, f16 or f32), phase order (row %
  2) * 2 + col % 2; bitwise equal to the plain twin and to the JAX
  decode."""
  _check_packed16(raws)
  hopper.check_dtype("the decode's output dtype", dtype)
  n, h, wb = raws.shape
  hopper.check_int32_extent(f"a {h}x{wb}-byte packed16 frame", h * wb)
  if not hopper.use_kernel(backend, raws):
    return decode16_phases_plain(raws, dtype)
  hopper.check_tensor("raws", raws, torch.uint8, 3, raws.device)
  if raws.data_ptr() % 2:
    # the kernel reads u16 pixels: a view that starts on an odd byte is
    # copied to an aligned buffer
    raws = raws.clone()
  out = torch.empty((n, 4, h // 2, wb // 4), dtype=dtype, device=raws.device)
  DECODE16_KERNELS[dtype].launch(raws.device, hopper.ptr(raws),
                                 hopper.ptr(out), n, h, wb)
  return out


def _check_cfa(cfa: torch.Tensor) -> None:
  if cfa.ndim != 3 or cfa.dtype not in SPLIT_SOURCES:
    raise ValueError(f"the split takes an (N, H, W) uint16, float16 or "
                     f"float32 CFA, got {tuple(cfa.shape)} {cfa.dtype}")
  _, h, w = cfa.shape
  if h % 2 or w % 2:
    raise ValueError(f"the CFA needs an even H and W, got {h}x{w}")


@functools.cache
def _u16_max(device: torch.device) -> torch.Tensor:
  """65535 as a 0-d f32 tensor on ``device``: torch on CUDA turns a
  division by a Python scalar into a multiply by its reciprocal, and the
  u16 normalisation is a true division."""
  return torch.tensor(65535.0, dtype=torch.float32, device=device)


def split_phases_plain(cfa: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
  """Plain PyTorch twin of the split: u16 -> f32(x) / 65535 (IEEE), f16
  and f32 cast, each rounded once to ``dtype``."""
  _check_cfa(cfa)
  if cfa.dtype == torch.uint16:
    # uint16 has few torch ops: widen its bits before any arithmetic
    x = cfa.view(torch.int16).to(torch.int32) & 0xFFFF
    return (cfa_phases(x).to(torch.float32) / _u16_max(cfa.device)).to(dtype)
  return cfa_phases(cfa).to(dtype)


def split_phases(cfa: torch.Tensor, dtype: torch.dtype,
                 backend: str = "auto") -> torch.Tensor:
  """(N, H, W) CFA of uint16, float16 or float32 -> (N, 4, H/2, W/2) phase
  planes of ``dtype`` (bf16, f16 or f32), normalised as the JAX loaders
  do; bitwise equal to the plain twin and to the JAX decode."""
  _check_cfa(cfa)
  hopper.check_dtype("the split's output dtype", dtype)
  n, h, w = cfa.shape
  hopper.check_int32_extent(f"a {h}x{w} CFA", h * w)
  if not hopper.use_kernel(backend, cfa):
    return split_phases_plain(cfa, dtype)
  hopper.check_tensor("cfa", cfa, cfa.dtype, 3, cfa.device)
  out = torch.empty((n, 4, h // 2, w // 2), dtype=dtype, device=cfa.device)
  SPLIT_KERNELS[cfa.dtype, dtype].launch(cfa.device, hopper.ptr(cfa),
                                         hopper.ptr(out), n, h, w)
  return out
