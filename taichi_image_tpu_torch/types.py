"""Dtype conventions of the PyTorch port.

Counterpart of ``taichi_image_tpu/types.py:57-129``: every stage works
on normalized intensities in [0, 1], and an integer dtype relates to
that range by its full-scale factor. Here the dtypes are torch dtypes;
names from numpy or strings are accepted and mapped to them.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

__all__ = ["scale_factor", "canonical_dtype", "dtype_of", "is_float_dtype",
           "as_tensor", "to_device",
           "scale_of", "to_float", "from_float", "empty_like", "zeros_like",
           "u8", "u16", "i16", "f16", "bf16", "f32"]

u8 = torch.uint8
u16 = torch.uint16
i16 = torch.int16
f16 = torch.float16
bf16 = torch.bfloat16
f32 = torch.float32

DTypeLike = Union[str, torch.dtype, np.dtype, Any]

# Full-scale value per dtype (taichi_image_tpu/types.py:57-64).
scale_factor = {
    u8: 255.0,
    u16: 65535.0,
    i16: 32767.0,
    f16: 1.0,
    bf16: 1.0,
    f32: 1.0,
}

_names = {
    "uint8": u8,
    "uint16": u16,
    "int16": i16,
    "float16": f16,
    "bfloat16": bf16,
    "float32": f32,
}


def canonical_dtype(dtype: DTypeLike) -> torch.dtype:
  """Normalize a dtype token (torch dtype, string, numpy dtype — JAX's
  bfloat16 numpy dtype included) to a torch dtype.

  Raises for dtypes outside {u8, u16, i16, f16, bf16, f32}.
  """
  if isinstance(dtype, torch.dtype):
    name = str(dtype).removeprefix("torch.")
  elif isinstance(dtype, str):
    name = dtype
  else:
    name = np.dtype(dtype).name
  if name not in _names:
    raise ValueError(f"Unsupported dtype {name}; supported: {sorted(_names)}")
  return _names[name]


def to_device(t: torch.Tensor, device) -> torch.Tensor:
  """``t`` on ``device``; a uint16 tensor moves as its int16 bits (torch
  copies few uint16 tensors between devices)."""
  if t.dtype == torch.uint16:
    return t.view(torch.int16).to(device).view(torch.uint16)
  return t.to(device)


def as_tensor(x, device=None) -> torch.Tensor:
  """``x`` as a tensor: a tensor as it is, on its own device; anything
  else through numpy (sharing a writable array's memory, copying a
  read-only one, such as a JAX array's) on the CPU, or on ``device`` when
  given."""
  if isinstance(x, torch.Tensor):
    return x
  a = np.asarray(x)
  t = torch.from_numpy(a if a.flags.writeable else a.copy())
  return t if device is None else to_device(t, device)


def dtype_of(arr) -> torch.dtype:
  """The canonical dtype of a tensor or numpy array."""
  return canonical_dtype(arr.dtype)


def is_float_dtype(dtype: DTypeLike) -> bool:
  return canonical_dtype(dtype) in (f16, bf16, f32)


def scale_of(dtype: DTypeLike) -> float:
  """Full-scale value for a dtype."""
  return scale_factor[canonical_dtype(dtype)]


def to_float(x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
  """A tensor as normalized float in [0, 1] by the scale convention."""
  s = scale_of(dtype_of(x))
  x = x.to(canonical_dtype(compute_dtype))
  if s != 1.0:
    x = x / s
  return x


def from_float(x: torch.Tensor, dtype: DTypeLike,
               clip: bool = True) -> torch.Tensor:
  """A normalized float tensor rescaled to ``dtype``. Integer casts
  truncate toward zero; ``clip`` keeps integer results in [0, scale]
  instead of wrapping."""
  dt = canonical_dtype(dtype)
  s = scale_of(dt)
  if s != 1.0:
    x = x * s
  if clip and not dt.is_floating_point:
    x = torch.clamp(x, 0, s)
  return x.to(dt)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
  if dtype == bf16:
    raise ValueError("numpy has no bfloat16")
  return np.dtype(str(dtype).removeprefix("torch."))


def empty_like(in_arr, shape=None, dtype=None) -> np.ndarray:
  """An uninitialized numpy array like ``in_arr`` (API compatibility:
  the ops allocate their own outputs)."""
  shape = in_arr.shape if shape is None else shape
  dt = dtype_of(in_arr) if dtype is None else canonical_dtype(dtype)
  return np.empty(tuple(shape), _numpy_dtype(dt))


def zeros_like(in_arr, shape=None, dtype=None) -> np.ndarray:
  """A zeroed numpy array like ``in_arr``."""
  shape = in_arr.shape if shape is None else shape
  dt = dtype_of(in_arr) if dtype is None else canonical_dtype(dtype)
  return np.zeros(tuple(shape), _numpy_dtype(dt))
