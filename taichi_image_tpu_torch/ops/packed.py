"""Packed RAW bit-packing codecs, 12-bit and 16-bit (counterpart of
``taichi_image_tpu/ops/packed.py``), as plain torch functions: the JAX
package leaves them to XLA, and the ISP decodes its raws with K1 and its
packed16 mode (``ops/hopper/decode.py``), not with these.

Bit layouts:

standard 12-bit (2 values p0, p1 -> 3 bytes):
    b0 = p0[7:0]
    b1 = p1[3:0] << 4 | p0[11:8]
    b2 = p1[11:4]
IDS-camera layout:
    b0 = p0[11:4]
    b1 = p1[11:4]
    b2 = p0[3:0] << 4 | p1[3:0]
16-bit: little-endian u16.

``scaled`` maps code values to and from the [0, 1]-normalised range of
the array's dtype: encode computes ``floor(f32(x) * f32(4095 / scale) +
0.5)`` in f32 (half away from zero for the non-negative values here),
decode multiplies once by ``f32(scale / 4095)`` (or 65535) and casts,
truncating toward zero for integer dtypes. The bit manipulation runs in
int32, since torch has few uint16 operations; results are bitwise the JAX
package's, and the same shapes raise the same ``ValueError``s. A host
array is moved to ``device`` (the card by default; the tests ask for the
CPU); a tensor is taken on its own device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from taichi_image_tpu_torch import types

__all__ = [
    "encode12", "decode12", "decode16", "encode16",
    "encode12_pairs", "decode12_pairs", "PackedMono12",
]


def _name(dtype: torch.dtype) -> str:
  return str(dtype).removeprefix("torch.")


def _i32(x: torch.Tensor) -> torch.Tensor:
  """Integer codes as int32 (a uint16 tensor through its bits)."""
  if x.dtype == torch.uint16:
    return x.view(torch.int16).to(torch.int32) & 0xFFFF
  return x.to(torch.int32)


def _u16_codes(x: torch.Tensor) -> torch.Tensor:
  """``x.astype(uint16)`` as int32 codes: integers wrap, floats truncate
  toward zero."""
  if x.is_floating_point():
    return x.to(torch.int32) & 0xFFFF
  return _i32(x) & 0xFFFF


def encode12_pairs(p0, p1, ids_format: bool = False, device="cuda"):
  """Two arrays of 12-bit values -> three u8 byte planes."""
  p0 = _u16_codes(types.as_tensor(p0, device))
  p1 = _u16_codes(types.as_tensor(p1, device))
  if not ids_format:
    b0 = p0 & 0xFF
    b1 = ((p1 & 0xF) << 4) | (p0 >> 8)
    b2 = p1 >> 4
  else:
    b0 = p0 >> 4
    b1 = p1 >> 4
    b2 = ((p0 & 0xF) << 4) | (p1 & 0xF)
  return tuple((b & 0xFF).to(torch.uint8) for b in (b0, b1, b2))


def _decode12_codes(b0, b1, b2, ids_format: bool):
  b0, b1, b2 = (_i32(b) & 0xFFFF for b in (b0, b1, b2))
  if not ids_format:
    p0 = ((b1 & 0xF) << 8) | b0
    p1 = (b2 << 4) | (b1 >> 4)
  else:
    p0 = (b0 << 4) | (b2 & 0xF)
    p1 = (b1 << 4) | (b2 >> 4)
  return p0 & 0xFFFF, p1 & 0xFFFF


def decode12_pairs(b0, b1, b2, ids_format: bool = False, device="cuda"):
  """Three u8 byte planes -> two uint16 arrays of 12-bit values."""
  b0, b1, b2 = (types.as_tensor(b, device) for b in (b0, b1, b2))
  return tuple(p.to(torch.uint16)
               for p in _decode12_codes(b0, b1, b2, ids_format))


def _scaled_codes(flat: torch.Tensor, full: float,
                  in_dtype: torch.dtype) -> torch.Tensor:
  """``floor(f32(x) * f32(full / scale) + 0.5)`` as int32 codes."""
  mult = np.float32(full / types.scale_of(in_dtype))
  x = flat.to(torch.float32) * float(mult)
  return torch.floor(x + 0.5).to(torch.int32) & 0xFFFF


def _from_codes(codes: torch.Tensor, scaled: bool, full: float,
                out_dtype: torch.dtype) -> torch.Tensor:
  """int32 codes -> ``out_dtype``, through one f32 multiply by
  ``f32(scale / full)`` when ``scaled``."""
  if scaled:
    mult = np.float32(types.scale_of(out_dtype) / full)
    return (codes.to(torch.float32) * float(mult)).to(out_dtype)
  return codes.to(out_dtype)


def encode12(values, scaled: bool = False, ids_format: bool = False,
             device="cuda"):
  """Pack 12-bit values (stored in u16, or normalised floats/ints if
  ``scaled``) into bytes; (..., W) -> (..., W*3/2) u8."""
  values = types.as_tensor(values, device)
  shape = tuple(values.shape)
  if shape[-1] % 2:
    raise ValueError(
        f"last dimension must be even for 12-bit encoding got: {shape}")
  in_dtype = types.canonical_dtype(values.dtype)
  flat = values.reshape(-1)
  codes = (_scaled_codes(flat, 4095.0, in_dtype) if scaled
           else _u16_codes(flat))
  pairs = codes.reshape(-1, 2)
  b = encode12_pairs(pairs[:, 0], pairs[:, 1], ids_format)
  return torch.stack(b, dim=-1).reshape(shape[:-1] + (shape[-1] * 3 // 2,))


def decode12(values, dtype=types.u16, scaled: bool = False,
             ids_format: bool = False, device="cuda"):
  """Unpack 12-bit packed bytes; (..., W) -> (..., W*2/3) of ``dtype``."""
  values = types.as_tensor(values, device)
  shape = tuple(values.shape)
  if types.canonical_dtype(values.dtype) != types.u8:
    raise ValueError(f"packed buffer must be u8, got {_name(values.dtype)}")
  if shape[-1] % 3:
    raise ValueError(
        f"last dimension must be a factor of 3 for 12-bit decoding got: "
        f"{shape}")
  out_dtype = types.canonical_dtype(dtype)
  triples = values.reshape(-1, 3)
  p0, p1 = _decode12_codes(triples[:, 0], triples[:, 1], triples[:, 2],
                           ids_format)
  codes = torch.stack([p0, p1], dim=-1).reshape(-1)
  out = _from_codes(codes, scaled, 4095.0, out_dtype)
  return out.reshape(shape[:-1] + (shape[-1] * 2 // 3,))


def decode16(values, dtype=types.u16, scaled: bool = False,
             ids_format: bool = False, device="cuda"):
  """Unpack little-endian u16 bytes; (..., W) -> (..., W/2) of ``dtype``
  (``ids_format`` accepted and ignored, as in the reference)."""
  del ids_format
  values = types.as_tensor(values, device)
  shape = tuple(values.shape)
  if types.canonical_dtype(values.dtype) != types.u8:
    raise ValueError(f"packed buffer must be u8, got {_name(values.dtype)}")
  if shape[-1] % 2:
    raise ValueError(
        f"last dimension must be a factor of 2 for 16-bit decoding got: "
        f"{shape}")
  out_dtype = types.canonical_dtype(dtype)
  pairs = values.reshape(-1, 2).to(torch.int32)
  codes = (pairs[:, 1] << 8) | pairs[:, 0]
  out = _from_codes(codes, scaled, 65535.0, out_dtype)
  return out.reshape(shape[:-1] + (shape[-1] // 2,))


def encode16(values, scaled: bool = False, device="cuda"):
  """Pack u16 values into little-endian bytes; (..., W) -> (..., W*2)
  u8 (the inverse of :func:`decode16`)."""
  values = types.as_tensor(values, device)
  shape = tuple(values.shape)
  flat = values.reshape(-1)
  codes = (_scaled_codes(flat, 65535.0, types.canonical_dtype(values.dtype))
           if scaled else _u16_codes(flat))
  lo = (codes & 0xFF).to(torch.uint8)
  hi = (codes >> 8).to(torch.uint8)
  return torch.stack([lo, hi], dim=-1).reshape(shape[:-1]
                                               + (shape[-1] * 2,))


class PackedMono12:
  """Random-access view over a packed 12-bit mono buffer: indexing takes
  scalars or index arrays and decodes only the touched byte triples."""

  def __init__(self, packed, width: Optional[int] = None, device="cuda"):
    packed = types.as_tensor(packed, device)
    if types.canonical_dtype(packed.dtype) != types.u8:
      raise ValueError(f"packed buffer must be u8, got {_name(packed.dtype)}")
    if packed.ndim == 1:
      if width is None:
        raise ValueError("width required for flat buffers")
      packed = packed.reshape(-1, width * 3 // 2)
    if packed.ndim != 2 or packed.shape[1] % 3:
      raise ValueError(
          f"expected (rows, 3k-byte) packed buffer, got "
          f"{tuple(packed.shape)}")
    self.packed = packed
    self.shape = (packed.shape[0], packed.shape[1] * 2 // 3)

  def __getitem__(self, idx):
    """value(s) at (row, col), uint16; ``row``/``col`` may be arrays."""
    row, col = idx
    row = torch.as_tensor(np.asarray(row), device=self.packed.device)
    col = torch.as_tensor(np.asarray(col), device=self.packed.device)
    base = (col // 2) * 3
    b0 = self.packed[row, base]
    b1 = self.packed[row, base + 1]
    b2 = self.packed[row, base + 2]
    p0, p1 = _decode12_codes(b0, b1, b2, False)
    return torch.where(col % 2 == 0, p0, p1).to(torch.uint16)

  def decode(self, dtype=types.u16, scaled: bool = False,
             ids_format: bool = False):
    """Full-frame decode to (H, W)."""
    return decode12(self.packed, dtype=dtype, scaled=scaled,
                    ids_format=ids_format)
