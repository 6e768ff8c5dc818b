"""Debug and validation (counterpart of
``taichi_image_tpu/utils/debug.py``).

* Raw buffer validation (``validate_raw``, ``validate_raw_file``), always
  on and on the host: it runs before any kernel launch, so a mis-shaped
  buffer raises a clear ``ValueError`` instead of reaching the decode
  kernel as an out-of-bounds read.
* An opt-in debug mode (``TAICHI_IMAGE_TPU_DEBUG=1``, the JAX package's
  variable): the ISP step checks that the packed and u16 formats decode
  into [0, 1] and that the metering stats are finite, raising
  :class:`DebugCheckError` on the first failure. Each check reads a flag
  on the host (a sync), so it runs only under that variable. Explicit
  invariants, not a blanket NaN check: the Reinhard map makes and ignores
  NaN for pixels below the EMA bounds by design.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["debug_enabled", "validate_raw", "validate_raw_file",
           "check_decoded", "check_metrics", "DebugCheckError"]

_ENV = "TAICHI_IMAGE_TPU_DEBUG"


class DebugCheckError(RuntimeError):
  """A debug-mode invariant of the ISP step failed."""


def debug_enabled() -> bool:
  """True when TAICHI_IMAGE_TPU_DEBUG is set to a non-empty value other
  than 0 or false; read on every call."""
  return os.environ.get(_ENV, "") not in ("", "0", "false", "False")


def check_decoded(phases: torch.Tensor) -> None:
  """Debug check: decoded CFA values lie in [0, 1] (the packed and u16
  formats; the float loaders feed their values as they are)."""
  x = phases.to(torch.float32)
  if not bool(((x >= 0.0) & (x <= 1.0)).all()):
    raise DebugCheckError(
        "decoded CFA values escape [0, 1] — corrupt raw or wrong format")


def check_metrics(metrics: torch.Tensor) -> None:
  """Debug check: the metering stats are finite."""
  if not bool(torch.isfinite(metrics).all()):
    raise DebugCheckError(
        "metering produced non-finite stats — NaN/inf in input frames")


def _is_u8(dtype) -> bool:
  if isinstance(dtype, torch.dtype):
    return dtype == torch.uint8
  return np.dtype(dtype) == np.uint8


def validate_raw(raws, fmt: str, batch: bool = True) -> None:
  """Validate a raw frame (batch) against its claimed format.

  ``raws``: a torch tensor or numpy array, (N, H, W_bytes) if ``batch``
  else (H, W_bytes).
  """
  ndim = 3 if batch else 2
  if raws.ndim != ndim:
    raise ValueError(
        f"{fmt} raw batch must be {ndim}-D (N, H, W_bytes), got shape "
        f"{tuple(raws.shape)}")
  h, wb = raws.shape[-2], raws.shape[-1]
  if fmt in ("packed12", "packed16") and not _is_u8(raws.dtype):
    raise ValueError(f"{fmt} raw must be uint8 bytes, got {raws.dtype}")
  if fmt == "packed12":
    if wb % 3 != 0:
      raise ValueError(
          f"packed12 row stride must be a multiple of 3 bytes (2 pixels "
          f"per 3 bytes), got {wb}")
    w = wb * 2 // 3
  elif fmt == "packed16":
    if wb % 2 != 0:
      raise ValueError(
          f"packed16 row stride must be a multiple of 2 bytes, got {wb}")
    w = wb // 2
  elif fmt in ("u16", "f16", "f32"):
    w = wb
  else:
    raise ValueError(f"unknown raw format {fmt!r}")
  if h % 2 != 0 or w % 2 != 0:
    raise ValueError(
        f"CFA dimensions must be even for a 2x2 Bayer pattern, got "
        f"{h}x{w} (from {h}x{wb} raw bytes as {fmt}).")


def validate_raw_file(nbytes: int, width: int, fmt: str = "packed12") -> int:
  """Validate a raw file's size against a claimed width; returns the
  implied height (a wrong width would otherwise scramble the frames)."""
  row_bytes = {"packed12": width * 3 // 2, "packed16": width * 2}.get(fmt)
  if row_bytes is None:
    raise ValueError(f"unknown raw format {fmt!r}")
  if fmt == "packed12" and width % 2 != 0:
    raise ValueError(f"packed12 width must be even, got {width}")
  if nbytes % row_bytes != 0:
    raise ValueError(
        f"raw file of {nbytes} bytes is not a whole number of {width}-px "
        f"{fmt} rows ({row_bytes} bytes/row) — wrong --width?")
  h = nbytes // row_bytes
  if h % 2 != 0:
    raise ValueError(
        f"raw file of {nbytes} bytes implies an odd height {h} at width "
        f"{width} — wrong --width?")
  return h
