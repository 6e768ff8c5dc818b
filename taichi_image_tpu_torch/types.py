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
           "as_tensor", "to_device", "pinned_empty", "HostRing", "Uploader",
           "Downloader",
           "scale_of", "to_float", "from_float", "empty_like", "zeros_like",
           "from_dlpack", "to_dlpack", "to_torch", "from_torch",
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

# the supported torch dtypes, which canonical_dtype returns as they are
_TORCH = frozenset(_names.values())


def canonical_dtype(dtype: DTypeLike) -> torch.dtype:
  """Normalize a dtype token (torch dtype, string, numpy dtype — JAX's
  bfloat16 numpy dtype included) to a torch dtype.

  Raises for dtypes outside {u8, u16, i16, f16, bf16, f32}.
  """
  if isinstance(dtype, torch.dtype):
    if dtype in _TORCH:
      return dtype
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


# --------------------------------------------------------------------------
# Host <-> device staging: host frame sets go up through a ring of pinned
# buffers on a copy stream of their own, and outputs come down on a
# download stream into pinned host tensors, so that neither copy waits
# for the steps queued on the compute stream.
# --------------------------------------------------------------------------


def pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
  """A page-locked host tensor from torch's caching host allocator (a
  freed block is handed out again once the copies that used it are
  done). Raises where torch has no CUDA."""
  return torch.empty(shape, dtype=dtype, pin_memory=True)


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
  # torch copies few uint16 tensors between devices: they move as int16
  return torch.int16 if dtype == torch.uint16 else dtype


class HostRing:
  """A ring of ``n`` host buffers that host sets are copied into before a
  copy that runs after the host has moved on.

  :meth:`stage` copies a set into the next buffer and hands it to
  ``send``, which starts the buffer's copy and returns ``(result,
  event)``; the buffer is refilled only after its own event has passed.
  A set of another shape or dtype replaces the buffers, after every
  copy in flight has passed. ``alloc(shape, dtype)`` makes a buffer
  (:func:`pinned_empty` on the card).
  """

  def __init__(self, n: int, alloc=pinned_empty):
    if n < 1:
      raise ValueError(f"a ring needs at least one buffer, got {n}")
    self.n = n
    self.alloc = alloc
    self.key = None
    self.buffers, self.events = [], []
    self.next = 0

  def drain(self):
    """Wait for every copy in flight from the ring's buffers."""
    for ev in self.events:
      if ev is not None:
        ev.synchronize()

  def _slot(self, shape, dtype: torch.dtype):
    if self.key != (shape, dtype):
      self.drain()
      self.buffers = [self.alloc(shape, dtype) for _ in range(self.n)]
      self.events = [None] * self.n
      self.key, self.next = (shape, dtype), 0
    k = self.next
    self.next = (k + 1) % self.n
    if self.events[k] is not None:
      self.events[k].synchronize()
    return k, self.buffers[k]

  def stage(self, x, send) -> torch.Tensor:
    """``x`` (a host array, CPU tensor, or sequence of equal frames that
    are stacked) copied once into the next free buffer, then
    ``send(buffer)``; returns its result as x's dtype. float64 arrays are
    taken as float32 (as ``jnp.asarray`` takes them), uint16 moves as its
    int16 bits."""
    if isinstance(x, torch.Tensor):
      dtype, shape = x.dtype, tuple(x.shape)
      k, buf = self._slot(shape, _wire_dtype(dtype))
      buf.copy_(x.view(buf.dtype))
    else:
      frames = ([np.asarray(f) for f in x] if isinstance(x, (list, tuple))
                else None)
      a = np.asarray(x) if frames is None else frames[0]
      npdt = np.dtype(np.float32) if a.dtype == np.float64 else a.dtype
      dtype = torch.from_numpy(np.empty(0, npdt)).dtype
      shape = (tuple(a.shape) if frames is None
               else (len(frames), *a.shape))
      k, buf = self._slot(shape, _wire_dtype(dtype))
      dst = buf.numpy().view(npdt)
      if frames is None:
        np.copyto(dst, a)
      else:
        np.stack(frames, out=dst)
    out, self.events[k] = send(buf)
    return out if out.dtype == dtype else out.view(dtype)


class Uploader:
  """Host frame sets -> tensors on ``device``, started without waiting for
  the device.

  On CUDA a set is copied into a :class:`HostRing` of ``n_buffers``
  pinned buffers and sent with ``non_blocking=True`` on a copy stream of
  its own; the device's current stream (the step's) waits on the copy's
  event, and the uploaded tensor, allocated on the copy stream, is marked
  as in use by the step's stream (``record_stream``), so the caching
  allocator does not hand its memory on while either uses it. A tensor
  on a device moves as :func:`to_device` moves it (not at all when it is
  on ``device``). On the CPU a set is stacked into a plain tensor.
  """

  def __init__(self, device, n_buffers: int):
    self.device = torch.device(device)
    self.ring = HostRing(n_buffers)
    self.stream = (torch.cuda.Stream(self.device)
                   if self.device.type == "cuda" else None)

  def __call__(self, x) -> torch.Tensor:
    if self.stream is None or (isinstance(x, torch.Tensor)
                               and x.device.type != "cpu"):
      if isinstance(x, (list, tuple)):
        x = np.stack([np.asarray(f) for f in x])
      return to_device(as_tensor(x), self.device)
    return self.ring.stage(x, self._send)

  def _send(self, buf: torch.Tensor):
    compute = torch.cuda.current_stream(self.device)
    with torch.cuda.stream(self.stream):
      dev = buf.to(self.device, non_blocking=True)
    copied = self.stream.record_event()
    compute.wait_event(copied)
    dev.record_stream(compute)
    return dev, copied


class Downloader:
  """A step's device outputs -> host tensors, started without waiting.

  On CUDA a download stream of its own waits on an event of the device's
  current stream, copies each output with ``non_blocking=True`` into a
  new pinned host tensor (from torch's caching host allocator, so its
  block is reused once the caller drops it) and records an event; each
  output is marked as in use by the download stream (``record_stream``),
  so the caching allocator does not hand its memory to a later step while
  the copy reads it. On the CPU the outputs are the host tensors.
  """

  def __init__(self, device):
    self.device = torch.device(device)
    self.stream = (torch.cuda.Stream(self.device)
                   if self.device.type == "cuda" else None)

  def start(self, outs):
    """(host tensors, the event after their copies, or None on the
    CPU)."""
    if self.stream is None:
      return list(outs), None
    self.stream.wait_event(
        torch.cuda.current_stream(self.device).record_event())
    hosts = []
    with torch.cuda.stream(self.stream):
      for o in outs:
        h = pinned_empty(o.shape, o.dtype)
        h.copy_(o, non_blocking=True)
        o.record_stream(self.stream)
        hosts.append(h)
    return hosts, self.stream.record_event()


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


# --------------------------------------------------------------------------
# DLPack interop (taichi_image_tpu/types.py:148-194).
#
# The reference borrows torch tensors zero-copy throughout (types.py:29-49,
# camera_isp.py:83-84) so camera drivers hand over GPU buffers without a
# copy. In the port the package's array is the tensor itself, so these are
# the port's side of the same protocol: any producer (a JAX or numpy
# array, cupy, a tensor) comes in through DLPack, sharing its memory when
# it lies on a device torch can address.
# --------------------------------------------------------------------------


def from_dlpack(x) -> torch.Tensor:
  """Import any DLPack-capable array (a JAX or numpy array, a tensor) as a
  tensor, sharing its memory. Accepts an object implementing
  ``__dlpack__`` or a legacy DLPack capsule."""
  return torch.from_dlpack(x)


def to_dlpack(x) -> torch.Tensor:
  """Export through DLPack: a tensor implements ``__dlpack__`` itself, so
  ``jnp.from_dlpack(to_dlpack(t))`` or ``np.from_dlpack`` borrows its
  buffer (anything else goes through :func:`as_tensor`)."""
  return as_tensor(x)


def to_torch(x) -> torch.Tensor:
  """A tensor as it is; any other DLPack producer through
  :func:`from_dlpack` (sharing memory)."""
  return x if isinstance(x, torch.Tensor) else from_dlpack(x)


def from_torch(x: torch.Tensor) -> torch.Tensor:
  """The port's arrays are tensors: a tensor is taken as it is."""
  if not isinstance(x, torch.Tensor):
    raise TypeError(f"from_torch takes a torch.Tensor, got {type(x)}")
  return x
