"""M: the EMA metering update and the tonemaps' scalar vectors
(``csrc/meter.cu``, one instantiation per dtype of the sample).

Replaces what XLA fuses around the TPU kernels in the JAX step:
``metering_update_ca`` (``taichi_image_tpu/models/camera_isp.py:996-1025``)
and the map's scalar vector, ``reinhard_scal`` / ``reinhard_scal_ca``
(``taichi_image_tpu/ops/pallas/reinhard.py:52-76``, "computed in XLA"),
plus the linear tonemap's ``[m0, 1 / (m1 - m0)]``. :func:`meter` takes the
(N, C, hs, ws) metering sample (C >= 3, any strides: the stencil's sample,
the resize route's strided view, ``x12[:, 0:3]``'s, a gather, the band
loop's joined samples) and the previous vec9 and returns the new vec9,
the map's (6,) or (10,) scalars and the linear (2,) ones, all on the
device and without a host sync: one cooperative launch, or the split
form's three (bounds, stats, finalize) on a device whose SMs cannot hold
the plan's grid at once; under a process group the split form with the
collectives between its launches (the all_reduce MAX of ``[-min, max]``
after the bounds; the all_reduce MAX of the log bounds and SUM of the
five sums after the stats). The two forms give the same bits.
:func:`plan` is the launches' partition, a function of the sample's shape
and dtype alone. :func:`vectors` computes the two vectors alone from
metrics the caller holds (``meter_vectors``).

The plain twins are the torch code the port ran before (about 52 device
operations a step): :func:`metering_update_plain`, :func:`reinhard_scal`,
:func:`reinhard_scal_ca` and :func:`linear_scal`. They run for CPU tensors
and under ``backend="plain"``; on a CUDA tensor the wrappers launch the
kernels or raise.

vec9 layout: [bounds.min, bounds.max, log_bounds.min, log_bounds.max,
log_mean, mean, rgb_mean(3)].
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from taichi_image_tpu_torch.ops import hopper
from taichi_image_tpu_torch.utils.bounds import lerp

__all__ = ["Metering", "Plan", "meter", "meter_plain",
           "metering_update_plain", "plan", "reinhard_scal",
           "reinhard_scal_ca", "linear_scal", "vectors", "vectors_plain"]

# The launch plan (csrc/meter.cu): blocks of THREADS threads, at most
# MAX_GRID of them, which is BLOCKS_PER_SM on each of PLAN_SMS SMs (an
# H100 PCIe's). A grid within BLOCKS_PER_SM on each of the device's SMs is
# co-resident, so one cooperative launch can hold a grid barrier: every
# plan on a whole H100; a device with fewer SMs (a MIG slice) runs a
# larger grid in the split form. A block keeps its runs in shared memory
# for the second pass where they fit in CACHE_BYTES.
THREADS = 256
BLOCKS_PER_SM = 4
PLAN_SMS = 114
MAX_GRID = BLOCKS_PER_SM * PLAN_SMS
CACHE_BYTES = 40 * 1024
RUN_BYTES = 16  # a run: one 16-byte vector of a row of each channel
# the scratch: a 64-byte header of counters and the bounds' atomic keys,
# then 48 bytes of stats per block
SCRATCH_BYTES = 64 + MAX_GRID * 48

KERNELS = hopper.register_per_dtype(
    "meter", "meter.cu", "tit_meter",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
     ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
    dict.fromkeys(hopper.DTYPE_SUFFIX,
                  "taichi_image_tpu/models/camera_isp.py:996-1025"),
    defines={"TIT_METER_THREADS": THREADS, "TIT_METER_MAX_GRID": MAX_GRID,
             "TIT_METER_BLOCKS_PER_SM": BLOCKS_PER_SM,
             "TIT_METER_CACHE_BYTES": CACHE_BYTES})
VECTORS = hopper.register(
    "meter_vectors", "meter.cu", "tit_meter_vectors",
    [ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "taichi_image_tpu/ops/pallas/reinhard.py:52-76")

# the kernel's phases (csrc/meter.cu Phase): one cooperative launch, or
# the split form's bounds, stats and finalize
_FUSED, _BOUNDS, _STATS, _FINALIZE = 0, 1, 2, 3


class Plan(NamedTuple):
  """M's partition of a (N, C, hs, ws) sample: each row of each image is
  cut into runs of ``run`` pixels (the last may be shorter), block b owns
  runs [b per_block, (b + 1) per_block) in (n, y, x) order and its thread
  t the runs t, t + THREADS, ... of those."""
  run: int        # pixels of a run: 16 bytes of the dtype
  runs: int       # runs of the sample: n hs ceil(ws / run)
  per_block: int  # runs of a block
  grid: int       # blocks
  cached: bool    # the second pass reads the runs from shared memory


def plan(shape, dtype: torch.dtype) -> Plan:
  """The launch plan of a sample of ``shape`` (N, C, hs, ws) and
  ``dtype``: a function of these alone (not of the strides or the card),
  so a view and its copy, the band loop's joined samples and the whole
  frame's, and the two forms on any device are reduced in the same order.
  A block takes at least THREADS runs, and the grid at most MAX_GRID
  blocks."""
  n, _, hs, ws = (int(v) for v in shape)
  run = RUN_BYTES // dtype.itemsize
  runs = n * hs * -(-ws // run)
  per_block = max(THREADS, -(-runs // MAX_GRID))
  return Plan(run, runs, per_block, -(-runs // per_block),
              3 * per_block * RUN_BYTES <= CACHE_BYTES)


class Metering(NamedTuple):
  """One metering update: the new vec9 (9,), the map's scalars (6,), or
  (10,) with color_adapt, and the linear tonemap's [m0, inv_range] (2,);
  f32 on the sample's device."""
  metrics: torch.Tensor
  scal: torch.Tensor
  lin: torch.Tensor


# --------------------------------------------------------------------------
# The plain twins.
# --------------------------------------------------------------------------

def _scalar(v: float, device) -> torch.Tensor:
  """A 0-d f32 tensor made on ``device`` by a fill (no host-to-device
  copy, so no stream sync)."""
  return torch.full((), float(v), dtype=torch.float32, device=device)


def _min_max(lo: torch.Tensor, hi: torch.Tensor, group) -> torch.Tensor:
  """``[lo, hi]``; with a process ``group``, the min of ``lo`` and the max
  of ``hi`` over its ranks, as one all_reduce MAX of ``[-lo, hi]`` (the
  negation is exact)."""
  if group is None:
    return torch.stack([lo, hi])
  v = torch.stack([-lo, hi])
  dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
  return torch.stack([-v[0], v[1]])


def metering_update_plain(x: torch.Tensor, prev: torch.Tensor, t,
                          group=None, n_total: Optional[int] = None):
  """Plain PyTorch twin of M's vec9: global bounds -> blend with prev ->
  normalized stats over the blended bounds -> blend the whole vec9 with
  prev (taichi_image_tpu camera_isp.py:996-1025). With a process
  ``group`` the bounds, the log bounds and the five sums are reduced over
  it (three all_reduce calls) and the sums divided by ``n_total``.

  The five sums are taken in f64 and rounded once to f32, as the kernel
  takes them, and divided by ``n_total`` in IEEE f32 (a 0-d tensor: on
  CUDA torch turns a division by a Python number into a multiplication
  by its reciprocal). So the kernel's vec9 is its twin's, where f32 sums
  in two orders would differ in their last bits and move the map's bf16
  rounding of a few pixels (the JAX package sums in f32: within its f32
  rounding of this)."""
  x = x.to(torch.float32)
  b = lerp(t, _min_max(x.amin(), x.amax(), group), prev[:2])
  scaled = (x - b[0]) / (b[1] - b[0] + 1e-6)
  r, g, bch = scaled[:, 0], scaled[:, 1], scaled[:, 2]
  gray = 0.299 * r + 0.587 * g + 0.114 * bch
  log_gray = torch.log(torch.clamp_min(gray, 1e-4))
  sums = torch.stack([v.sum(dtype=torch.float64)
                      for v in (log_gray, gray, r, g, bch)]).to(torch.float32)
  log_bounds = _min_max(log_gray.amin(), log_gray.amax(), group)
  if group is not None:
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
  if n_total is None:
    n_total = x.shape[0] * x.shape[2] * x.shape[3]
  stats = torch.cat([b, log_bounds, sums / _scalar(n_total, x.device)])
  return lerp(t, stats, prev)


def reinhard_scal(metrics: torch.Tensor, intensity: float,
                  light_adapt: float) -> torch.Tensor:
  """(6,) f32 on ``metrics``' device: [m0, range, map_key, mean,
  exp(-intensity), light_adapt]."""
  m = metrics.to(torch.float32)
  key = (m[3] - m[4]) / (m[3] - m[2])
  map_key = 0.3 + 0.7 * torch.pow(key, 1.4)
  eni = torch.exp(_scalar(-float(intensity), m.device))
  return torch.stack([m[0], m[1] - m[0], map_key, m[5], eni,
                      _scalar(light_adapt, m.device)])


def reinhard_scal_ca(metrics: torch.Tensor, intensity: float,
                     light_adapt: float, color_adapt: float) -> torch.Tensor:
  """(10,) f32: reinhard_scal's six plus [color_adapt, cmean_r, cmean_g,
  cmean_b], cmean_c = lerp(color_adapt, mean, channel_mean_c)."""
  m = metrics.to(torch.float32)
  base = reinhard_scal(m, intensity, light_adapt)
  ca = _scalar(color_adapt, m.device)
  cmean = m[5] + ca * (m[6:9] - m[5])
  return torch.cat([base, ca[None], cmean])


def linear_scal(metrics: torch.Tensor) -> torch.Tensor:
  """(2,) f32 [m0, inv_range = 1 / (m1 - m0)] on ``metrics``' device (no
  host sync)."""
  m = metrics.to(torch.float32)
  return torch.stack([m[0], 1.0 / (m[1] - m[0])])


def _ca_mode(color_adapt) -> bool:
  return float(color_adapt) != 0.0


def vectors_plain(metrics: torch.Tensor, intensity, light_adapt,
                  color_adapt):
  """Plain twin of :func:`vectors`: ``(scal, lin)``."""
  scal = (reinhard_scal_ca(metrics, intensity, light_adapt, color_adapt)
          if _ca_mode(color_adapt)
          else reinhard_scal(metrics, intensity, light_adapt))
  return scal, linear_scal(metrics)


def meter_plain(x: torch.Tensor, prev: torch.Tensor, t, intensity=1.0,
                light_adapt=1.0, color_adapt=0.0, group=None,
                n_total: Optional[int] = None) -> Metering:
  """Plain PyTorch twin of M: :func:`metering_update_plain`, then the
  vectors of the new vec9."""
  m = metering_update_plain(x, prev, t, group, n_total)
  return Metering(m, *vectors_plain(m, intensity, light_adapt, color_adapt))


# --------------------------------------------------------------------------
# The kernels.
# --------------------------------------------------------------------------

# {(device, stream): the zeroed scratch}: the kernel's block counters
# return to 0 after every launch, so one buffer serves every launch on its
# stream (launches on one stream run in order) and no step runs a memset
_SCRATCH: dict = {}


def _scratch(device: torch.device) -> torch.Tensor:
  key = (device, hopper.stream_of(device))
  buf = _SCRATCH.get(key)
  if buf is None:
    buf = _SCRATCH[key] = torch.zeros(SCRATCH_BYTES, dtype=torch.uint8,
                                      device=device)
  return buf


# {(shape, strides, dtype): (launch block, its pointer, the plan's grid)}:
# the launcher's shape-dependent arguments, made once a layout
# (csrc/meter.cu Launch)
_LAUNCH_BLOCKS: dict = {}
_LAUNCH_BLOCKS_MAX = 64


def _launch_block(x: torch.Tensor) -> tuple[ctypes.c_void_p, int]:
  """The host block the launcher reads (the shape, the strides in
  elements and :func:`plan`'s per_block, grid and cached, as 11 int64s)
  and the plan's grid."""
  key = (x.shape, x.stride(), x.dtype)
  hit = _LAUNCH_BLOCKS.get(key)
  if hit is None:
    if len(_LAUNCH_BLOCKS) >= _LAUNCH_BLOCKS_MAX:
      _LAUNCH_BLOCKS.pop(next(iter(_LAUNCH_BLOCKS)))
    p = plan(x.shape, x.dtype)
    block = np.array([*x.shape, *x.stride(), p.per_block, p.grid,
                      int(p.cached)], dtype=np.int64)
    hit = _LAUNCH_BLOCKS[key] = (block,
                                 block.ctypes.data_as(ctypes.c_void_p),
                                 p.grid)
  return hit[1], hit[2]


# {device index: its SMs}
_SMS: dict = {}


def _sms(device: torch.device) -> int:
  """The SMs of the CUDA ``device`` (the current device where it names
  no index), asked once a device index: the SMs of its MIG slice on a
  partitioned card."""
  index = torch.cuda.current_device() if device.index is None else device.index
  n = _SMS.get(index)
  if n is None:
    n = _SMS[index] = (torch.cuda.get_device_properties(index)
                       .multi_processor_count)
  return n


def _t_arg(t, device):
  """The EMA weight as the kernel takes it: ``(None, t)`` for a host
  number (or a CPU tensor), ``(0-d f32 device tensor, 0.0)`` for a device
  tensor, read on the device with no host sync."""
  if torch.is_tensor(t):
    if t.device.type == "cpu":
      return None, float(t)
    return t.to(device=device, dtype=torch.float32).reshape(()), 0.0
  return None, float(t)


def _check_sample(x: torch.Tensor) -> None:
  if x.ndim != 4 or x.shape[1] < 3:
    raise ValueError(f"the metering sample must be (N, C >= 3, hs, ws), got "
                     f"{tuple(x.shape)}")
  if x.numel() == 0:
    raise ValueError(f"the metering sample is empty: {tuple(x.shape)}")
  if x.shape[0] * x.shape[2] * x.shape[3] >= 2 ** 31:
    raise ValueError(f"the metering sample {tuple(x.shape)} has 2**31 "
                     "pixels or more (the kernel indexes them in 32 bits)")


def meter(x: torch.Tensor, prev, t, intensity=1.0, light_adapt=1.0,
          color_adapt=0.0, group=None, n_total: Optional[int] = None,
          backend: str = "auto") -> Metering:
  """One EMA metering update from the (N, C, hs, ws) sample ``x`` (C >= 3,
  any strides; bf16, f16 or f32 run their instantiation as they lie, any
  other dtype its f32 values), ``prev`` (9,) and the weight ``t`` (a host
  number or a 0-d device tensor): :class:`Metering` with the map's
  scalars for ``intensity``, ``light_adapt`` and ``color_adapt`` (10 with
  color_adapt != 0) and the linear ones.

  Without a group this is one cooperative launch where the plan's grid
  is co-resident on ``x``'s device (BLOCKS_PER_SM on each of its SMs),
  else the split form's three launches, with the same bits. With a
  ``torch.distributed`` process ``group`` (the JAX package's
  ``axis_name``) ``x`` is this rank's part of the sample: the split form,
  with the bounds, log bounds and sums reduced over the group (three
  all_reduce calls) and the sums divided by ``n_total``, the sample's
  pixel count over every rank. Without a group ``n_total`` defaults to
  ``x``'s own count."""
  _check_sample(x)
  prev = torch.as_tensor(prev, dtype=torch.float32, device=x.device)
  if prev.shape != (9,):
    raise ValueError(f"prev must be (9,), got {tuple(prev.shape)}")
  if torch.is_tensor(t) and t.numel() != 1:
    raise ValueError(f"t must be a scalar, got shape {tuple(t.shape)}")
  if n_total is not None and int(n_total) < 1:
    raise ValueError(f"n_total must be >= 1, got {n_total}")
  if not hopper.use_kernel(backend, x):
    return meter_plain(x, prev, t, intensity, light_adapt, color_adapt,
                       group, n_total)
  dev = x.device
  if x.dtype not in hopper.DTYPE_SUFFIX:
    x = x.to(torch.float32)
  prev = prev.contiguous()
  if n_total is None:
    n_total = x.shape[0] * x.shape[2] * x.shape[3]
  t_dev, t_val = _t_arg(t, dev)
  out = torch.empty(21, dtype=torch.float32, device=dev)
  ca_mode = _ca_mode(color_adapt)
  kernel = KERNELS[x.dtype]
  block, grid = _launch_block(x)
  head = (hopper.ptr(x), block, hopper.ptr(prev),
          None if t_dev is None else hopper.ptr(t_dev), t_val,
          hopper.ptr(_scratch(dev)))
  tail = (hopper.ptr(out), float(n_total), float(intensity),
          float(light_adapt), float(color_adapt), int(ca_mode))

  if group is None and grid <= BLOCKS_PER_SM * _sms(dev):
    kernel.launch(dev, *head, None, None, None, *tail, _FUSED)
  else:
    _split(kernel, dev, head, tail, group)
  return Metering(out[0:9], out[9:19 if ca_mode else 15], out[19:21])


def _split(kernel: hopper.Kernel, dev: torch.device, head, tail,
           group) -> None:
  """M's split form: the bounds, stats and finalize launches on one set
  of exchange buffers, with a process ``group``'s all_reduce calls
  between them. The kernels share the cooperative launch's partition,
  reductions and finalize, so without a group (or with one rank) they
  give its bits."""
  mm = torch.empty(2, dtype=torch.float32, device=dev)
  lb = torch.empty(2, dtype=torch.float32, device=dev)
  sums = torch.empty(5, dtype=torch.float32, device=dev)
  exchange = (hopper.ptr(mm), hopper.ptr(lb), hopper.ptr(sums))
  kernel.launch(dev, *head, *exchange, *tail, _BOUNDS)
  if group is not None:
    dist.all_reduce(mm, op=dist.ReduceOp.MAX, group=group)
  kernel.launch(dev, *head, *exchange, *tail, _STATS)
  if group is not None:
    dist.all_reduce(lb, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
  kernel.launch(dev, *head, *exchange, *tail, _FINALIZE)


def vectors(metrics: torch.Tensor, intensity=1.0, light_adapt=1.0,
            color_adapt=0.0, backend: str = "auto"):
  """The map's scalars ((6,), or (10,) with color_adapt != 0) and the
  linear tonemap's (2,) from a vec9 the caller holds: ``(scal, lin)``, f32
  on its device (``meter_vectors``, one thread)."""
  if not torch.is_tensor(metrics) or metrics.shape != (9,):
    raise ValueError("metrics must be a (9,) tensor, got "
                     f"{getattr(metrics, 'shape', type(metrics))}")
  if not hopper.use_kernel(backend, metrics):
    return vectors_plain(metrics, intensity, light_adapt, color_adapt)
  dev = metrics.device
  m = metrics.to(torch.float32).contiguous()
  out = torch.empty(12, dtype=torch.float32, device=dev)
  ca_mode = _ca_mode(color_adapt)
  VECTORS.launch(dev, hopper.ptr(m), float(intensity), float(light_adapt),
                 float(color_adapt), int(ca_mode), hopper.ptr(out))
  return out[0:10 if ca_mode else 6], out[10:12]
