"""Multi-camera ISP step on PyTorch: RAW -> demosaic (+WB/CCM) ->
[resize] -> EMA metering -> Reinhard or linear tonemap -> [transform] ->
planar u8 RGB or planar I420, and the reference's per-image API over it.

Counterpart of ``taichi_image_tpu/models/camera_isp.py``: every route of
``fused_isp_step`` with any raw format (packed12, packed16, u16, f16,
f32), RGB or I420 output, for all three classes: CameraBF16 (bf16),
Camera16 (f16) and Camera32 (f32). On a CUDA device each route is
hand-written Hopper kernels, each instantiated for the working dtype T. The phase
route (no resize):

  K1<T> decode   (N, H, 1.5W) u8     -> phases (N, 4, H/2, W/2) T
                 (packed16: K1's packed16 mode; u16/f16/f32 CFAs: the
                 CFA split, ops/hopper/decode.py)
  K2<T> stencil  phases              -> x12 (N, 12, H/2, W/2) T
                                        + metering sample (N, 3, ., .) T
  M<T> meter     sample, prev vec9   -> new vec9 + the map's scalars +
                                        the linear ones (f32, on device;
                                        two launches)
  K3<T> map      x12, scal           -> p T + per-image max of the f32 p
  K4<T> finish   p, max              -> planar u8 (N, 3, H, W), or (W, H)
                                        under a transform that swaps axes

The linear tonemap skips K3: K4's linear mode reads x12 with M's [m0,
1/(m1-m0)]. An odd metering stride samples the planar image's pixels
from x12 through a cached index (``planar_subsample``). The resize route
runs K2 without the sample, K12<T> to planar (N, 3, h', w'), M on its
stride grid (a strided view, read in place), K3<T> on the planar image,
then P<T> (``finish_planar_tone``): the gamma (or the linear tonemap)
and the transform in one pass, where the JAX package leaves them to
XLA; with I420 output one kernel does that tail and the conversion
(``yuv420_planar_tone``). K7, the JAX package's front-fused stencil
and map in one kernel, is not a route of the step: it is reached through
``demosaic_reinhard_front`` alone, whatever the environment holds.

``color_format="yuv420"`` gives planar I420 ``(Y (N, h', w'), VU (N, 2,
h'/2, w'/2))`` u8, V then U, as the JAX package computes it: on the phase
route K4's I420 mode replaces K4 (the u8 RGB is never written); the
resize route tones, transforms and converts K3's planar p (or the
resized image) in one kernel, the planar I420 tonemap form, and the
odd-stride route converts K4's planar u8 RGB with the planar I420
kernel (both in ``ops/hopper/yuv420.py``).

Camera16 has the semantics of the JAX package's strict f16 route, which
its TPU-only q16 route is held to (tests/test_q16.py): phases, x12 and p
materialized in f16. The q16 containers are not carried over; they exist
because the TPU's Mosaic toolchain cannot load or store f16
(taichi_image_tpu/ops/pallas/q16.py:7-13), and Hopper can.

Frames under 4x4 pixels demosaic through the JAX package's own route
for them (``ops/bayer._demosaic_denominator``, torch on the device); the
kernels after it take phase planes one row or one column wide.

No step syncs with the host: M's vectors feed the kernels as device
tensors, and the resize taps and sample indices are made on the device
once per configuration. ``backend="plain"`` runs every stage's plain
twin, the metering's too. vec9 layout: [bounds.min, bounds.max,
log_bounds.min, log_bounds.max, log_mean, mean, rgb_mean(3)]. Under
``TAICHI_IMAGE_TPU_DEBUG`` the step checks its decoded values and metrics
(``utils/debug.py``), which reads them on the host.

The per-image API (``load_*`` -> ``update_metering`` -> ``tonemap_*``,
``resize_image``, ``process_stream``) hands out :class:`PlanarImage`
handles. The loaders are lazy: a list of unforced handles of one
configuration runs as one ``fused_isp_step`` (bitwise ``process`` on the
concatenated raws); a mixed list takes the staged path, whose phase-form
batches run K3 and K4 as the step does.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.ops import bayer as bayer_ops
from taichi_image_tpu_torch.ops import hopper, interpolate
from taichi_image_tpu_torch.ops.bayer import (
    demosaic_phases, phases_to_planar, planar_from_phases_transformed,
    subsample_hw)
from taichi_image_tpu_torch.ops.color import rgb_gray
from taichi_image_tpu_torch.ops.bayer import (  # noqa: F401
    transform_phases as _transform_phases)
from taichi_image_tpu_torch.ops.hopper import decode as hopper_decode
from taichi_image_tpu_torch.ops.hopper import finish as hopper_finish
from taichi_image_tpu_torch.ops.hopper import front_fused as hopper_front
from taichi_image_tpu_torch.ops.hopper import meter as hopper_meter
from taichi_image_tpu_torch.ops.hopper import reinhard as hopper_reinhard
from taichi_image_tpu_torch.ops.hopper import resize as hopper_resize
from taichi_image_tpu_torch.ops.hopper import yuv420 as hopper_yuv420
# the JAX package's names for the I420 math of the phase route
from taichi_image_tpu_torch.ops.hopper.yuv420 import (  # noqa: F401
    yuv420_from_phases_u8, yuv420_phases_dot_bf16 as _yuv420_phases_dot_bf16,
    yuv420_w6 as _yuv420_w6)
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.utils import debug as debug_util
from taichi_image_tpu_torch.utils import profiling
from taichi_image_tpu_torch.utils.bounds import lerp

__all__ = ["camera_isp", "Camera16", "Camera32", "CameraBF16", "default_cc",
           "PlanarImage", "moving_average", "metering_update",
           "reinhard_apply", "linear_apply",
           "fused_isp_step", "load_raw_phases", "metering_update_ca",
           "reinhard_map_ca", "reinhard_map_max_ca", "reinhard_gamma_ca",
           "reinhard_apply_ca", "linear_apply_ca", "demosaic_reinhard_front",
           "planar_from_phases_transformed", "state_from_jax",
           "yuv420_from_phases_u8", "yuv420_from_planar_u8"]

# Default 3x3 color-correction matrix (taichi_image_tpu camera_isp.py:208).
default_cc = np.array([
    [1.75, -0.25, -0.30],
    [-0.10, 1.40, -0.30],
    [-0.05, -0.55, 2.10],
])

_DEFAULT_WB = np.array([1.8, 1.0, 2.1])


# --------------------------------------------------------------------------
# The per-image API's image handle and module functions.
# --------------------------------------------------------------------------

class PlanarImage:
  """Image handle of the per-image (reference) API.

  The reference's loaders hand out interleaved (H, W, 3) images; this
  handle keeps the image on the ISP's device in the step's own forms and
  presents the reference's layout only at the host boundary
  (``np.asarray(img)``, the one conversion to host):

  - phase form: the 12-channel phase-RGB ``(12, H/2, W/2)`` of the
    working dtype, what the loaders make without a resize;
  - planar form: ``(C, H, W)``, what a resize or a tonemap makes;
  - lazy: the captured raw ``(1, H, W_raw)`` and the loader's
    configuration, decoded on first use; a batch consumer
    (``update_metering``, ``tonemap_*``) decodes every unforced handle of
    one configuration in one batch, and forcing one handle decodes just
    that image, to the same values;
  - a slice of a batch that a consumer made (``_batch``: form, the
    (N, ...) tensor, the index), sliced out only when forced.

  ``.planar`` gives the device tensor (C, H, W). A bf16 image comes to
  the host as float32 (numpy has no bfloat16).
  """

  __slots__ = ("_planar", "_phases", "_lazy", "_batch")

  def __init__(self, planar=None, phases=None, lazy=None, batch=None):
    if sum(x is not None for x in (planar, phases, lazy, batch)) != 1:
      raise ValueError("exactly one of planar/phases/lazy/batch")
    self._planar = planar
    self._phases = phases
    self._lazy = lazy      # (raws1, fmt, ids_format, work_dtype,
    #                         pattern, cc, resize_plan)
    self._batch = batch    # (form, (N, ...) tensor, index)

  def _force(self):
    """Materialize device storage into _planar/_phases (idempotent)."""
    if self._planar is None and self._phases is None:
      if self._batch is not None:
        form, arr, i = self._batch
        if form == "phases":
          self._phases = arr[i]
        else:
          self._planar = arr[i]
        self._batch = None
      else:
        raws1, fmt, ids, wd, pattern, cc, plan = self._lazy
        out = _jit_load_planar(raws1, fmt, ids, wd, pattern, cc, plan)
        if plan is None:
          self._phases = out[0]
        else:
          self._planar = out[0]
        self._lazy = None
    return self

  @property
  def shape(self):
    """(H, W, C), known without forcing."""
    if self._lazy is not None:
      raws1, fmt, _, _, _, _, plan = self._lazy
      if plan is not None:
        (w_out, h_out), _ = plan
        return (h_out, w_out, 3)
      return (raws1.shape[-2], decoded_width(fmt, raws1.shape[-1]), 3)
    if self._batch is not None:
      form, arr, _ = self._batch
      if form == "phases":
        _, _, hh, wh = arr.shape
        return (2 * hh, 2 * wh, 3)
      _, c, h, w = arr.shape
      return (h, w, c)
    if self._planar is not None:
      c, h, w = self._planar.shape
      return (h, w, c)
    _, hh, wh = self._phases.shape
    return (2 * hh, 2 * wh, 3)

  @property
  def dtype(self) -> torch.dtype:
    if self._lazy is not None:
      return types.canonical_dtype(self._lazy[3])
    if self._batch is not None:
      return self._batch[1].dtype
    a = self._planar if self._planar is not None else self._phases
    return a.dtype

  @property
  def planar(self) -> torch.Tensor:
    """The device planar (C, H, W) image (a phase-form handle is
    interleaved on the device)."""
    self._force()
    if self._planar is None:
      return phases_to_planar(self._phases[None])[0]
    return self._planar

  def __array__(self, dtype=None, copy=None):
    self._force()
    t = self._planar if self._planar is not None else self._phases
    if t.dtype == torch.bfloat16:
      t = t.to(torch.float32)
    x = t.cpu().numpy()
    if self._planar is not None:
      a = np.moveaxis(x, 0, -1)
    else:
      # the host interleave: (pc, pr, c, hh, wh) -> (hh, pr, wh, pc, c)
      _, hh, wh = x.shape
      a = (x.reshape(2, 2, 3, hh, wh).transpose(3, 1, 4, 0, 2)
           .reshape(2 * hh, 2 * wh, 3))
    if dtype is not None:
      a = a.astype(dtype, copy=False)
    return np.array(a, copy=True) if copy else a

  def block_until_ready(self):
    """Force the handle and wait for the device to finish it."""
    self._force()
    t = self._planar if self._planar is not None else self._phases
    if t.is_cuda:
      torch.cuda.current_stream(t.device).synchronize()
    return self

  def __repr__(self):
    if self._lazy is not None:
      form = "lazy"
    elif self._batch is not None:
      form = f"batch[{self._batch[2]}]/{self._batch[0]}"
    else:
      form = "planar" if self._planar is not None else "phases"
    return (f"PlanarImage(hwc_shape={self.shape}, dtype={self.dtype}, "
            f"form={form})")


def _to_planar(im, device=None) -> torch.Tensor:
  """Image handle, tensor or array (H, W, C) -> planar (C, H, W) tensor
  (on ``device`` when given)."""
  if isinstance(im, PlanarImage):
    return im.planar
  x = _as_tensor(im)
  if device is not None:
    x = x.to(device)
  if x.ndim == 3 and x.shape[-1] in (1, 3, 4):
    return x.movedim(-1, 0)
  raise ValueError(f"expected an (H, W, C) image or PlanarImage, got "
                   f"shape {tuple(x.shape)}")


def _as_tensor(x) -> torch.Tensor:
  """:func:`types.as_tensor`, float64 arrays as float32 (as
  ``jnp.asarray`` takes them)."""
  if not isinstance(x, torch.Tensor) and np.asarray(x).dtype == np.float64:
    x = np.asarray(x, np.float32)
  return types.as_tensor(x)


def _on_device(x, device: torch.device) -> torch.Tensor:
  """:func:`_as_tensor` of ``x`` on ``device``; a tensor already there is
  returned as it is, without a call into torch (the lazy loaders run once
  per camera and step)."""
  x = _as_tensor(x)
  if x.device.type == device.type and device.index in (None,
                                                       x.device.index):
    return x
  return types.to_device(x, device)


def moving_average(old, new, alpha):
  """Host EMA helper."""
  if old is None:
    return new
  return (1 - alpha) * old + alpha * new


def metering_update(images: torch.Tensor, prev: torch.Tensor, t,
                    n_total: Optional[int] = None) -> torch.Tensor:
  """One EMA metering update from a batch of strided RGB crops, channels
  last (N, h, w, 3): global bounds -> blend with prev -> normalized stats
  over the blended bounds -> blend the whole vec9 with prev."""
  x = images.to(torch.float32)
  b = lerp(t, torch.stack([x.amin(), x.amax()]), prev[:2])
  scaled = (x - b[0]) / (b[1] - b[0] + 1e-6)
  gray = rgb_gray(scaled)
  log_gray = torch.log(torch.clamp_min(gray, 1e-4))
  sums = torch.stack([log_gray.sum(), gray.sum(),
                      *[scaled[..., c].sum() for c in range(3)]])
  if n_total is None:
    n_total = images.shape[0] * images.shape[1] * images.shape[2]
  stats = torch.cat([b, torch.stack([log_gray.amin(), log_gray.amax()]),
                     sums / n_total])
  return lerp(t, stats, prev)


def _static_one(v) -> bool:
  """Whether ``v`` is the Python float 1.0 (the specialisation the JAX
  package takes for a static gamma of 1)."""
  return isinstance(v, float) and v == 1.0


def _gamma_pow(x: torch.Tensor, gamma: float) -> torch.Tensor:
  """``x ** (1 / gamma)`` as exp2(log2(x) * f32(1 / gamma))."""
  return torch.exp2(torch.log2(x) * float(np.float32(1.0 / gamma)))


def reinhard_apply(image: torch.Tensor, metrics: torch.Tensor, gamma,
                   intensity, light_adapt, color_adapt,
                   work_dtype) -> torch.Tensor:
  """The ISP's Reinhard on a channels-last image (..., H, W, 3):
  normalize by the EMA image bounds, the Reinhard map, then the gamma
  over the image's own max, to u8 (leading dims are images)."""
  m = metrics.to(torch.float32)
  key = (m[3] - m[4]) / (m[3] - m[2])
  map_key = 0.3 + 0.7 * torch.pow(key, 1.4)
  x = image.to(torch.float32)
  scaled = (x - m[0]) / (m[1] - m[0])
  gray = rgb_gray(scaled)[..., None]
  eni = torch.exp(torch.tensor(-float(intensity), dtype=torch.float32,
                               device=x.device))
  if isinstance(color_adapt, float) and color_adapt == 0.0:
    adapt_mean = lerp(light_adapt, m[5], gray)
  else:
    mean = lerp(color_adapt, m[5], m[6:9])
    adapt_mean = lerp(light_adapt, mean, lerp(color_adapt, gray, scaled))
  adapt = torch.pow(eni * adapt_mean, map_key)
  p = scaled * (1.0 / (adapt + scaled))
  p = torch.where(torch.isnan(p), 0.0, p)
  p_cast = p.to(types.canonical_dtype(work_dtype))
  max_out = torch.clamp_min(p.amax(dim=(-3, -2, -1), keepdim=True), 1e-6)
  out = p_cast.to(torch.float32) / max_out
  if not _static_one(gamma):
    out = _gamma_pow(out, gamma)
  return torch.clamp(255.0 * out, 0, 255).to(torch.uint8)


def linear_apply(image: torch.Tensor, metrics: torch.Tensor,
                 gamma) -> torch.Tensor:
  """The ISP's linear tonemap, elementwise on any layout, to u8."""
  x = image.to(torch.float32)
  m = metrics.to(torch.float32)
  inv_range = 1.0 / (m[1] - m[0])
  y = torch.clamp_min((x - m[0]) * inv_range, 0.0)
  if not _static_one(gamma):
    y = _gamma_pow(y, gamma)
  return torch.clamp(torch.clamp(y, 0.0, 1.0) * 255.0, 0,
                     255).to(torch.uint8)


# --------------------------------------------------------------------------
# Functional core.
# --------------------------------------------------------------------------

def decoded_width(fmt: str, w_raw: int) -> int:
  """Decoded pixel width of a raw plane whose last dim is ``w_raw``
  (bytes for the packed formats, elements otherwise)."""
  if fmt == "packed12":
    return w_raw * 2 // 3
  return w_raw // 2 if fmt == "packed16" else w_raw


# the unpacked formats and the CFA dtypes each takes
_CFA_DTYPES = {"u16": (torch.uint16,),
               "f16": (torch.float16, torch.float32),
               "f32": (torch.float16, torch.float32)}


def load_raw_phases(raws: torch.Tensor, fmt: str, work_dtype,
                    ids_format: bool = False,
                    backend: str = "auto") -> torch.Tensor:
  """Decode a raw batch to normalized CFA phase planes (N, 4, H/2, W/2)
  in the working dtype: K1 for packed12, K1's packed16 mode for packed16
  (little-endian u16 bytes), the CFA split for an unpacked u16 (over
  65535), f16 or f32 CFA (cast). ``ids_format`` concerns packed12 only."""
  wd = types.canonical_dtype(work_dtype)
  if fmt == "packed12":
    return hopper_decode.decode12_phases(raws, ids_format, wd,
                                         backend=backend)
  if fmt == "packed16":
    return hopper_decode.decode16_phases(raws, wd, backend=backend)
  if fmt in _CFA_DTYPES:
    if raws.dtype not in _CFA_DTYPES[fmt]:
      raise ValueError(f"{fmt} raws must be of "
                       f"{' or '.join(map(str, _CFA_DTYPES[fmt]))}, got "
                       f"{raws.dtype}")
    return hopper_decode.split_phases(raws, wd, backend=backend)
  raise ValueError(f"unknown raw format {fmt}")


def _decode_checked(raws, fmt, wd, ids_format, backend):
  """:func:`load_raw_phases`, and under TAICHI_IMAGE_TPU_DEBUG the check
  that the packed and u16 formats decoded into [0, 1]."""
  phases = load_raw_phases(raws, fmt, wd, ids_format, backend=backend)
  if debug_util.debug_enabled() and fmt in ("packed12", "packed16", "u16"):
    debug_util.check_decoded(phases)
  return phases


def _meter(strided: torch.Tensor, prev: torch.Tensor, t, group=None,
           n_total: Optional[int] = None, intensity=1.0, light_adapt=1.0,
           color_adapt=0.0, backend: str = "auto") -> hopper_meter.Metering:
  """M (``ops/hopper/meter.py``): the new metrics and the tonemaps'
  vectors; under TAICHI_IMAGE_TPU_DEBUG the check that the new metrics
  are finite."""
  m = hopper_meter.meter(strided, prev, t, intensity, light_adapt,
                         color_adapt, group=group, n_total=n_total,
                         backend=backend)
  if debug_util.debug_enabled():
    debug_util.check_metrics(m.metrics)
  return m


def metering_update_ca(x: torch.Tensor, prev: torch.Tensor, t, group=None,
                       n_total: Optional[int] = None, backend: str = "auto"):
  """EMA metering update from an (N, 3, hs, ws) sample: global bounds ->
  blend with prev -> normalized stats over the blended bounds -> blend
  the whole vec9 with prev (taichi_image_tpu camera_isp.py:996-1025); M
  on CUDA, its plain twin on the CPU.

  With a ``torch.distributed`` process ``group`` (the JAX package's
  ``axis_name``) ``x`` is this rank's part of the sample: the bounds, the
  log bounds and the five sums are reduced over the group (three
  all_reduce calls) and the sums divided by ``n_total``, the sample's
  pixel count over every rank. Without a group ``n_total`` defaults to
  ``x``'s own count."""
  return hopper_meter.meter(x, prev, t, group=group, n_total=n_total,
                            backend=backend).metrics


def _map_scal(metrics, intensity, light_adapt, color_adapt,
              backend: str = "auto"):
  """The map's scalars of metrics the caller holds (``meter_vectors`` on
  CUDA) and whether they are the color_adapt form."""
  scal, _ = hopper_meter.vectors(metrics, intensity, light_adapt,
                                 color_adapt, backend=backend)
  return scal, float(color_adapt) != 0.0


def reinhard_map_ca(x: torch.Tensor, metrics: torch.Tensor, intensity,
                    light_adapt, color_adapt) -> torch.Tensor:
  """The f32 pre-gamma Reinhard map of (N, 3k, hh, wh), NaN zeroed (K3's
  plain arithmetic, with the plain vectors)."""
  scal, ca_mode = _map_scal(metrics, intensity, light_adapt, color_adapt,
                            backend="plain")
  return hopper_reinhard.reinhard_map_f32(x, scal, ca_mode)


def reinhard_map_max_ca(x: torch.Tensor, metrics: torch.Tensor, intensity,
                        light_adapt, color_adapt, work_dtype,
                        backend: str = "auto", scal=None):
  """Map stage (K3): ``(p in the working dtype, per-image max of the f32
  p (N, 1, 1, 1))`` for (N, 3k, hh, wh) input of that dtype. ``scal`` is
  M's map vector for these arguments; without it the vector is made from
  ``metrics``."""
  wd = types.canonical_dtype(work_dtype)
  if x.dtype != wd:
    raise ValueError(f"map input is {x.dtype}, the working dtype {wd}")
  ca_mode = float(color_adapt) != 0.0
  if scal is None:
    scal, _ = _map_scal(metrics, intensity, light_adapt, color_adapt,
                        backend=backend)
  return hopper_reinhard.reinhard_map(x, scal, ca_mode, backend=backend)


# What one launch of P takes of an image seen as (3, 1, m), and of images:
# it indexes an image's values in 32 bits and puts its 3 planes on grid.z.
_TONE_VALUES = 3 * (1 << 28)
_TONE_IMAGES = 65535 // 3


def _tone_any(x: torch.Tensor, scal: torch.Tensor, gamma, mode: str,
              backend: str = "auto") -> torch.Tensor:
  """The tone alone on any layout whose images hold 3m values: P with no
  transform on the images seen as (N, 3, 1, m) (the tone is per value,
  its max per image; the linear one has no per-image part, so the whole
  tensor is one such image). u8 of ``x``'s shape.

  A dtype other than the kernels' goes in as its f32 values (the twins'
  first step), as does a max or linear vector of another dtype than f32.
  A tensor beyond one launch's extent runs as several, on parts of at
  most ``_TONE_IMAGES`` images of ``_TONE_VALUES`` values, each with its
  images' max."""
  if x.numel() == 0:
    return torch.empty(x.shape, dtype=torch.uint8, device=x.device)
  if x.dtype not in hopper.DTYPE_SUFFIX:
    x = x.to(torch.float32)
  scal = scal.to(torch.float32)
  n = x.shape[0] if mode == "reinhard" else 1
  flat = x.reshape(n, -1)
  if mode == "reinhard":
    scal = scal.reshape(-1)
  rows = []
  for i in range(0, n, _TONE_IMAGES):
    s = scal[i:i + _TONE_IMAGES] if mode == "reinhard" else scal
    row = [hopper_finish.finish_planar_tone(
        part.reshape(part.shape[0], 3, 1, -1), s, gamma, mode,
        backend=backend).reshape(part.shape)
           for part in flat[i:i + _TONE_IMAGES].split(_TONE_VALUES, dim=1)]
    rows.append(row[0] if len(row) == 1 else torch.cat(row, dim=1))
  out = rows[0] if len(rows) == 1 else torch.cat(rows)
  return out.reshape(x.shape)


def reinhard_gamma_ca(p_cast: torch.Tensor, max_out: torch.Tensor,
                      gamma: float, backend: str = "auto") -> torch.Tensor:
  """Gamma stage on any (N, 3k, ...) layout: u8 of ``p_cast``'s shape."""
  return _tone_any(p_cast, max_out, gamma, "reinhard", backend)


def reinhard_apply_ca(x: torch.Tensor, metrics: torch.Tensor, gamma,
                      intensity, light_adapt, color_adapt, work_dtype,
                      backend: str = "auto") -> torch.Tensor:
  """Reinhard on any (N, 3k, h, w) layout (the resize route's planar
  image): K3 map + per-image max, then the gamma stage -> u8 of x's
  shape."""
  p_cast, max_out = reinhard_map_max_ca(x, metrics, intensity, light_adapt,
                                        color_adapt, work_dtype,
                                        backend=backend)
  return reinhard_gamma_ca(p_cast, max_out, gamma, backend)


def linear_apply_ca(x: torch.Tensor, metrics: torch.Tensor, gamma,
                    backend: str = "auto") -> torch.Tensor:
  """The linear tonemap on any (N, 3k, ...) layout (the JAX package's XLA
  elementwise chain): the linear vector of ``metrics``, then P's tone."""
  _, lin = hopper_meter.vectors(metrics, backend=backend)
  return _tone_any(x, lin, gamma, "linear", backend)


def demosaic_reinhard_front(phases: torch.Tensor, metrics: torch.Tensor,
                            intensity, light_adapt, pattern, cc,
                            backend: str = "auto", scal=None):
  """Front-fused demosaic + Reinhard map (K7, bf16): ``(p (N, 12, hh, wh)
  bf16, per-image max (N, 1, 1, 1))`` from the phase planes, with metrics
  computed beforehand (from ``ops/bayer.demosaic_samples``); ``scal`` is
  M's map vector, else it is made from ``metrics``."""
  _, _, hh, wh = phases.shape
  weights = bayer_ops._demosaic_tables(pattern, "mhc")
  fin = bayer_ops._finish_spec_for(pattern, "mhc", hh, wh,
                                   None if cc is None else tuple(cc),
                                   types.bf16)
  if scal is None:
    scal, _ = _map_scal(metrics, intensity, light_adapt, 0.0,
                        backend=backend)
  return hopper_front.front_fused(phases, weights, fin, scal,
                                  backend=backend)


def _plan_scales(h_in, w_in, size, scale):
  """(scale_y, scale_x) of a resize plan, by the resize API's rule."""
  return interpolate._norm_scale_hw(h_in, w_in, size, scale)


def _resize_taps(hh, wh, size, scale, device):
  sy, sx = _plan_scales(2 * hh, 2 * wh, size, scale)
  return hopper_resize.resize_taps(hh, wh, (int(size[0]), int(size[1])),
                                   (float(sy), float(sx)), device)


def _resize_from_phases(x12: torch.Tensor, size, scale,
                        work_dtype) -> torch.Tensor:
  """Bilinear resize from 12-channel phase form (N, 12, hh, wh) -> planar
  (N, 3, h_out, w_out): K12's plain twin, the JAX package's gather
  formulation."""
  _, _, hh, wh = x12.shape
  taps = _resize_taps(hh, wh, size, scale, x12.device)
  return hopper_resize.resize_x12_plain(x12, taps,
                                        types.canonical_dtype(work_dtype))


def _resize_x12(x12: torch.Tensor, size, scale, work_dtype,
                backend: str = "auto") -> torch.Tensor:
  """The resize stage (K12): x12 of the working dtype -> planar
  (N, 3, h_out, w_out) of that dtype."""
  wd = types.canonical_dtype(work_dtype)
  if x12.dtype != wd:
    raise ValueError(f"resize input is {x12.dtype}, the working dtype {wd}")
  _, _, hh, wh = x12.shape
  taps = _resize_taps(hh, wh, size, scale, x12.device)
  return hopper_resize.resize_x12(x12, taps, backend=backend)


def _resize_any(x12: torch.Tensor, size, scale,
                work_dtype) -> torch.Tensor:
  """K12 on phases of any dtype: the working dtype's instantiation, else
  (phases another class made) K12<f32> on their exact f32 values and one
  cast, as the JAX package's gather route computes in f32 and casts
  once."""
  wd = types.canonical_dtype(work_dtype)
  if x12.dtype == wd:
    return _resize_x12(x12, size, scale, wd)
  return _resize_x12(x12.to(torch.float32), size, scale,
                     torch.float32).to(wd)


def _resize_planar(images: torch.Tensor, size, scale,
                   work_dtype) -> torch.Tensor:
  """Bilinear resize on planar (N, 3, H, W) with the reference's
  sampling (rows, then columns, in f32)."""
  w_out, h_out = size
  sy, sx = _plan_scales(images.shape[2], images.shape[3], size, scale)
  return interpolate.bilinear_axes(images, h_out, w_out, sy, sx, 2, 3).to(
      types.canonical_dtype(work_dtype))


def _transform_planar(images: torch.Tensor,
                      t: ImageTransform) -> torch.Tensor:
  """ImageTransform on planar (N, C, H, W) spatial dims (a view)."""
  return interpolate.transform_axes(images, t, 2, 3)


def yuv420_from_planar_u8(out: torch.Tensor, backend: str = "auto"):
  """Tonemapped planar u8 RGB (N, 3, H, W), H and W even -> planar I420
  u8 ``(Y (N, H, W), VU (N, 2, H/2, W/2))``: the matrix per pixel on the
  channel-reversed vector, the 2x2 block mean, ``min(1, x)``, V then U
  (the planar I420 kernel)."""
  return hopper_yuv420.yuv420_planar(out, backend=backend)


def _finish(x12, scal, gamma, mode, transform, color_format, backend):
  """K4 on phase form: transformed planar u8 RGB, or with
  ``color_format="yuv420"`` its I420 mode's ``(Y, VU)``."""
  if color_format == "yuv420":
    return hopper_finish.finish_yuv420(x12, scal, gamma, mode, transform,
                                       backend=backend)
  return hopper_finish.finish_planar_u8(x12, scal, gamma, mode, transform,
                                        backend=backend)


def fused_isp_step(raws: torch.Tensor, prev: torch.Tensor, t, gamma,
                   intensity, light_adapt, color_adapt, fmt, ids_format,
                   work_dtype, pattern, cc, resize_plan, stride, transform,
                   tonemap, color_format: str = "rgb",
                   backend: str = "auto", group=None,
                   n_total: Optional[int] = None):
  """One ISP step over a camera batch: ``(new_metrics (9,) f32, planar
  u8 (N, 3, h', w'))``, or with ``color_format="yuv420"`` ``(new_metrics,
  (Y (N, h', w'), VU (N, 2, h'/2, w'/2)))``. Arguments as in the JAX
  ``fused_isp_step``; ``backend`` ("auto" | "kernel" | "plain") routes
  every kernel stage. ``group`` and ``n_total`` are the JAX step's
  ``axis_name`` and ``n_total``: ``raws`` is this rank's share of the
  cameras of a batch split over the ranks of the ``torch.distributed``
  group, and the metering is reduced over it (:func:`metering_update_ca`);
  each image's max stays its own."""
  if color_format not in ("rgb", "yuv420"):
    raise ValueError(f"unknown color_format {color_format!r}")
  if tonemap not in ("reinhard", "linear"):
    raise ValueError(f"unknown tonemap {tonemap}")
  if color_format == "yuv420" and resize_plan is not None:
    # the only route whose output dims can be odd: refuse before any work
    w_out, h_out = resize_plan[0]
    hopper_yuv420.check_even(
        *interpolate.transformed_size((w_out, h_out), transform)[::-1])
  wd = types.canonical_dtype(work_dtype)
  # the tracer's stage spans, each ending where the next begins; ``stage``
  # is None while tracing is off (utils/profiling.py)
  with profiling.stages() as stage:
    if stage:
      stage("isp.decode")
    phases = _decode_checked(raws, fmt, wd, ids_format, backend)

    def meter(sample):
      if stage:
        stage("isp.meter")
      return _meter(sample, prev, t, group, n_total, intensity, light_adapt,
                    color_adapt, backend)

    if stage:
      stage("isp.demosaic")
    if resize_plan is not None:
      x12 = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd,
                            backend=backend)
      if stage:
        stage("isp.resize")
      size, scale = resize_plan
      src = _resize_x12(x12, size, scale, wd, backend=backend)
      mt = meter(subsample_hw(src, stride, stride))
      phase_format = None
    elif stride % 2 != 0:
      # the samples of an odd stride fall on every phase: gather them from
      # x12 (the planar image's pixels); the tonemap stays in phase form,
      # since the map is per pixel and the max runs over the same pixels
      src = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd,
                            backend=backend)
      mt = meter(bayer_ops.planar_subsample(src, stride))
      # an odd stride's I420 is the JAX package's planar conversion (the
      # matrix before the block mean) of the RGB
      phase_format = "rgb"
    else:
      # full-res stride-s pixels are exactly phase (0, 0) at half-res s/2
      src, strided = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd,
                                     backend=backend,
                                     sample_step=max(stride // 2, 1))
      mt = meter(strided)
      phase_format = color_format
    if tonemap == "reinhard":
      if stage:
        stage("isp.reinhard")
      src, scal = reinhard_map_max_ca(src, mt.metrics, intensity,
                                      light_adapt, color_adapt, wd,
                                      backend=backend, scal=mt.scal)
    else:
      scal = mt.lin
    if stage:
      stage("isp.finish")
    if phase_format is None:
      # the resize route: the tonemap and the transform in one kernel (P),
      # and I420 with them in another
      if color_format == "yuv420":
        return mt.metrics, hopper_yuv420.yuv420_planar_tone(
            src, scal, gamma, tonemap, transform, backend=backend)
      return mt.metrics, hopper_finish.finish_planar_tone(
          src, scal, gamma, tonemap, transform, backend=backend)
    # K3 + K4, or K4's linear mode; the transform lives in K4's stores
    out = _finish(src, scal, gamma, tonemap, transform, phase_format,
                  backend)
    if phase_format != color_format:
      out = yuv420_from_planar_u8(out, backend=backend)
    return mt.metrics, out


def state_from_jax(state: dict) -> dict:
  """The JAX ISP's ``state_dict()`` (numpy arrays) -> a dict of torch
  tensors that :meth:`_ISPBase.load_state` accepts (absent or None
  entries are left out)."""
  out = {}
  if state.get("metrics") is not None:
    out["metrics"] = torch.from_numpy(
        np.array(state["metrics"], np.float32, copy=True))
  if state.get("white_balance") is not None:
    out["white_balance"] = torch.from_numpy(
        np.array(state["white_balance"], np.float64, copy=True))
  return out


# --------------------------------------------------------------------------
# ISP class.
# --------------------------------------------------------------------------

# pinned upload buffers of an ISP whose process_stream has not sized them
# (process_stream's default prefetch of 2, plus 2)
_RING = 4


class _ISPBase:
  """Per-rig ISP configuration + the vec9 EMA metering state (a (9,) f32
  tensor on ``device``), driving :func:`fused_isp_step` per frame set."""

  _work_dtype: torch.dtype = None  # set by camera_isp()

  def __init__(self,
               bayer_pattern: bayer_ops.BayerPattern,
               scale: Optional[float] = None,
               resize_width: int = 0,
               moving_alpha: float = 0.1,
               correct_colors: bool = False,
               white_balance: np.ndarray = _DEFAULT_WB,
               color_correction: np.ndarray = default_cc,
               transform: ImageTransform = ImageTransform.none,
               device="cuda",
               metering_stride: int = 8):
    if scale is not None and resize_width != 0:
      raise ValueError("Cannot specify both scale and resize_width")
    self.bayer_pattern = bayer_pattern
    self.moving_alpha = moving_alpha
    self.scale = scale
    self.resize_width = resize_width
    self.transform = transform
    self.metering_stride = metering_stride
    self.correct_colors = correct_colors
    self.white_balance = np.asarray(white_balance, np.float64)
    self.color_correction = np.asarray(color_correction, np.float64)
    self.metrics = None
    self.device = torch.device(device)
    self._uploader = None
    # the ids of the sets this instance processes while tracing is on
    self._sets = itertools.count()

  def set(self, moving_alpha: Optional[float] = None,
          resize_width: Optional[int] = None,
          scale: Optional[float] = None,
          correct_colors: Optional[bool] = None,
          white_balance: Optional[np.ndarray] = None,
          color_correction: Optional[np.ndarray] = None,
          transform: Optional[ImageTransform] = None):
    """Runtime reconfiguration."""
    if moving_alpha is not None:
      self.moving_alpha = moving_alpha
    if resize_width is not None:
      self.resize_width = resize_width
      self.scale = None
    if scale is not None:
      self.scale = scale
      self.resize_width = 0
    if transform is not None:
      self.transform = transform
    if correct_colors is not None:
      self.correct_colors = correct_colors
    if white_balance is not None:
      self.white_balance = np.asarray(white_balance, np.float64)
    if color_correction is not None:
      self.color_correction = np.asarray(color_correction, np.float64)

  @property
  def color_correct_matrix(self) -> Optional[np.ndarray]:
    """CCM with the white-balance gains folded into its columns."""
    if self.correct_colors:
      cc = self.color_correction.copy()
      cc[:, :3] *= self.white_balance
      return cc
    return None

  def _cc_tuple(self):
    cc = self.color_correct_matrix
    if cc is None:
      return None
    return tuple(np.asarray(cc, np.float32).flatten().tolist())

  def _resize_plan(self, h: int, w: int):
    """(output_size, scale) or None."""
    if self.resize_width > 0:
      scale = self.resize_width / w
      return (self.resize_width, round(h * scale)), scale
    if self.scale is not None:
      return (round(w * self.scale), round(h * self.scale)), self.scale
    return None

  def _resize_plan_key(self, raws, fmt: str):
    """The resize plan of a raw (batch) of ``fmt``."""
    return self._resize_plan(raws.shape[-2],
                             decoded_width(fmt, raws.shape[-1]))

  def _prev_t(self):
    """(prev, t) of the next EMA update: zeros and 0 before the first."""
    if self.metrics is None:
      return torch.zeros(9, dtype=torch.float32, device=self.device), 0.0
    return self.metrics, 1.0 - self.moving_alpha

  # -- the per-image API: images, batches, loaders ------------------------

  def resize_image(self, image) -> PlanarImage:
    """The rig's resize policy on one RGB image (a :class:`PlanarImage`
    or an (H, W, C) array); returns a :class:`PlanarImage`."""
    plan = self._resize_plan(image.shape[0], image.shape[1])
    if plan is None:
      return (image if isinstance(image, PlanarImage)
              else PlanarImage(_to_planar(image, self.device)))
    size, scale = plan
    if isinstance(image, PlanarImage):
      image._force()
    if isinstance(image, PlanarImage) and image._phases is not None:
      return PlanarImage(_resize_any(image._phases[None], size, scale,
                                     self._work_dtype)[0])
    return PlanarImage(_resize_planar(
        _to_planar(image, self.device)[None], size, scale,
        self._work_dtype)[0])

  def metering_images(self, images: List, t: float, prev,
                      stride: int = 8) -> torch.Tensor:
    """One metering update over strided crops of the images; returns the
    new vec9 and leaves ``prev`` and the ISP's state as they were."""
    form, batch = self._batch_of(images, stride)
    prev = (prev.to(self.device, torch.float32).clone()
            if torch.is_tensor(prev) else torch.tensor(
                np.asarray(prev, np.float32), device=self.device))
    fn = (_jit_metering_phases if form == "phases"
          else _jit_metering_planar)
    return fn(batch, prev, float(t), stride).metrics

  @staticmethod
  def _lazy_key(images):
    """The shared loader arguments when every image is an unforced lazy
    handle of one raw shape and configuration, else None."""
    if not images or not all(
        isinstance(im, PlanarImage) and im._lazy is not None
        for im in images):
      return None
    key = images[0]._lazy[1:]
    shape = images[0]._lazy[0].shape
    if all(im._lazy[1:] == key and im._lazy[0].shape == shape
           for im in images):
      return key
    return None

  @staticmethod
  def _shared_batch(images):
    """(form, batch) when the handles are exactly the slices of one batch
    tensor in order (a batch consumer's output), else None: that batch is
    used as it is, not stacked again."""
    if not images or not all(
        isinstance(im, PlanarImage) and im._batch is not None
        for im in images):
      return None
    form, arr, _ = images[0]._batch
    if arr.shape[0] == len(images) and all(
        im._batch[1] is arr and im._batch[0] == form
        and im._batch[2] == i for i, im in enumerate(images)):
      return form, arr
    return None

  def _batch_of(self, images: List, stride: int):
    """A device batch of the images: ('phases', (N, 12, hh, wh)) where
    the phase form serves (an even metering stride), else ('planar',
    (N, C, H, W)). Unforced lazy handles of one configuration decode as
    one batch (and become its slices); the slices of one batch are used
    as they are."""
    key = self._lazy_key(images)
    if key is not None:
      raws = torch.cat([im._lazy[0] for im in images])
      out = _jit_load_planar(raws, *key)
      form = "phases" if key[-1] is None else "planar"
      for i, im in enumerate(images):
        im._batch = (form, out, i)
        im._lazy = None
    else:
      shared = self._shared_batch(images)
      if shared is not None:
        form, out = shared
      else:
        for im in images:
          if isinstance(im, PlanarImage):
            im._force()
        if (images and all(isinstance(im, PlanarImage)
                           and im._phases is not None for im in images)):
          form, out = "phases", torch.stack([im._phases for im in images])
        else:
          form, out = "planar", torch.stack(
              [_to_planar(im, self.device) for im in images])
    if form == "phases" and stride % 2 != 0:
      # an odd stride's samples fall on every phase: interleave once
      return "planar", phases_to_planar(out)
    return form, out

  def _stack_batch(self, images):
    """:meth:`_batch_of` at the ISP's metering stride."""
    return self._batch_of(images, self.metering_stride)

  def _load_one(self, raws1: torch.Tensor, fmt: str,
                ids_format: bool = False) -> PlanarImage:
    """A lazy handle: the raw and the loader's configuration as it is now
    (a later ``set`` does not change an image already loaded)."""
    return PlanarImage(lazy=(raws1, fmt, bool(ids_format), self._work_dtype,
                             self.bayer_pattern, self._cc_tuple(),
                             self._resize_plan_key(raws1, fmt)))

  def _load(self, image, fmt: str, ids_format: bool = False):
    image = _on_device(image, self.device)
    debug_util.validate_raw(image, fmt, batch=False)
    return self._load_one(image[None], fmt, ids_format)

  def load_packed12(self, image_data, ids_format: bool = False):
    """A packed 12-bit plane (H, 1.5W) u8 -> an image of the working
    dtype (lazy)."""
    return self._load(image_data, "packed12", ids_format)

  def load_packed16(self, image_data):
    """A packed 16-bit plane (H, 2W) u8, little-endian -> an image."""
    return self._load(image_data, "packed16")

  def load_16u(self, image):
    """A u16 CFA (H, W) -> an image (values over 65535)."""
    return self._load(image, "u16")

  def load_16f(self, image):
    """An f16 CFA (H, W) -> an image (values as they are)."""
    return self._load(image, "f16")

  def load_32f(self, image):
    """An f32 CFA (H, W) -> an image (values as they are)."""
    return self._load(image, "f32")

  # -- white balance, metering, tonemaps ------------------------------------

  def auto_white_balance(self, strength: float = 1.0,
                         max_gain: float = 8.0) -> np.ndarray:
    """Gray-world auto white balance from the EMA metering state: the
    gains that bring the bounds-scaled channel means (vec9[6:9]) to the
    green mean are multiplied into ``white_balance`` (green stays 1),
    damped by ``strength`` (gains**strength), clamped to [1/max_gain,
    max_gain] and quantized to 1/256. A feedback loop: the means are
    measured after the WB/CCM fold, which applies with
    ``correct_colors=True``. One host read of the metrics. Returns the
    new white_balance; raises before any frame was metered."""
    if self.metrics is None:
      raise ValueError("auto_white_balance needs metering state — "
                       "process at least one frame set first")
    means = self.metrics[6:9].cpu().numpy().astype(np.float64)
    if not np.isfinite(means).all() or (means <= 1e-6).any():
      raise ValueError(f"degenerate channel means {means} — scene too "
                       "dark or metering not seeded")
    gains = (means[1] / means) ** float(strength)
    wb = self.white_balance * gains
    wb = wb / wb[1]  # G == 1 first, then the clamp
    wb = np.clip(wb, 1.0 / max_gain, max_gain)
    self.white_balance = np.round(wb * 256.0) / 256.0
    return self.white_balance

  def state_dict(self):
    """Serializable state (numpy): the vec9 EMA metering vector and the
    white-balance gains — the same keys as the JAX ISP's."""
    return {"metrics": None if self.metrics is None
            else self.metrics.detach().cpu().numpy(),
            "white_balance": np.asarray(self.white_balance)}

  def load_state(self, state):
    """Accepts this class's ``state_dict()``, the JAX ISP's, or
    :func:`state_from_jax` of it: the stream continues mid-EMA."""
    m = state.get("metrics")
    self.metrics = (None if m is None else
                    torch.as_tensor(np.asarray(m, np.float32)
                                    if not torch.is_tensor(m) else m)
                    .to(device=self.device, dtype=torch.float32).clone())
    wb = state.get("white_balance")
    if wb is not None:
      self.white_balance = np.asarray(
          wb.cpu().numpy() if torch.is_tensor(wb) else wb, np.float64)

  def update_metering(self, images: List):
    """The EMA metering update over strided crops of all cameras' images
    (the first call seeds it with t = 0)."""
    form, batch = self._stack_batch(images)
    self._update_metering_batch(form, batch)

  def _update_metering_batch(self, form: str, batch: torch.Tensor,
                             intensity=1.0, light_adapt=1.0,
                             color_adapt=0.0) -> hopper_meter.Metering:
    """M over the batch: the new metrics become the ISP's; returns them
    with the tonemaps' vectors for these arguments."""
    prev, t = self._prev_t()
    fn = (_jit_metering_phases if form == "phases"
          else _jit_metering_planar)
    mt = fn(batch, prev, t, self.metering_stride, intensity, light_adapt,
            color_adapt)
    self.metrics = mt.metrics
    return mt

  def _metrics_tensor(self, metrics) -> torch.Tensor:
    if torch.is_tensor(metrics):
      return metrics.to(self.device, torch.float32)
    return torch.tensor(np.asarray(metrics, np.float32), device=self.device)

  def tonemap_only(self, image, metrics, gamma, intensity, light_adapt,
                   color_adapt) -> PlanarImage:
    """Tonemap one image with the given metrics (Reinhard, the rig's
    transform), no metering update."""
    metrics = self._metrics_tensor(metrics)
    args = (float(gamma), float(intensity), float(light_adapt),
            float(color_adapt), self._work_dtype, self.transform)
    if isinstance(image, PlanarImage):
      image._force()
    if isinstance(image, PlanarImage) and image._phases is not None:
      out = _jit_reinhard_phases(image._phases[None], metrics, *args)
    else:
      out = _jit_reinhard_planar(_to_planar(image, self.device)[None],
                                 metrics, *args)
    return PlanarImage(out[0])

  def tonemap_reinhard(self, images: List, gamma: float = 1.0,
                       intensity: float = 1.0, light_adapt: float = 1.0,
                       color_adapt: float = 0.0) -> List[PlanarImage]:
    """The metering update over all images, then each one's Reinhard and
    the rig's transform; u8 planar handles."""
    out = self._tonemap_fused_lazy(images, "reinhard", float(gamma),
                                   float(intensity), float(light_adapt),
                                   float(color_adapt))
    if out is not None:
      return out
    form, batch = self._stack_batch(images)
    mt = self._update_metering_batch(form, batch, float(intensity),
                                     float(light_adapt), float(color_adapt))
    fn = (_jit_reinhard_phases if form == "phases"
          else _jit_reinhard_planar)
    out = fn(batch, self.metrics, float(gamma), float(intensity),
             float(light_adapt), float(color_adapt), self._work_dtype,
             self.transform, scal=mt.scal)
    return [PlanarImage(o) for o in out]

  def tonemap_linear(self, images: List,
                     gamma: float = 1.0) -> List[PlanarImage]:
    """The metering update, then each image's linear tonemap and the
    rig's transform."""
    out = self._tonemap_fused_lazy(images, "linear", float(gamma))
    if out is not None:
      return out
    form, batch = self._stack_batch(images)
    mt = self._update_metering_batch(form, batch)
    fn = (_jit_linear_phases if form == "phases"
          else _jit_linear_planar)
    out = fn(batch, float(gamma), self.transform, mt.lin)
    return [PlanarImage(o) for o in out]

  def _tonemap_fused_lazy(self, images, tonemap, gamma, intensity=1.0,
                          light_adapt=1.0, color_adapt=0.0):
    """The reference's call pattern (load every camera, then one tonemap
    over the list) as one step: when every image is an unforced lazy
    handle of one configuration, their raws concatenated run through
    :func:`fused_isp_step` with the loaders' captured arguments, bitwise
    ``process`` on the same raws. None for a mixed list (the staged path
    takes it). The inputs stay lazy."""
    key = self._lazy_key(images)
    if key is None:
      return None
    fmt, ids, wd, pattern, cc, plan = key
    raws = torch.cat([im._lazy[0] for im in images])
    prev, t = self._prev_t()
    self.metrics, out = fused_isp_step(
        raws, prev, t, gamma, intensity, light_adapt, color_adapt, fmt,
        ids, wd, pattern, cc, plan, self.metering_stride, self.transform,
        tonemap)
    return [PlanarImage(batch=("planar", out, i))
            for i in range(len(images))]

  def process(self, raws, fmt: str = "packed12", ids_format: bool = False,
              gamma: float = 1.0, intensity: float = 1.0,
              light_adapt: float = 1.0, color_adapt: float = 0.0,
              tonemap: str = "reinhard", layout: str = "planar",
              color_format: str = "rgb"):
    """Whole-rig step: decode -> demosaic+WB/CCM -> the rig's resize ->
    metering EMA -> Reinhard or linear tonemap -> the rig's transform ->
    u8, updating the EMA state.

    ``raws``: (n_cameras, H, W_bytes) uint8, a tensor or numpy array
    (moved to the ISP's device: on CUDA a host set goes up through the
    ISP's pinned ring, :meth:`_upload`, so the call returns without
    waiting for the steps in flight). Returns planar (n, 3, h', w') u8 on
    the device, or with ``layout='hwc'`` a host numpy (n, h', w', 3)
    array, which waits for the step. ``color_format='yuv420'`` returns
    planar I420 ``(Y, VU)`` u8 on the device instead (``layout`` ignored;
    even output dims required).
    """
    with profiling.span("isp.process", self._sets, self.device):
      raws = self._upload(raws)
      debug_util.validate_raw(raws, fmt)
      prev, t = self._prev_t()
      plan = self._resize_plan_key(raws, fmt)
      new_metrics, out = fused_isp_step(
          raws, prev, t, float(gamma), float(intensity), float(light_adapt),
          float(color_adapt), fmt, ids_format, self._work_dtype,
          self.bayer_pattern, self._cc_tuple(), plan, self.metering_stride,
          self.transform, tonemap, color_format=color_format)
      self.metrics = new_metrics
      return _layout(out, color_format, layout)

  def process_large(self, raws, n_bands: int = 4, fmt: str = "packed12",
                    ids_format: bool = False, gamma: float = 1.0,
                    intensity: float = 1.0, light_adapt: float = 1.0,
                    color_adapt: float = 0.0, tonemap: str = "reinhard",
                    layout: str = "planar", color_format: str = "rgb",
                    driver: str = "auto"):
    """:meth:`process` for large frames (8K and up), with the rig's resize
    and transform and the same results: ``driver="auto"`` or ``"flat"``
    runs the whole-frame step, ``"loop"`` and ``"scan"`` the band loop
    over at least ``n_bands`` row bands (models/large.py)."""
    from taichi_image_tpu_torch.models import large
    with profiling.span("isp.process", self._sets, self.device):
      raws = _on_device(raws, self.device)
      debug_util.validate_raw(raws, fmt)
      prev, t = self._prev_t()
      new_metrics, out = large.process_banded(
          raws, prev, t, n_bands=n_bands, fmt=fmt, ids_format=ids_format,
          work_dtype=self._work_dtype, pattern=self.bayer_pattern,
          cc=self._cc_tuple(), stride=self.metering_stride,
          gamma=float(gamma), intensity=float(intensity),
          light_adapt=float(light_adapt), color_adapt=float(color_adapt),
          tonemap=tonemap, color_format=color_format,
          resize_plan=self._resize_plan_key(raws, fmt),
          transform=self.transform, driver=driver)
      self.metrics = new_metrics
      return _layout(out, color_format, layout)

  def _upload(self, raws) -> torch.Tensor:
    """``raws`` on the ISP's device. On CUDA a host set (numpy or a CPU
    tensor) is copied into the ISP's ring of pinned buffers
    (:class:`types.Uploader`, ``_RING`` buffers unless
    :meth:`process_stream` sized it) and sent on a copy stream that the
    step's stream waits on; anything else moves as :func:`_on_device`
    moves it."""
    if self.device.type != "cuda" or (isinstance(raws, torch.Tensor)
                                      and raws.device.type != "cpu"):
      return _on_device(raws, self.device)
    if self._uploader is None:
      self._uploader = types.Uploader(self.device, _RING)
    return self._uploader(raws)

  def process_stream(self, raw_iter, prefetch: int = 2, **kwargs):
    """Iterate raw frame batches through :meth:`process`, yielding the
    outputs in order with ``prefetch`` steps in flight: the host upload
    of set t+1 overlaps the device compute of set t, as the JAX driver's
    asynchronous dispatch does.

    On CUDA a host set goes up through a ring of ``prefetch + 2`` pinned
    buffers on a copy stream (:meth:`_upload`), and with
    ``layout="hwc"`` (RGB) each step's output comes down on a download
    stream into a pinned host tensor as soon as it is queued; the only
    wait is on that frame's own copy event, when it is yielded. The
    yielded array is the caller's: no later set writes into it. Planar
    RGB and I420 stay on the device. On the CPU the sets are used as
    they are. ``kwargs`` go to :meth:`process`."""
    layout = kwargs.pop("layout", "planar")
    to_host = layout == "hwc" and kwargs.get("color_format", "rgb") == "rgb"
    if self.device.type == "cuda" and (self._uploader is None or
                                       self._uploader.ring.n != prefetch + 2):
      if self._uploader is not None:
        self._uploader.ring.drain()
      self._uploader = types.Uploader(self.device, prefetch + 2)
    download = types.Downloader(self.device) if to_host else None

    def start(out):
      return download.start((out,)) if to_host else ((out,), None)

    def finish(item):
      (out,), copied = item
      if copied is not None:
        copied.synchronize()
      return np.moveaxis(out.numpy(), 1, -1) if to_host else out

    pending = deque()
    for raws in raw_iter:
      pending.append(start(self.process(raws, layout="planar", **kwargs)))
      if len(pending) > prefetch:
        yield finish(pending.popleft())
    while pending:
      yield finish(pending.popleft())


def _layout(out, color_format: str, layout: str):
  """A step's output as ``process`` returns it: the I420 pair as it is,
  planar RGB on the device, or with ``layout="hwc"`` a host (n, h, w, 3)
  array, fetched from CUDA with a blocking copy into a pinned host tensor
  (torch's caching host allocator reuses its block once the caller drops
  the array)."""
  if color_format == "rgb" and layout == "hwc":
    if out.device.type == "cuda":
      host = types.pinned_empty(out.shape, out.dtype)
      out = host.copy_(out)
    return np.moveaxis(out.numpy(), 1, -1)
  return out


# --------------------------------------------------------------------------
# The per-image API's batch stages (the JAX package's jitted helpers).
# --------------------------------------------------------------------------

def _jit_load_planar(raws, fmt, ids_format, work_dtype, pattern, cc,
                     resize_plan) -> torch.Tensor:
  """The loaders' batch: decode -> demosaic (+CCM) -> the resize: phase
  form x12 (N, 12, hh, wh) without a resize, else the resized planar
  (N, 3, h', w')."""
  wd = types.canonical_dtype(work_dtype)
  phases = _decode_checked(raws, fmt, wd, ids_format, "auto")
  x12 = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd)
  if resize_plan is not None:
    size, scale = resize_plan
    return _resize_x12(x12, size, scale, wd)
  return x12


def _jit_metering_planar(batch, prev, t, stride, intensity=1.0,
                         light_adapt=1.0, color_adapt=0.0
                         ) -> hopper_meter.Metering:
  # M reads the strided view in place
  return _meter(subsample_hw(batch, stride, stride), prev, t,
                intensity=intensity, light_adapt=light_adapt,
                color_adapt=color_adapt)


def _jit_metering_phases(x12, prev, t, stride, intensity=1.0,
                         light_adapt=1.0, color_adapt=0.0
                         ) -> hopper_meter.Metering:
  # full-res stride-s pixels are phase (0, 0)'s at half-res stride s / 2:
  # the stencil's own metering sample, a strided view of x12
  s = stride // 2
  return _meter(subsample_hw(x12[:, 0:3], s, s), prev, t,
                intensity=intensity, light_adapt=light_adapt,
                color_adapt=color_adapt)


def _map_max_any(x, metrics, intensity, light_adapt, color_adapt, wd,
                 scal=None):
  """K3's stage, ``(p of the working dtype, per-image max)``: the working
  dtype's instantiation, else (an image the caller made, of any dtype)
  K3<f32> on x's f32 values and one cast of p, as the JAX package maps in
  f32 and casts once. ``scal``: M's map vector, else made from
  ``metrics``."""
  x = x.contiguous()
  if x.dtype == wd:
    return reinhard_map_max_ca(x, metrics, intensity, light_adapt,
                               color_adapt, wd, scal=scal)
  p, max_out = reinhard_map_max_ca(x.to(torch.float32), metrics, intensity,
                                   light_adapt, color_adapt, torch.float32,
                                   scal=scal)
  return p.to(wd), max_out


def _jit_reinhard_planar(batch, metrics, gamma, intensity, light_adapt,
                         color_adapt, work_dtype, transform, scal=None):
  """The resize route's tail on a planar batch: K3, then P (the gamma,
  u8 and the transform in one pass)."""
  wd = types.canonical_dtype(work_dtype)
  p_cast, max_out = _map_max_any(batch, metrics, intensity, light_adapt,
                                 color_adapt, wd, scal)
  return hopper_finish.finish_planar_tone(p_cast, max_out, gamma,
                                          "reinhard", transform)


def _jit_linear_planar(batch, gamma, transform, lin):
  """P's linear mode on a planar batch with M's linear vector ``lin`` (an
  image of another dtype than the kernels' goes in as its f32 values)."""
  x = batch.contiguous()
  if x.dtype not in hopper.DTYPE_SUFFIX:
    x = x.to(torch.float32)
  return hopper_finish.finish_planar_tone(x, lin, gamma, "linear",
                                          transform)


def _jit_reinhard_phases(x12, metrics, gamma, intensity, light_adapt,
                         color_adapt, work_dtype, transform, scal=None):
  """The step's phase tail on a phase-form batch: K3, then K4 (the gamma,
  u8, the interleave and the transform in its stores)."""
  wd = types.canonical_dtype(work_dtype)
  p_cast, max_out = _map_max_any(x12, metrics, intensity, light_adapt,
                                 color_adapt, wd, scal)
  return _finish(p_cast, max_out, gamma, "reinhard", transform, "rgb",
                 "auto")


def _jit_linear_phases(x12, gamma, transform, lin):
  """K4's linear mode on a phase-form batch with M's linear vector."""
  return _finish(x12, lin, gamma, "linear", transform, "rgb", "auto")


def camera_isp(name: str, dtype=types.f32):
  """Class factory closing over a working dtype; the classes expose the
  channels-last tonemaps as ``reinhard_kernel`` and ``linear_kernel``,
  as the reference does."""
  cls = type(name, (_ISPBase,),
             {"_work_dtype": types.canonical_dtype(dtype)})
  cls.__qualname__ = name
  cls.__module__ = __name__
  cls.reinhard_kernel = staticmethod(reinhard_apply)
  cls.linear_kernel = staticmethod(linear_apply)
  return cls


# The three classes of the JAX package; each runs the ported main path
# through its own dtype's instantiations of K1-K4.
Camera16 = camera_isp("Camera16", types.f16)
Camera32 = camera_isp("Camera32", types.f32)
CameraBF16 = camera_isp("CameraBF16", types.bf16)
