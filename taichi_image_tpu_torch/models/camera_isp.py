"""Multi-camera ISP step on PyTorch: packed12 RAW -> demosaic (+WB/CCM)
-> [resize] -> EMA metering -> Reinhard or linear tonemap -> [transform]
-> planar u8 RGB or planar I420.

Counterpart of ``taichi_image_tpu/models/camera_isp.py``: every route of
``fused_isp_step`` with packed12 raws, RGB or I420 output, for all three
classes: CameraBF16 (bf16), Camera16 (f16) and Camera32 (f32). On a CUDA
device each route is hand-written Hopper kernels, each instantiated for
the working dtype T, plus the metering reduction in torch. The phase
route (no resize):

  K1<T> decode   (N, H, 1.5W) u8     -> phases (N, 4, H/2, W/2) T
  K2<T> stencil  phases              -> x12 (N, 12, H/2, W/2) T
                                        + metering sample (N, 3, ., .) T
  metering       sample, prev vec9   -> new vec9 (torch, f32, on device)
  K3<T> map      x12, scal(vec9)     -> p T + per-image max of the f32 p
  K4<T> finish   p, max              -> planar u8 (N, 3, H, W), or (W, H)
                                        under a transform that swaps axes

The linear tonemap skips K3: K4's linear mode reads x12 with [m0,
1/(m1-m0)] from the metrics. An odd metering stride samples the planar
image's pixels from x12 through a cached index (``planar_subsample``).
The resize route runs K2 without the sample, K12<T> to planar
(N, 3, h', w'), metering on its stride grid, K3<T> on the planar image,
then the gamma (or the linear tonemap) and the transform in torch, as
the JAX package leaves them to XLA; with I420 output one kernel does
that tail and the conversion (``yuv420_planar_tone``). The front-fused
route (bf16, Reinhard, color_adapt 0, no resize, even stride, opt-in
through ``TAICHI_IMAGE_TPU_FRONT_FUSED=1``, the variable the JAX package
reads) meters from ``demosaic_samples`` first and then runs K7, the
stencil and the map in one kernel, before K4.

``color_format="yuv420"`` gives planar I420 ``(Y (N, h', w'), VU (N, 2,
h'/2, w'/2))`` u8, V then U, as the JAX package computes it: on the phase
and front-fused routes K4's I420 mode replaces K4 (the u8 RGB is never
written); the resize route tones, transforms and converts K3's planar p
(or the resized image) in one kernel, the planar I420 tonemap form, and
the odd-stride route converts K4's planar u8 RGB with the planar I420
kernel (both in ``ops/hopper/yuv420.py``).

Camera16 has the semantics of the JAX package's strict f16 route, which
its TPU-only q16 route is held to (tests/test_q16.py): phases, x12 and p
materialized in f16. The q16 containers are not carried over; they exist
because the TPU's Mosaic toolchain cannot load or store f16
(taichi_image_tpu/ops/pallas/q16.py:7-13), and Hopper can.

No step syncs with the host: the metering vector feeds the kernels as a
device tensor, and the resize taps and sample indices are made on the
device once per configuration. vec9 layout: [bounds.min, bounds.max,
log_bounds.min, log_bounds.max, log_mean, mean, rgb_mean(3)].

Configurations outside the port (raw formats other than packed12, frames
under 4x4) raise ``NotImplementedError`` naming the ROADMAP.md item that
will port them; none is approximated.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.ops import bayer as bayer_ops
from taichi_image_tpu_torch.ops import interpolate
from taichi_image_tpu_torch.ops.bayer import (
    demosaic_phases, planar_from_phases_transformed, subsample_hw)
from taichi_image_tpu_torch.ops.bayer import (  # noqa: F401
    transform_phases as _transform_phases)
from taichi_image_tpu_torch.ops.hopper import decode as hopper_decode
from taichi_image_tpu_torch.ops.hopper import finish as hopper_finish
from taichi_image_tpu_torch.ops.hopper import front_fused as hopper_front
from taichi_image_tpu_torch.ops.hopper import reinhard as hopper_reinhard
from taichi_image_tpu_torch.ops.hopper import resize as hopper_resize
from taichi_image_tpu_torch.ops.hopper import yuv420 as hopper_yuv420
# the JAX package's names for the I420 math of the phase route
from taichi_image_tpu_torch.ops.hopper.yuv420 import (  # noqa: F401
    yuv420_from_phases_u8, yuv420_phases_dot_bf16 as _yuv420_phases_dot_bf16,
    yuv420_w6 as _yuv420_w6)
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.utils import debug as debug_util
from taichi_image_tpu_torch.utils.bounds import lerp

__all__ = ["camera_isp", "Camera16", "Camera32", "CameraBF16", "default_cc",
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


def _not_ported(what: str, item: int) -> NotImplementedError:
  return NotImplementedError(
      f"{what} is not in the PyTorch port yet (ROADMAP.md queue 1, "
      f"item {item})")


# --------------------------------------------------------------------------
# Functional core.
# --------------------------------------------------------------------------

def decoded_width(fmt: str, w_raw: int) -> int:
  """Decoded pixel width of a raw plane whose last dim is ``w_raw``
  (bytes for the packed formats, elements otherwise)."""
  return {"packed12": w_raw * 2 // 3, "packed16": w_raw // 2}.get(fmt,
                                                                  w_raw)


def load_raw_phases(raws: torch.Tensor, fmt: str, work_dtype,
                    ids_format: bool = False,
                    backend: str = "auto") -> torch.Tensor:
  """Decode a raw batch to normalized CFA phase planes (N, 4, H/2, W/2)
  in the working dtype (K1 for packed12)."""
  if fmt != "packed12":
    raise _not_ported(f"raw format {fmt!r}", 13)
  return hopper_decode.decode12_phases(raws, ids_format,
                                       types.canonical_dtype(work_dtype),
                                       backend=backend)


def metering_update_ca(x: torch.Tensor, prev: torch.Tensor, t):
  """EMA metering update from an (N, 3, hs, ws) sample: global bounds ->
  blend with prev -> normalized stats over the blended bounds -> blend
  the whole vec9 with prev (taichi_image_tpu camera_isp.py:996-1025)."""
  x = x.to(torch.float32)
  b = lerp(t, torch.stack([x.amin(), x.amax()]), prev[:2])
  scaled = (x - b[0]) / (b[1] - b[0] + 1e-6)
  r, g, bch = scaled[:, 0], scaled[:, 1], scaled[:, 2]
  gray = 0.299 * r + 0.587 * g + 0.114 * bch
  log_gray = torch.log(torch.clamp_min(gray, 1e-4))
  sums = torch.stack([log_gray.sum(), gray.sum(), r.sum(), g.sum(),
                      bch.sum()])
  n_total = x.shape[0] * x.shape[2] * x.shape[3]
  stats = torch.cat([b, torch.stack([log_gray.amin(), log_gray.amax()]),
                     sums / n_total])
  return lerp(t, stats, prev)


def _map_scal(metrics, intensity, light_adapt, color_adapt):
  ca_mode = float(color_adapt) != 0.0
  scal = (hopper_reinhard.reinhard_scal_ca(metrics, intensity, light_adapt,
                                           color_adapt)
          if ca_mode else
          hopper_reinhard.reinhard_scal(metrics, intensity, light_adapt))
  return scal, ca_mode


def reinhard_map_ca(x: torch.Tensor, metrics: torch.Tensor, intensity,
                    light_adapt, color_adapt) -> torch.Tensor:
  """The f32 pre-gamma Reinhard map of (N, 3k, hh, wh), NaN zeroed."""
  scal, ca_mode = _map_scal(metrics, intensity, light_adapt, color_adapt)
  return hopper_reinhard.reinhard_map_f32(x, scal, ca_mode)


def reinhard_map_max_ca(x: torch.Tensor, metrics: torch.Tensor, intensity,
                        light_adapt, color_adapt, work_dtype,
                        backend: str = "auto"):
  """Map stage (K3): ``(p in the working dtype, per-image max of the f32
  p (N, 1, 1, 1))`` for (N, 3k, hh, wh) input of that dtype."""
  wd = types.canonical_dtype(work_dtype)
  if x.dtype != wd:
    raise ValueError(f"map input is {x.dtype}, the working dtype {wd}")
  scal, ca_mode = _map_scal(metrics, intensity, light_adapt, color_adapt)
  return hopper_reinhard.reinhard_map(x, scal, ca_mode, backend=backend)


def reinhard_gamma_ca(p_cast: torch.Tensor, max_out: torch.Tensor,
                      gamma: float) -> torch.Tensor:
  """Gamma stage in phase layout: u8 of ``p_cast``'s shape."""
  return hopper_finish.gamma_u8(p_cast, max_out, gamma)


def reinhard_apply_ca(x: torch.Tensor, metrics: torch.Tensor, gamma,
                      intensity, light_adapt, color_adapt, work_dtype,
                      backend: str = "auto") -> torch.Tensor:
  """Reinhard on any (N, 3k, h, w) layout (the resize route's planar
  image): K3 map + per-image max, then the gamma stage -> u8 of x's
  shape."""
  p_cast, max_out = reinhard_map_max_ca(x, metrics, intensity, light_adapt,
                                        color_adapt, work_dtype,
                                        backend=backend)
  return reinhard_gamma_ca(p_cast, max_out, gamma)


def linear_apply_ca(x: torch.Tensor, metrics: torch.Tensor,
                    gamma) -> torch.Tensor:
  """The linear tonemap on any layout (torch; the JAX package's XLA
  elementwise chain)."""
  return hopper_finish.linear_u8(x, hopper_finish.linear_scal(metrics),
                                 gamma)


def demosaic_reinhard_front(phases: torch.Tensor, metrics: torch.Tensor,
                            intensity, light_adapt, pattern, cc,
                            backend: str = "auto"):
  """Front-fused demosaic + Reinhard map (K7, bf16): ``(p (N, 12, hh, wh)
  bf16, per-image max (N, 1, 1, 1))`` from the phase planes, with metrics
  computed beforehand (from ``ops/bayer.demosaic_samples``)."""
  _, _, hh, wh = phases.shape
  weights = bayer_ops._demosaic_tables(pattern, "mhc")
  fin = bayer_ops._finish_spec_for(pattern, "mhc", hh, wh,
                                   None if cc is None else tuple(cc),
                                   types.bf16)
  scal = hopper_reinhard.reinhard_scal(metrics, intensity, light_adapt)
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


def _front_fused_route(wd, resize_plan, stride, tonemap, color_adapt):
  """The JAX package's gate of the front-fused route (off unless
  TAICHI_IMAGE_TPU_FRONT_FUSED=1)."""
  return (os.environ.get("TAICHI_IMAGE_TPU_FRONT_FUSED", "") == "1"
          and wd == types.bf16 and resize_plan is None and stride % 2 == 0
          and tonemap == "reinhard" and float(color_adapt) == 0.0)


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
                   backend: str = "auto"):
  """One ISP step over a camera batch: ``(new_metrics (9,) f32, planar
  u8 (N, 3, h', w'))``, or with ``color_format="yuv420"`` ``(new_metrics,
  (Y (N, h', w'), VU (N, 2, h'/2, w'/2)))``. Arguments as in the JAX
  ``fused_isp_step``; ``backend`` ("auto" | "kernel" | "plain") routes
  every kernel stage."""
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
  phases = load_raw_phases(raws, fmt, wd, ids_format, backend=backend)

  if _front_fused_route(wd, resize_plan, stride, tonemap, color_adapt):
    # metering first, from the sample pre-pass; then stencil + map as one
    # kernel (K7) and the finish
    new_metrics = metering_update_ca(bayer_ops.demosaic_samples(
        phases, pattern, cc=cc, out_dtype=wd,
        sample_step=max(stride // 2, 1)), prev, t)
    p_cast, max_out = demosaic_reinhard_front(
        phases, new_metrics, intensity, light_adapt, pattern, cc,
        backend=backend)
    return new_metrics, _finish(p_cast, max_out, gamma, "reinhard",
                                transform, color_format, backend)

  if resize_plan is not None:
    x12 = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd,
                          backend=backend)
    size, scale = resize_plan
    rgb = _resize_x12(x12, size, scale, wd, backend=backend)
    new_metrics = metering_update_ca(subsample_hw(rgb, stride, stride),
                                     prev, t)
    if color_format == "yuv420":
      # the tonemap, the transform and I420 in one kernel
      if tonemap == "reinhard":
        src, scal = reinhard_map_max_ca(rgb, new_metrics, intensity,
                                        light_adapt, color_adapt, wd,
                                        backend=backend)
      else:
        src, scal = rgb, hopper_finish.linear_scal(new_metrics)
      return new_metrics, hopper_yuv420.yuv420_planar_tone(
          src, scal, gamma, tonemap, transform, backend=backend)
    if tonemap == "reinhard":
      out = reinhard_apply_ca(rgb, new_metrics, gamma, intensity,
                              light_adapt, color_adapt, wd, backend=backend)
    else:
      out = linear_apply_ca(rgb, new_metrics, gamma)
    return new_metrics, _transform_planar(out, transform).contiguous()

  if stride % 2 != 0:
    # the samples of an odd stride fall on every phase: gather them from
    # x12 (the planar image's pixels); the tonemap stays in phase form,
    # since the map is per pixel and the max runs over the same pixels
    x12 = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd,
                          backend=backend)
    strided = bayer_ops.planar_subsample(x12, stride)
  else:
    # full-res stride-s pixels are exactly phase (0, 0) at half-res s/2
    x12, strided = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd,
                                   backend=backend,
                                   sample_step=max(stride // 2, 1))
  new_metrics = metering_update_ca(strided, prev, t)
  # K3 + K4, or K4's linear mode; the transform lives in K4's stores. An
  # odd stride's I420 is the JAX package's planar conversion (the matrix
  # before the block mean) of the RGB
  phase_format = color_format if stride % 2 == 0 else "rgb"
  if tonemap == "linear":
    out = _finish(x12, hopper_finish.linear_scal(new_metrics), gamma,
                  "linear", transform, phase_format, backend)
  else:
    p_cast, max_out = reinhard_map_max_ca(x12, new_metrics, intensity,
                                          light_adapt, color_adapt, wd,
                                          backend=backend)
    out = _finish(p_cast, max_out, gamma, "reinhard", transform,
                  phase_format, backend)
  if phase_format != color_format:
    return new_metrics, yuv420_from_planar_u8(out, backend=backend)
  return new_metrics, out


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

  def process(self, raws, fmt: str = "packed12", ids_format: bool = False,
              gamma: float = 1.0, intensity: float = 1.0,
              light_adapt: float = 1.0, color_adapt: float = 0.0,
              tonemap: str = "reinhard", layout: str = "planar",
              color_format: str = "rgb"):
    """Whole-rig step: decode -> demosaic+WB/CCM -> the rig's resize ->
    metering EMA -> Reinhard or linear tonemap -> the rig's transform ->
    u8, updating the EMA state.

    ``raws``: (n_cameras, H, W_bytes) uint8, a tensor or numpy array
    (moved to the ISP's device). Returns planar (n, 3, h', w') u8 on the
    device, or with ``layout='hwc'`` a host numpy (n, h', w', 3) array.
    ``color_format='yuv420'`` returns planar I420 ``(Y, VU)`` u8 on the
    device instead (``layout`` ignored; even output dims required).
    """
    debug_util.validate_raw(raws, fmt)
    raws = torch.as_tensor(raws).to(self.device)
    if self.metrics is None:
      prev = torch.zeros(9, dtype=torch.float32, device=self.device)
      t = 0.0
    else:
      prev = self.metrics
      t = 1.0 - self.moving_alpha
    plan = self._resize_plan(raws.shape[1], decoded_width(fmt, raws.shape[2]))
    new_metrics, out = fused_isp_step(
        raws, prev, t, float(gamma), float(intensity), float(light_adapt),
        float(color_adapt), fmt, ids_format, self._work_dtype,
        self.bayer_pattern, self._cc_tuple(), plan, self.metering_stride,
        self.transform, tonemap, color_format=color_format)
    self.metrics = new_metrics
    if color_format != "rgb":
      return out
    if layout == "hwc":
      return np.moveaxis(out.cpu().numpy(), 1, -1)
    return out


def camera_isp(name: str, dtype=types.f32):
  """Class factory closing over a working dtype."""
  cls = type(name, (_ISPBase,),
             {"_work_dtype": types.canonical_dtype(dtype)})
  cls.__qualname__ = name
  cls.__module__ = __name__
  return cls


# The three classes of the JAX package; each runs the ported main path
# through its own dtype's instantiations of K1-K4.
Camera16 = camera_isp("Camera16", types.f16)
Camera32 = camera_isp("Camera32", types.f32)
CameraBF16 = camera_isp("CameraBF16", types.bf16)
