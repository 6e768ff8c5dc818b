"""Multi-camera ISP step on PyTorch: packed12 RAW -> demosaic (+WB/CCM)
-> EMA metering -> Reinhard -> planar u8.

Counterpart of ``taichi_image_tpu/models/camera_isp.py`` for the main
path (``fused_isp_step`` with packed12 raws, no resize, no transform,
even metering stride, Reinhard) of all three classes: CameraBF16 (bf16),
Camera16 (f16) and Camera32 (f32). On a CUDA device the step is four
hand-written Hopper kernels, each instantiated for the working dtype T,
plus the metering reduction in torch:

  K1<T> decode   (N, H, 1.5W) u8     -> phases (N, 4, H/2, W/2) T
  K2<T> stencil  phases              -> x12 (N, 12, H/2, W/2) T
                                        + metering sample (N, 3, ., .) T
  metering       sample, prev vec9   -> new vec9 (torch, f32, on device)
  K3<T> map      x12, scal(vec9)     -> p T + per-image max of the f32 p
  K4<T> finish   p, max              -> planar u8 (N, 3, H, W)

Camera16 has the semantics of the JAX package's strict f16 route, which
its TPU-only q16 route is held to (tests/test_q16.py): phases, x12 and p
materialized in f16. The q16 containers are not carried over; they exist
because the TPU's Mosaic toolchain cannot load or store f16
(taichi_image_tpu/ops/pallas/q16.py:7-13), and Hopper can.

No step syncs with the host: the metering vector feeds the map kernel
as a device tensor. vec9 layout: [bounds.min, bounds.max,
log_bounds.min, log_bounds.max, log_mean, mean, rgb_mean(3)].

Configurations outside the slice raise ``NotImplementedError`` naming
the ROADMAP.md item that will port them; none is approximated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.ops import bayer as bayer_ops
from taichi_image_tpu_torch.ops.bayer import demosaic_phases, phases_to_planar
from taichi_image_tpu_torch.ops.hopper import decode as hopper_decode
from taichi_image_tpu_torch.ops.hopper import finish as hopper_finish
from taichi_image_tpu_torch.ops.hopper import reinhard as hopper_reinhard
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.utils import debug as debug_util
from taichi_image_tpu_torch.utils.bounds import lerp

__all__ = ["camera_isp", "Camera16", "Camera32", "CameraBF16", "default_cc",
           "fused_isp_step", "load_raw_phases", "metering_update_ca",
           "reinhard_map_ca", "reinhard_map_max_ca", "reinhard_gamma_ca",
           "planar_from_phases_transformed", "state_from_jax"]

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


def planar_from_phases_transformed(out12: torch.Tensor, t: ImageTransform,
                                   out_dtype=None) -> torch.Tensor:
  """(N, 12, hh, wh) -> planar (N, 3, H, W); only the identity transform
  is ported."""
  if t != ImageTransform.none:
    raise _not_ported(f"output transform {t.value}", 7)
  return phases_to_planar(out12, out_dtype)


def fused_isp_step(raws: torch.Tensor, prev: torch.Tensor, t, gamma,
                   intensity, light_adapt, color_adapt, fmt, ids_format,
                   work_dtype, pattern, cc, resize_plan, stride, transform,
                   tonemap, color_format: str = "rgb",
                   backend: str = "auto"):
  """One ISP step over a camera batch: ``(new_metrics (9,) f32, planar
  u8 (N, 3, H, W))``. Arguments as in the JAX ``fused_isp_step``;
  ``backend`` ("auto" | "kernel" | "plain") routes every kernel stage."""
  if resize_plan is not None:
    raise _not_ported("resize", 7)
  if transform != ImageTransform.none:
    raise _not_ported(f"output transform {transform.value}", 7)
  if color_format != "rgb":
    raise _not_ported(f"color_format {color_format!r}", 8)
  if tonemap != "reinhard":
    if tonemap == "linear":
      raise _not_ported("the linear tonemap", 15)
    raise ValueError(f"unknown tonemap {tonemap}")
  if stride % 2 != 0:
    raise _not_ported(f"odd metering stride {stride}", 15)
  wd = types.canonical_dtype(work_dtype)
  phases = load_raw_phases(raws, fmt, wd, ids_format, backend=backend)
  # full-res stride-s pixels are exactly phase (0, 0) at half-res s/2
  x12, strided = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd,
                                 backend=backend,
                                 sample_step=max(stride // 2, 1))
  new_metrics = metering_update_ca(strided, prev, t)
  p_cast, max_out = reinhard_map_max_ca(x12, new_metrics, intensity,
                                        light_adapt, color_adapt, wd,
                                        backend=backend)
  out = hopper_finish.finish_planar_u8(p_cast, max_out, gamma,
                                       backend=backend)
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
    """Whole-rig step: decode -> demosaic+WB/CCM -> metering EMA ->
    Reinhard -> u8, updating the EMA state.

    ``raws``: (n_cameras, H, W_bytes) uint8, a tensor or numpy array
    (moved to the ISP's device). Returns planar (n, 3, H, W) u8 on the
    device, or with ``layout='hwc'`` a host numpy (n, H, W, 3) array.
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
