"""Standalone tonemappers: linear (bounds-normalize + gamma) and global
Reinhard with log-luminance metering.

Counterpart of ``taichi_image_tpu/ops/tonemap.py``, in plain torch on the
tensor's device (the JAX package leaves this math to XLA). Images are
channels-last (H, W, 3) tensors; a host array is moved to ``device`` (the
card by default), a tensor is taken on its own device.
Scalars (gamma, intensity, adapt weights) are taken as f32, as the JAX
functions take them.

The reference's quirk is kept: the standalone metering returns
``Bounds(log_min, -log_max)``, the log-max NEGATED. The ISP's metering
(``models/camera_isp.metering_update_ca``) has no such negation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.ops.color import rgb_gray
from taichi_image_tpu_torch.utils.bounds import Bounds, lerp

__all__ = [
    "Metering", "metering_to_np", "metering_from_np",
    "tonemap_linear", "tonemap_reinhard", "tonemap_gamma",
    "linear_map", "metering", "reinhard_map",
]


@dataclasses.dataclass
class Metering:
  """Host-side metering stats: log-luminance bounds, log-mean, gray mean
  and RGB mean, packable to a vec7."""
  log_bounds: Bounds
  log_mean: float
  gray_mean: float
  rgb_mean: np.ndarray

  def to_vec(self):
    return np.array([self.log_bounds.min, self.log_bounds.max,
                     self.log_mean, self.gray_mean, *self.rgb_mean],
                    np.float32)


def metering_to_np(x: Metering):
  return x.to_vec()


def metering_from_np(x) -> Metering:
  return Metering(Bounds(float(x[0]), float(x[1])), float(x[2]),
                  float(x[3]), np.asarray(x[4:7], np.float32))


def _f32(v, device) -> torch.Tensor:
  return torch.as_tensor(v, dtype=torch.float32, device=device)


def linear_map(image, bounds_min, bounds_max, gamma, out_dtype,
               device="cuda"):
  """Normalize by bounds, apply the 1/gamma power, clamp to [0, 1],
  rescale and cast."""
  image = types.as_tensor(image, device)
  lo, hi = _f32(bounds_min, image.device), _f32(bounds_max, image.device)
  inv_range = 1.0 / (hi - lo)
  inv_gamma = 1.0 / _f32(gamma, image.device)
  x = torch.pow((image - lo) * inv_range, inv_gamma)
  return types.from_float(torch.clamp(x, 0.0, 1.0), out_dtype)


def metering(image, device="cuda"):
  """Log-luminance statistics of a normalized f32 (H, W, 3) image over
  Bounds(0, 1): a (7,) vec with the negated log-max."""
  image = types.as_tensor(image, device)
  gray = rgb_gray(image)
  log_gray = torch.log(torch.clamp_min(gray, 1e-4))
  n = image.shape[0] * image.shape[1]
  return torch.stack([
      log_gray.min(),
      -log_gray.max(),  # the reference's quirk: negated
      log_gray.sum() / n,
      gray.sum() / n,
      *[image[..., c].sum() / n for c in range(3)],
  ])


def reinhard_map(image, stats, intensity, light_adapt, color_adapt,
                 device="cuda"):
  """Global Reinhard operator on a normalized f32 image, ``stats`` a vec7
  as :func:`metering` gives it."""
  image = types.as_tensor(image, device)
  dev = image.device
  intensity, light_adapt, color_adapt = (
      _f32(v, dev) for v in (intensity, light_adapt, color_adapt))
  log_min, log_max = stats[0], stats[1]
  log_mean, gray_mean = stats[2], stats[3]
  rgb_mean = stats[4:7]

  key = (log_max - log_mean) / (log_max - log_min)
  map_key = 0.3 + 0.7 * torch.pow(key, 1.4)

  mean = lerp(color_adapt, gray_mean, rgb_mean)
  gray = rgb_gray(image)[..., None]
  adapt_color = lerp(color_adapt, gray, image)
  adapt_mean = lerp(light_adapt, mean, adapt_color)
  adapt = torch.pow(torch.exp(-intensity) * adapt_mean, map_key)
  return image * (1.0 / (adapt + image))


def tonemap_linear(src, gamma=1.0, dtype=types.u8, device="cuda"):
  """Bounds reduction + linear map."""
  x = types.as_tensor(src, device).to(torch.float32)
  return linear_map(x, x.min(), x.max(), gamma, types.canonical_dtype(dtype))


def tonemap_reinhard(src, gamma=1.0, intensity=1.0, light_adapt=1.0,
                     color_adapt=0.0, dtype=types.u8, device="cuda"):
  """The five-stage Reinhard tonemap: bounds-normalize to [0, 1],
  metering, the map, re-bounds, then gamma and the cast."""
  x = types.as_tensor(src, device).to(torch.float32)
  lo, hi = x.min(), x.max()
  temp = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
  stats = metering(temp)
  mapped = reinhard_map(temp, stats, intensity, light_adapt, color_adapt)
  return linear_map(mapped, mapped.min(), mapped.max(), gamma,
                    types.canonical_dtype(dtype))


def tonemap_gamma(src, gamma=1.0, dtype=types.u8, device="cuda"):
  """Gamma-only map."""
  x = types.as_tensor(src, device).to(torch.float32)
  x = torch.pow(x, 1.0 / _f32(gamma, x.device))
  return types.from_float(torch.clamp(x, 0.0, 1.0),
                          types.canonical_dtype(dtype))
