"""Image quality metrics (counterpart of
``taichi_image_tpu/utils/image.py``).

The reference checks demosaic quality as PSNR against independent
implementations (test/bayer.py:18-23, test/compare_bayer.py:31-44). Both
metrics take numpy arrays or tensors on any device and compute on the host
in float64, so they give the JAX package's values for the same data.
"""

from __future__ import annotations

import numpy as np
import torch

from taichi_image_tpu_torch import types


def _host(x) -> np.ndarray:
  """``x`` as a host numpy array: a tensor is copied from its device (a
  bfloat16 one as float32, which holds it exactly)."""
  if isinstance(x, torch.Tensor):
    x = x.detach()
    if x.dtype == torch.bfloat16:
      x = x.to(torch.float32)
    return x.cpu().numpy()
  return np.asarray(x)


def psnr(a, b, peak: float = None) -> float:
  """Peak signal-to-noise ratio in dB. ``peak`` defaults to the
  full-scale value of ``a``'s dtype (normalized convention)."""
  if peak is None:
    peak = types.scale_of(a.dtype if isinstance(a, torch.Tensor)
                          else np.asarray(a).dtype)
  x = _host(a).astype(np.float64)
  y = _host(b).astype(np.float64)
  mse = np.mean((x - y) ** 2)
  if mse == 0:
    return float("inf")
  return float(10.0 * np.log10(peak * peak / mse))


def mse(a, b) -> float:
  """Mean squared difference in float64."""
  a = _host(a).astype(np.float64)
  b = _host(b).astype(np.float64)
  return float(np.mean((a - b) ** 2))
