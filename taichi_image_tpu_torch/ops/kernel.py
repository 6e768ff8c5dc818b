"""Symmetric weight-table construction and the reference's clamped-border
convolution demo (counterpart of ``taichi_image_tpu/ops/kernel.py``).
Tables are plain Python/numpy, built once on the host."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from taichi_image_tpu_torch import types


def mirror(w):
  """[a, b, c] -> [a, b, c, b, a]."""
  return list(w) + list(w)[:-1][::-1]


def flatten(w):
  return [x for row in w for x in row]


def symmetrical(w):
  """Quarter-spec rows -> flattened symmetric 2-D table."""
  rows = mirror([mirror(row) for row in w])
  return flatten(rows)


def zip_tuple(*args):
  return tuple(zip(*args))


def kernel_square(weights, n=5):
  """(offset, weight) pairs over an n x n square."""
  offsets = [(i, j) for i in range(-(n // 2), n // 2 + 1)
             for j in range(-(n // 2), n // 2 + 1)]
  assert len(offsets) == len(weights), (
      f"need {len(offsets)} weights for a {n}x{n} square, "
      f"got {len(weights)}")
  return tuple(zip(offsets, weights))


def taps_to_dense(taps, radius: int) -> np.ndarray:
  """(offset, weight) pairs -> dense (2r+1, 2r+1) float32 array."""
  k = np.zeros((2 * radius + 1, 2 * radius + 1), np.float32)
  for (dy, dx), w in taps:
    k[dy + radius, dx + radius] += w
  return k


def conv(image, taps, device="cuda") -> torch.Tensor:
  """Clamped-border u8 2-D convolution of an (H, W, C) image: ``taps``
  is a tuple of ((dy, dx), weight); the edge-clamped taps are summed in
  f32 in ``taps`` order (each weight times its shifted image), divided by
  the total weight, clamped to [0, 255] and cast to u8. A host array is
  moved to ``device`` (the card by default), a tensor taken on its own."""
  image = types.as_tensor(image, device)
  total = float(sum(w for _, w in taps))
  radius = max(max(abs(dy), abs(dx)) for (dy, dx), _ in taps)
  x = image.to(torch.float32)
  h, w = x.shape[:2]
  # edge padding of the two spatial dims (replicate pads the last two)
  padded = F.pad(x.permute(2, 0, 1)[None], (radius,) * 4,
                 mode="replicate")[0].permute(1, 2, 0)
  acc = torch.zeros_like(x)
  for (dy, dx), weight in taps:
    acc = acc + float(weight) * padded[dy + radius:dy + radius + h,
                                       dx + radius:dx + radius + w]
  # a 0-d tensor divisor: a true division on every device (torch on CUDA
  # multiplies by the reciprocal of a Python scalar)
  div = torch.tensor(total, dtype=torch.float32, device=acc.device)
  return torch.clamp(acc / div, 0, 255).to(torch.uint8)
