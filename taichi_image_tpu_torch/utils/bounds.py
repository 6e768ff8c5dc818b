"""Bounds primitives (counterpart of ``taichi_image_tpu/utils/bounds.py``):
a host-side {min, max} pair, and the whole-image min/max as a (2,) f32
tensor on the image's device (a reduction, no host read)."""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

__all__ = ["Bounds", "union_bounds", "bounds_to_np", "bounds_from_np",
           "image_bounds", "lerp"]


@dataclasses.dataclass
class Bounds:
  """Host-side {min, max} pair."""

  min: float
  max: float

  @property
  def span(self) -> float:
    return self.max - self.min

  def union(self, other: "Bounds") -> "Bounds":
    return Bounds(min(self.min, other.min), max(self.max, other.max))

  def expand(self, v: float) -> "Bounds":
    return Bounds(min(self.min, v), max(self.max, v))

  def to_vec(self):
    return np.array([self.min, self.max], np.float32)


def union_bounds(bounds: Iterable[Bounds]) -> Bounds:
  """The union of some bounds (empty: [inf, -inf])."""
  result = Bounds(np.inf, -np.inf)
  for b in bounds:
    result = result.union(b)
  return result


def bounds_to_np(b: Bounds) -> np.ndarray:
  return np.array([b.min, b.max], np.float32)


def bounds_from_np(b) -> Bounds:
  return Bounds(float(b[0]), float(b[1]))


def image_bounds(image: torch.Tensor) -> torch.Tensor:
  """Whole-image min and max over every element, a (2,) f32 tensor."""
  x = image.to(torch.float32)
  return torch.stack([x.amin(), x.amax()])


def lerp(t, a, b):
  """a + t * (b - a), in this expression order (the metering EMA and the
  Reinhard adapt chain depend on it bit for bit)."""
  return a + t * (b - a)
