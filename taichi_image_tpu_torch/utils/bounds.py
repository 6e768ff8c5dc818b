"""Bounds primitives (counterpart of ``taichi_image_tpu/utils/bounds.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np


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


def lerp(t, a, b):
  """a + t * (b - a), in this expression order (the metering EMA and the
  Reinhard adapt chain depend on it bit for bit)."""
  return a + t * (b - a)
