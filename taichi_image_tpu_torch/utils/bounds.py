"""Bounds primitives (counterpart of ``taichi_image_tpu/utils/bounds.py``)."""

from __future__ import annotations


def lerp(t, a, b):
  """a + t * (b - a), in this expression order (the metering EMA and the
  Reinhard adapt chain depend on it bit for bit)."""
  return a + t * (b - a)
