"""Symmetric weight-table construction (counterpart of
``taichi_image_tpu/ops/kernel.py``). Tables are plain Python/numpy,
built once on the host."""

from __future__ import annotations


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
