"""Benchmark harness (counterpart of ``taichi_image_tpu/utils/benchmark.py``).

Reference: ``taichi_image/bench/util.py:8-48``, a context manager timing a
block on the host's wall clock and a warmup + iterations driver. The fence
around the clock is ``torch.cuda.synchronize`` on every CUDA device that
holds a tensor of the result (kernels launch on any device), or on the
current device when there is no result; tensors on the CPU need none.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch


def _leaves(x):
  """The tensors in ``x`` (a tensor, or lists, tuples and dicts of them)."""
  if isinstance(x, torch.Tensor):
    yield x
  elif isinstance(x, dict):
    for v in x.values():
      yield from _leaves(v)
  elif isinstance(x, (list, tuple)):
    for v in x:
      yield from _leaves(v)


def _sync(x=None):
  """Wait for the devices that compute ``x`` (every CUDA device holding
  one of its tensors), or with no ``x`` for the current CUDA device."""
  if x is None:
    if torch.cuda.is_available():
      torch.cuda.synchronize()
    return
  for d in {t.device for t in _leaves(x) if t.is_cuda}:
    torch.cuda.synchronize(d)


class Benchmark:
  """Timing context manager (reference bench/util.py:8-28)."""

  def __init__(self, name: str, iterations: int = 1):
    self.iterations = iterations
    self.name = name
    self.elapsed = 0.0

  def __enter__(self):
    _sync()
    self.start = time.perf_counter()
    return self

  def __exit__(self, exc_type, value, traceback):
    _sync()
    self.elapsed = time.perf_counter() - self.start
    if self.iterations > 1:
      print(f"{self.name}: {self.elapsed:.4f}s "
            f"{self.iterations / self.elapsed:.2f} it/s")
    else:
      print(f"{self.name}: {self.elapsed:.4f}s")


def benchmark(name: str,
              func: Callable,
              args: Optional[List] = None,
              kwargs: Optional[Dict] = None,
              iterations: int = 1,
              warmup: int = 0,
              progress=None) -> float:
  """Warmup + timed iterations (reference bench/util.py:31-48).

  Returns iterations/second. The last result's devices are synchronised
  inside the clock, so the launch queue does not hide the device time.
  """
  args = args or []
  kwargs = kwargs or {}
  if progress is None:
    progress = lambda x: x

  out = None
  for _ in progress(range(warmup)):
    out = func(*args, **kwargs)
  if out is not None:
    _sync(out)

  with Benchmark(name, iterations) as b:
    for _ in progress(range(iterations)):
      out = func(*args, **kwargs)
    if out is not None:
      _sync(out)
  return iterations / b.elapsed
