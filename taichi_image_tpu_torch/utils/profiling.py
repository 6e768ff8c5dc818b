"""Profiling / tracing hooks (counterpart of
``taichi_image_tpu/utils/profiling.py``).

The reference's only observability is the bench harness's synchronized
wall clock (bench/util.py:8-28, SURVEY.md §5). Here ``trace(...)`` wraps a
block in a ``torch.profiler`` profile (the host, and the CUDA devices when
there are any) and writes a Chrome trace that Perfetto and TensorBoard
load; ``annotate`` marks named regions.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
  """Capture a profile of the enclosed block into ``log_dir``
  (``<host>_<pid>.<time>.pt.trace.json``). ``create_perfetto_link`` is
  accepted for the JAX signature and has no effect, as on JAX's CPU."""
  del create_perfetto_link
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities,
               on_trace_ready=tensorboard_trace_handler(str(log_dir))):
    yield


def annotate(name: str):
  """Named trace region (shows up in the profile timeline)."""
  return torch.profiler.record_function(name)


@contextlib.contextmanager
def stage_timer(stats: dict, name: str):
  """Accumulate host wall-clock per pipeline stage into ``stats``."""
  t0 = time.perf_counter()
  try:
    yield
  finally:
    stats[name] = stats.get(name, 0.0) + time.perf_counter() - t0
