"""The program's own tracer, read from outside the program.

The port keeps per-name aggregates of its ``isp.*`` spans (calls, total
and self ns) and its counters (each kernel's host ns inside its launcher,
each kernel source's nvcc runs and load ns) in
``taichi_image_tpu_torch.utils.profiling``, whose ``snapshot()`` returns
them. This module imports nothing of the program: it reads that module
where the program has loaded it, and a program without a tracer reads as
nothing, so that a metric built on it is reported missing there.
"""

from __future__ import annotations

import sys

MODULE = "taichi_image_tpu_torch.utils.profiling"

# the program's span names the readers read
PROCESS, LAUNCH, LOAD = "isp.process", "isp.launch", "isp.load"


def snapshot() -> dict | None:
  """The program tracer's aggregates and counters, or None where the
  program has no tracer."""
  read = getattr(sys.modules.get(MODULE), "snapshot", None)
  return None if read is None else read()


def spans(snap: dict | None) -> dict:
  """A snapshot's {span name: {calls, ns, self_ns}} (empty for None)."""
  return (snap or {}).get("spans", {})


def sets(snap: dict | None) -> int:
  """The sets a snapshot saw: its ``isp.process`` calls."""
  return spans(snap).get(PROCESS, {}).get("calls", 0)
