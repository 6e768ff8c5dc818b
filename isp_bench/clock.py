"""The age of the process, from which set-up is timed. It imports
nothing heavy, so that a run can read it before its imports."""

from __future__ import annotations

import os
import time


def process_age_s() -> float:
  """Seconds since this process started (Linux: from /proc; elsewhere
  since the interpreter's start)."""
  try:
    with open("/proc/self/stat") as f:
      fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start
  except (OSError, ValueError, IndexError, AttributeError):
    return time.perf_counter() - _LOADED_AT


_LOADED_AT = time.perf_counter()
