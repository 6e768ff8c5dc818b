"""The arithmetic that turns a run's timings, spans and trace slices into
metrics. Times in a trace are microseconds; every function returns
seconds or milliseconds as its name says."""

from __future__ import annotations

# the kinds of device operation a trace slice holds
KERNEL, MEMSET, MEMCPY = "kernel", "memset", "memcpy"


def merged(intervals, lo: float, hi: float) -> list:
  """The union of ``(start, end)`` intervals clipped to [lo, hi], as
  disjoint sorted intervals."""
  out = []
  for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
    if e <= s:
      continue
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return [tuple(iv) for iv in out]


def busy(intervals, lo: float, hi: float) -> float:
  """Length of the union of the intervals inside [lo, hi]."""
  return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
  """The parts of [lo, hi] that no interval covers."""
  out, at = [], lo
  for s, e in merged(intervals, lo, hi):
    if s > at:
      out.append((at, s))
    at = max(at, e)
  if at < hi:
    out.append((at, hi))
  return out


def innermost(spans, t: float):
  """The name of the innermost host span open at ``t`` (the latest to
  start of those that contain it), or None. ``spans``: (name, start,
  duration)."""
  best = None
  for name, s, d in spans:
    if s <= t <= s + d and (best is None or s > best[1]):
      best = (name, s)
  return None if best is None else best[0]


def device_intervals(sl) -> list:
  return [(op.ts, op.ts + op.dur) for op in sl.device]


def complete(slices) -> list:
  """The slices that hold at least as many kernels as the program
  launched in them. A profiler session now and then loses a set's
  device records; a slice that lost any is left out, so that no metric
  reads low from it."""
  return [sl for sl in slices
          if sum(op.kind == KERNEL for op in sl.device) >= sl.launches]


def ms_per_set(slices, kinds) -> float | None:
  """Summed device time of the operations of ``kinds`` per set in the
  slices, ms; None without slices, sets or such operations."""
  sets = sum(sl.sets for sl in slices)
  ops = [op.dur for sl in slices for op in sl.device if op.kind in kinds]
  if not sets or not ops:
    return None
  return sum(ops) / sets / 1e3


def busy_window_s(slices) -> tuple[float, float]:
  """(seconds in which any device operation ran, seconds traced) over
  the slices."""
  b = sum(busy(device_intervals(sl), sl.t0, sl.t1) for sl in slices)
  w = sum(sl.t1 - sl.t0 for sl in slices)
  return b / 1e6, w / 1e6


def idle_by_span(slices) -> dict:
  """Seconds in which the device was idle, by the benchmark's host span
  open in the middle of each gap (``other`` where none was)."""
  out = {}
  for sl in slices:
    for s, e in gaps(device_intervals(sl), sl.t0, sl.t1):
      name = innermost(sl.host, 0.5 * (s + e)) or "other"
      out[name] = out.get(name, 0.0) + (e - s) / 1e6
  return out


def device_time_by_label(slices) -> dict:
  """Seconds of device time by operation label over the slices."""
  out = {}
  for sl in slices:
    for op in sl.device:
      out[op.label] = out.get(op.label, 0.0) + op.dur / 1e6
  return out


def top(d: dict, n: int = 10) -> list:
  return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def span_ms_per_set(spans, name: str) -> float | None:
  """Mean host time of span ``name`` over every call in the window,
  ms."""
  d = spans.durations.get(name)
  if not d:
    return None
  return sum(d) / len(d) * 1e3
