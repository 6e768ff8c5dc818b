"""The benchmark's host spans and the profiler slices of a traced run.

With ``--trace 1`` the benchmark wraps its calls into the program in
spans of its own (``process``, ``sync``),
timed on the host clock and marked in the profiler's trace, and it
profiles a few bounded slices spread over the window: each begins after
a device sync and ends with one, so every device operation launched in
a slice runs inside it. A slice is parsed after the window into its
device operations and the host spans open around them. The program's own
tracer, which the harness turns on for a traced window, is off inside
each slice: it is switched between two sets, before the profiler starts
and after the slice's trace is exported.
"""

from __future__ import annotations

import contextlib
import json
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

from isp_bench import reduce

HOST_SPANS = ("process", "sync")
SLICE = "slice"
_NULL = contextlib.nullcontext()


def _no_switch(on: bool) -> None:
  """A ``program_tracing`` for a program without a tracer."""


class Spans:
  """Host spans around the benchmark's calls into the program: the
  seconds of every call of each name while ``enabled``."""

  def __init__(self):
    self.enabled = False
    self.durations = defaultdict(list)

  def __call__(self, name: str):
    return _Span(self, name) if self.enabled else _NULL

  def count(self, name: str) -> int:
    return len(self.durations.get(name, ()))


class _Span:
  __slots__ = ("spans", "name", "mark", "t")

  def __init__(self, spans: Spans, name: str):
    self.spans, self.name = spans, name

  def __enter__(self):
    from torch.profiler import record_function
    self.mark = record_function(self.name)
    self.mark.__enter__()
    self.t = time.perf_counter()

  def __exit__(self, *exc):
    self.spans.durations[self.name].append(time.perf_counter() - self.t)
    self.mark.__exit__(*exc)


@dataclass
class DeviceOp:
  kind: str     # reduce.KERNEL, MEMSET or MEMCPY
  label: str    # the kernel family, or the copy's name
  ts: float     # microseconds
  dur: float


@dataclass
class Slice:
  t0: float
  t1: float
  sets: int       # the program's process calls in the slice
  launches: int   # the kernels the program counted launching in it
  device: list = field(default_factory=list)
  host: list = field(default_factory=list)   # (span name, ts, dur)


class Tracer:
  """Profiles ``n_slices`` slices of ``slice_sets`` sets each, the i-th
  starting at the first set after (i + 1) / (n_slices + 1) of the
  window. ``sync`` waits for the device; ``settle`` runs one device
  operation of the benchmark's own and waits for it; ``launches`` reads the
  program's count of kernel launches; ``activities`` are the profiler's;
  ``families`` {kernel family: its kernel symbols} label the kernels;
  ``program_tracing(on)`` switches the program's own tracer, off for each
  slice and on again after it."""

  def __init__(self, enabled: bool, n_slices: int, slice_sets: int,
               seconds: float, spans: Spans, sync, settle, launches,
               activities, families: dict, program_tracing=_no_switch):
    self.enabled = enabled
    self.starts = [seconds * (i + 1) / (n_slices + 1)
                   for i in range(n_slices)]
    self.slice_sets = slice_sets
    self.spans, self.sync, self.settle = spans, sync, settle
    self.launches = launches
    self.activities, self.families = activities, families
    self.program_tracing = program_tracing
    self.t0 = None
    self.active = None
    self.slices = []

  def start_window(self, t0: float) -> None:
    self.t0 = t0

  def before_set(self) -> None:
    """Called by a loop before each set of the window."""
    if not self.enabled:
      return
    if self.active is not None:
      if self.spans.count("process") - self.active["sets"] >= self.slice_sets:
        self._stop()
    elif (len(self.slices) < len(self.starts)
          and time.perf_counter() - self.t0 >= self.starts[len(self.slices)]):
      self._start()

  def finish(self) -> None:
    if self.active is not None:
      self._stop()

  def _start(self) -> None:
    from torch.profiler import profile, record_function
    self.sync()
    self.program_tracing(False)
    prof = profile(activities=self.activities)
    prof.start()
    # a session's first device operation now and then goes unrecorded:
    # one of the benchmark's own, before the slice opens, takes its place
    self.settle()
    mark = record_function(SLICE)
    mark.__enter__()
    self.active = dict(prof=prof, mark=mark,
                       sets=self.spans.count("process"),
                       launches=self.launches())

  def _stop(self) -> None:
    a, self.active = self.active, None
    with self.spans("sync"):
      self.sync()
    a["mark"].__exit__(None, None, None)
    a["prof"].stop()
    with tempfile.TemporaryDirectory() as tmp:
      path = Path(tmp) / "trace.json"
      a["prof"].export_chrome_trace(str(path))
      with open(path) as f:
        events = json.load(f)["traceEvents"]
    self.slices.append(parse(events, self.spans.count("process") - a["sets"],
                             self.launches() - a["launches"], self.families))
    self.program_tracing(True)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(cat: str) -> str:
  if cat == "kernel":
    return reduce.KERNEL
  if cat == "gpu_memset":
    return reduce.MEMSET
  return reduce.MEMCPY


def family_of(name: str, families: dict) -> str | None:
  """The kernel family whose symbols the demangled kernel ``name``
  holds."""
  for fam, symbols in families.items():
    if any(re.search(rf"\b{s}\b", name) for s in symbols):
      return fam
  return None


def parse(events: list, sets: int, launches: int, families: dict) -> Slice:
  """One slice from a chrome trace's events: the ``slice`` span's
  interval, the device operations inside it (a kernel labelled by its
  family from ``families``, {family: kernel symbols}) and the
  benchmark's host spans. Events with no time (a trace that lost them)
  are left out."""
  window = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == SLICE)
  sl = Slice(window["ts"], window["ts"] + window["dur"], sets, launches)
  for e in events:
    if e.get("ph") != "X" or not e.get("ts"):
      continue
    cat, name = e.get("cat"), e.get("name", "")
    if cat in _DEVICE_CATS:
      if e["ts"] + e.get("dur", 0.0) <= sl.t0 or e["ts"] >= sl.t1:
        continue
      kind = _kind(cat)
      label = (family_of(name, families) or name[:60] if kind == reduce.KERNEL
               else "Memset" if kind == reduce.MEMSET else name)
      sl.device.append(DeviceOp(kind, label, float(e["ts"]),
                                float(e.get("dur", 0.0))))
    elif cat == "user_annotation" and name in HOST_SPANS:
      sl.host.append((name, float(e["ts"]), float(e.get("dur", 0.0))))
  return sl
