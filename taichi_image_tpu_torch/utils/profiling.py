"""Profiling and tracing (counterpart of
``taichi_image_tpu/utils/profiling.py``).

The reference's only observability is the bench harness's synchronized
wall clock (bench/util.py:8-28, SURVEY.md §5). Here ``trace(...)`` wraps a
block in a ``torch.profiler`` profile (the host, and the CUDA devices when
there are any) and writes a Chrome trace that Perfetto and TensorBoard
load; ``annotate`` marks named regions.

The port's own tracer is off by default: :func:`enable` /
:func:`disable`, or ``with tracing():``, turn it on, and ``trace`` turns
it on for its block. The port marks its hot path with spans
(:data:`SPANS`): ``isp.process`` around each ``process`` and
``process_large`` call, opening a set (its id is the instance's count of
traced sets before it); inside ``fused_isp_step`` one span per stage on
the route taken (``isp.decode``, ``isp.demosaic``, ``isp.resize``,
``isp.meter``, ``isp.reinhard``, ``isp.finish``); ``isp.launch`` around
each hand-written kernel's C launcher call; ``isp.load`` around each kernel
library's first load (hashing its sources, ``nvcc --version``, nvcc where
the build cache misses, ``dlopen``).

While tracing is off a span site costs one check of :data:`ON` (a stage
of ``fused_isp_step`` one check of its local ``stage``): no span object,
no clock, no ``record_function``. While it is on, every span adds
to aggregates kept per name (calls, total ns, and self ns: its time less
what its child spans cover), bounded by the number of names, and carries
the set id of the span it opened in. While a torch.profiler session is
recording, each span is also a ``record_function`` named ``<span>
[<kernel or source>] set=<id>``, so it lands in the session's Chrome trace
on the profiler's clock, beside the device's kernels.

Counters: ``launch_ns`` per kernel (host ns inside its C launcher while
tracing is on, a launch held up by a full launch queue included),
``tone_forms`` (launches of the tone's kernels while tracing is on, by the
form their wrapper picked from gamma: ``gamma1``, ``pow_rcp``,
``pow_div``; ``ops/hopper/finish.py`` ``tone_form``; and ``table`` once
more for each K4 launch through its byte tables, ``table_form``),
``finish_layouts`` (K4's RGB launches while tracing is on, by the layout of
their output: ``rows``, or ``swap`` for a launch of its axis-swap kernel
under a transform that swaps the axes), ``resize_paths`` (K12's launches
while tracing is on, by the path :func:`ops.hopper.resize.plan` picked:
``aligned`` or ``direct``), ``i420_paths`` (launches of a step's I420
kernel while tracing is on, by path: ``rows`` for K4's I420 mode,
``swap`` for its tile kernel under a transform that swaps the axes,
``planar_tone`` for the resize route's planar tonemap form and
``planar_u8`` for the conversion of u8 RGB) and ``builds`` per source (nvcc
runs in this process: after a slow start, the sources nvcc rebuilt). The
load spans and ``builds`` are kept whether tracing is on or off: they run
once a source per process, never on the hot path. :func:`snapshot` returns
the aggregates and counters, :func:`reset` clears them.

Set markers. While tracing is on, an ``isp.process`` span that opens a set
on a CUDA device records two timing CUDA events on the device's current
stream: a start marker at its entry, before any device work of the set,
and an end marker at its exit, after the set's last (both outside any
``isp.launch`` span). Each device keeps its marked sets in submission
order, at most :data:`MARKED_SETS` of them (a set beyond that goes
unmarked: ``unmarked_sets``). They are resolved in order and never waited
for: at a new set's start, and in :func:`snapshot`, every set from the
front whose end marker has completed is popped, up to the first that has
not. A popped set is timed in :func:`snapshot`, off the hot path (at its
pop only beyond :data:`UNTIMED_SETS` popped and untimed sets a device): it
adds its start-to-end time to ``set_device_ns``, and the number of the
device's sets still pending when it opened to ``in_flight``; where the set
before it on the device was marked in the same stretch of tracing (a
stretch ends at every switch of :data:`ON` and at :func:`reset`) and had
ended when it opened (no set nested in another, nor sets of two threads
overlapping), the time from that set's end marker to its start marker
goes to ``wait_ns`` and the set to ``waited_sets``. The times are on the
card's own clock. They put the blame for the card's idle time by
construction:

- between sets, end(i-1) to start(i) (``wait_ns``) is time when the card
  had done all of set i-1's work and none of set i's was enqueued: the host
  was outside the port's set (the caller's loop, or the port returning);
- within a set, start(i) to end(i) less the set's kernels
  (``set_device_ns`` beside a trace's kernel time) is time while the host
  was inside the port: bubbles between its own kernels, or its own enqueue
  where the launch queue ran dry;
- ``in_flight`` says which of the two regimes a set ran in: near 0 the
  launch queue is empty, in the tens it is full.

While tracing is off a set-opening span site makes no event and reads no
clock, as every other span site.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from time import perf_counter_ns

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

# every name the port opens a span under
SPANS = ("isp.process", "isp.decode", "isp.demosaic", "isp.resize",
         "isp.meter", "isp.reinhard", "isp.finish", "isp.launch", "isp.load")

# the one flag every span site checks
ON = False

# the most sets a device keeps marked and unresolved
MARKED_SETS = 4096
# the most resolved sets a device keeps untimed until a snapshot
UNTIMED_SETS = 65536
# the set markers' counters (summed over devices)
MARKERS = ("sets", "set_device_ns", "wait_ns", "waited_sets", "in_flight",
           "unmarked_sets")

_spans: dict[str, list] = {}     # name: [calls, total ns, self ns]
_launch_ns: dict[str, int] = {}  # kernel: host ns inside its launcher
_tone_forms: dict[str, int] = {}  # tone form: kernel launches
_finish_layouts: dict[str, int] = {}  # K4's output layout: launches
_resize_paths: dict[str, int] = {}    # K12's path: launches
_i420_paths: dict[str, int] = {}      # the I420 kernel's path: launches
_builds: dict[str, int] = {}     # source: nvcc runs
_markers = dict.fromkeys(MARKERS, 0)
_devices: dict = {}              # device index: its marked sets (_Marks)
_stretch = 0                     # the stretch of tracing, bumped by switches
_streams: dict = {}              # (device index, raw stream): its Stream
_lock = threading.Lock()         # for the aggregates and counters above
_recording = torch.autograd._profiler_enabled   # a profiler session records


class _Local(threading.local):
  def __init__(self):
    self.stack = []   # this thread's open spans, innermost last


_local = _Local()


def _switch(on: bool) -> None:
  """Set :data:`ON`, ending the stretch of tracing."""
  global ON, _stretch
  with _lock:
    ON = on
    _stretch += 1


def enable() -> None:
  """Turn the tracer on."""
  _switch(True)


def disable() -> None:
  """Turn the tracer off (the aggregates stay until :func:`reset`)."""
  _switch(False)


@contextlib.contextmanager
def tracing():
  """The tracer on for the enclosed block, then as it was."""
  was = ON
  _switch(True)
  try:
    yield
  finally:
    _switch(was)


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
  """Capture a profile of the enclosed block into ``log_dir``
  (``<host>_<pid>.<time>.pt.trace.json``), with the tracer on, so that
  the port's spans land in it. ``create_perfetto_link`` is accepted for
  the JAX signature and has no effect, as on JAX's CPU."""
  del create_perfetto_link
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities,
               on_trace_ready=tensorboard_trace_handler(str(log_dir))):
    with tracing():
      yield


class _Off:
  """What a span site enters while tracing is off."""
  __slots__ = ()

  def __enter__(self):
    return None

  def __exit__(self, *exc):
    return None


_OFF = _Off()


class _Span:
  """One span; with a ``tag`` (a kernel, a source) its time also goes to
  ``counter[tag]``."""
  __slots__ = ("name", "tag", "counter", "set_id", "t0", "child_ns", "mark",
               "stack")

  def __init__(self, name: str, set_id=None, tag: str | None = None,
               counter: dict | None = None):
    self.name, self.set_id = name, set_id
    self.tag, self.counter = tag, counter

  def label(self) -> str:
    parts = [self.name]
    if self.tag is not None:
      parts.append(self.tag)
    if self.set_id is not None:
      parts.append(f"set={self.set_id}")
    return " ".join(parts)

  def __enter__(self):
    self.stack = stack = _local.stack
    if self.set_id is None and stack:
      self.set_id = stack[-1].set_id
    if _recording():
      self.mark = record_function(self.label())
      self.mark.__enter__()
    else:
      self.mark = None
    self.child_ns = 0
    stack.append(self)
    self.t0 = perf_counter_ns()
    return self

  def __exit__(self, *exc):
    self._close(perf_counter_ns() - self.t0, exc)

  def _close(self, ns: int, exc: tuple) -> None:
    stack = self.stack
    stack.pop()
    if stack:
      stack[-1].child_ns += ns
    with _lock:
      agg = _spans.get(self.name)
      if agg is None:
        agg = _spans[self.name] = [0, 0, 0]
      agg[0] += 1
      agg[1] += ns
      agg[2] += ns - self.child_ns
      if self.counter is not None:
        self.counter[self.tag] = self.counter.get(self.tag, 0) + ns
    if self.mark is not None:
      self.mark.__exit__(*exc)


def _event():
  """A new timing CUDA event (a seam: the tests make fake ones)."""
  return torch.cuda.Event(enable_timing=True)


def _stream(device: torch.device):
  """``device``'s current stream, None where it is no CUDA device (a seam:
  the tests give fake streams). The stream object is kept per raw stream,
  whose read costs a fraction of ``torch.cuda.current_stream``'s."""
  if device.type != "cuda":
    return None
  index = torch.cuda.current_device() if device.index is None else device.index
  key = (index, torch._C._cuda_getCurrentRawStream(index))
  stream = _streams.get(key)
  if stream is None:
    stream = _streams[key] = torch.cuda.current_stream(index)
  return stream


class _Set:
  """One marked set: its start and end markers, the end marker of the set
  popped before it, the device's sets pending when it opened, and whether
  the set before it on the device was marked in the same stretch of tracing
  and had ended when it opened."""
  __slots__ = ("start", "end", "before", "pending", "paired")


class _Marks:
  """One device's marked sets, in submission order, the popped sets not yet
  timed, and its spare events. The caller holds the lock."""
  __slots__ = ("fifo", "untimed", "spare", "last_end", "stretch", "busy")

  def __init__(self):
    self.fifo = collections.deque()
    self.untimed = collections.deque()
    self.spare = []        # events to record again
    self.last_end = None   # the end marker of the set popped last
    self.stretch = None    # the last set's stretch, None where unmarked
    self.busy = 0          # marked sets whose end is not yet recorded

  def event(self):
    return self.spare.pop() if self.spare else _event()

  def open(self, stream) -> _Set | None:
    """Mark a new set's start on ``stream``, after popping what has
    completed; None where the device already keeps MARKED_SETS sets."""
    self.resolve()
    if len(self.fifo) >= MARKED_SETS:
      _markers["unmarked_sets"] += 1
      self.stretch = None
      return None
    mark = _Set()
    mark.pending = len(self.fifo)
    mark.paired = self.stretch == _stretch and not self.busy
    self.stretch = _stretch
    mark.start, mark.end = self.event(), None
    mark.start.record(stream)
    self.fifo.append(mark)
    self.busy += 1
    return mark

  def resolve(self) -> None:
    """Pop, front first, every set whose end marker has completed, up to
    the first that has not; wait for none, and time none but those beyond
    UNTIMED_SETS."""
    fifo, untimed = self.fifo, self.untimed
    while fifo and fifo[0].end is not None and fifo[0].end.query():
      mark = fifo.popleft()
      mark.before, self.last_end = self.last_end, mark.end
      untimed.append(mark)
      if len(untimed) > UNTIMED_SETS:
        self.time(untimed.popleft())

  def time(self, mark: _Set) -> None:
    """Add a popped set to the counters; its start marker and the end
    marker before it (which only it still reads) go back to the spares."""
    m = _markers
    m["sets"] += 1
    m["set_device_ns"] += round(mark.start.elapsed_time(mark.end) * 1e6)
    m["in_flight"] += mark.pending
    if mark.paired:
      m["wait_ns"] += round(mark.before.elapsed_time(mark.start) * 1e6)
      m["waited_sets"] += 1
    self.spare.append(mark.start)
    if mark.before is not None:
      self.spare.append(mark.before)

  def flush(self) -> None:
    """Pop what has completed and time every popped set."""
    self.resolve()
    while self.untimed:
      self.time(self.untimed.popleft())


class _SetSpan(_Span):
  """A span that opens a set on a CUDA device: its start marker at entry
  and its end marker at exit, on ``stream``."""
  __slots__ = ("stream", "marks", "marked")

  def __init__(self, name: str, set_id, stream):
    super().__init__(name, set_id)
    self.stream = stream

  def __enter__(self):
    super().__enter__()
    with _lock:
      self.marks = _devices.get(self.stream.device_index)
      if self.marks is None:
        self.marks = _devices[self.stream.device_index] = _Marks()
      self.marked = self.marks.open(self.stream)
    return self

  def __exit__(self, *exc):
    mark = self.marked
    if mark is None:
      return super().__exit__(*exc)
    with _lock:
      end = self.marks.event()
      end.record(self.stream)
      mark.end = end
      self.marks.busy -= 1
    self._close(perf_counter_ns() - self.t0, exc)


def span(name: str, sets=None, device: torch.device | None = None):
  """A span named ``name`` while tracing is on (a no-op while it is off).
  ``sets``: an iterator of set ids (``itertools.count()``): the span opens
  a new set and takes the next id from it; without it the span carries
  the set id of the span it opens in. ``device``: the set's device; on a
  CUDA device the span marks the set on its current stream (the module's
  docstring)."""
  if not ON:
    return _OFF
  set_id = None if sets is None else next(sets)
  stream = None if device is None else _stream(device)
  if stream is None:
    return _Span(name, set_id)
  return _SetSpan(name, set_id, stream)


class _Stages:
  """The stage spans of one step, each ending where the next begins."""
  __slots__ = ("open",)

  def __enter__(self):
    self.open = None
    return self

  def __call__(self, name: str) -> None:
    self.__exit__(None, None, None)
    self.open = _Span(name)
    self.open.__enter__()

  def __exit__(self, *exc):
    if self.open is not None:
      self.open.__exit__(*exc)
      self.open = None


def stages():
  """``with stages() as stage:``, then ``stage(name)`` where each stage of a
  step begins: the stage spans follow one another, the last ending with
  the block. While tracing is off ``stage`` is None, so that a stage site
  costs one check of it."""
  return _Stages() if ON else _OFF


def annotate(name: str):
  """Named trace region: a span of the tracer (in the profile timeline
  while tracing is on and a profiler records)."""
  return span(name)


def launch(kernel: str) -> _Span:
  """The ``isp.launch`` span of one C launcher call of ``kernel``, which
  adds its time to the kernel's ``launch_ns``. The caller checks
  :data:`ON`."""
  return _Span("isp.launch", tag=kernel, counter=_launch_ns)


def load(source: str) -> _Span:
  """The ``isp.load`` span of ``source``'s library's first load, kept
  whether tracing is on or off."""
  return _Span("isp.load", tag=source)


def count_tone(form: str) -> None:
  """Count one launch of a tone kernel in ``form``. The caller checks
  :data:`ON`."""
  with _lock:
    _tone_forms[form] = _tone_forms.get(form, 0) + 1


def count_finish_layout(layout: str) -> None:
  """Count one K4 launch whose output takes ``layout`` (``rows`` or
  ``swap``). The caller checks :data:`ON`."""
  with _lock:
    _finish_layouts[layout] = _finish_layouts.get(layout, 0) + 1


def count_resize_path(path: str) -> None:
  """Count one K12 launch on ``path`` (``aligned`` or ``direct``). The
  caller checks :data:`ON`."""
  with _lock:
    _resize_paths[path] = _resize_paths.get(path, 0) + 1


def count_i420_path(path: str) -> None:
  """Count one launch of a step's I420 kernel on ``path`` (``rows``,
  ``swap``, ``planar_tone`` or ``planar_u8``). The caller checks
  :data:`ON`."""
  with _lock:
    _i420_paths[path] = _i420_paths.get(path, 0) + 1


def count_build(source: str) -> None:
  """Count one nvcc run on ``source``."""
  with _lock:
    _builds[source] = _builds.get(source, 0) + 1


def snapshot() -> dict:
  """The aggregates and counters: ``spans`` {name: {calls, ns, self_ns}},
  ``launch_ns`` {kernel: ns}, ``tone_forms`` {form: launches},
  ``finish_layouts`` {layout: launches}, ``resize_paths`` {path: launches},
  ``i420_paths`` {path: launches}, ``builds`` {source: nvcc runs} and
  ``markers`` {counter: value} (:data:`MARKERS`), after popping every
  marked set that has completed and timing every popped set; it waits for
  none."""
  with _lock:
    for marks in _devices.values():
      marks.flush()
    return {"spans": {name: {"calls": c, "ns": ns, "self_ns": self_ns}
                      for name, (c, ns, self_ns) in _spans.items()},
            "launch_ns": dict(_launch_ns), "tone_forms": dict(_tone_forms),
            "finish_layouts": dict(_finish_layouts),
            "resize_paths": dict(_resize_paths),
            "i420_paths": dict(_i420_paths),
            "builds": dict(_builds), "markers": dict(_markers)}


def reset() -> None:
  """Clear the aggregates and counters, and every device's marked sets
  (ending the stretch of tracing)."""
  global _stretch
  with _lock:
    for d in (_spans, _launch_ns, _tone_forms, _finish_layouts,
              _resize_paths, _i420_paths, _builds, _devices):
      d.clear()
    _markers.update(dict.fromkeys(MARKERS, 0))
    _stretch += 1
