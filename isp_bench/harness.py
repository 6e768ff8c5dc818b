"""The benchmark's driver: it builds the system under test from a
configuration, feeds it a cell's traffic through the cell's loop kind,
and hands the run to the metrics and the comparison.

This is the one module that imports the program (``taichi_image_tpu_torch``):
the ISP classes, their enums, and the kernels' launch counter; it also
switches the program's own tracer for a traced run's window.
"""

from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass, field

import torch

from isp_bench import inputs, manifest, program_tracer
from isp_bench.clock import process_age_s
from isp_bench.trace import Spans, Tracer

# top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "taichi_image_tpu")


def forbidden_modules() -> list:
  """The forbidden top-level names in ``sys.modules``, compared whole."""
  tops = {name.split(".", 1)[0] for name in list(sys.modules)}
  return sorted(tops.intersection(FORBIDDEN))


def make_isp(cfg: dict, device: torch.device):
  """The configuration's ISP on ``device``."""
  from taichi_image_tpu_torch.models import camera_isp
  from taichi_image_tpu_torch.ops.bayer import BayerPattern
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform
  cls = getattr(camera_isp, cfg["isp_class"])
  if cls._work_dtype != getattr(torch, cfg["work_dtype"]):
    raise ValueError(f"{cfg['isp_class']} works in {cls._work_dtype}, the "
                     f"configuration states {cfg['work_dtype']}")
  return cls(BayerPattern[cfg["bayer_pattern"]],
             moving_alpha=float(cfg["moving_alpha"]),
             resize_width=int(cfg["resize_width"]),
             correct_colors=bool(cfg["correct_colors"]),
             transform=ImageTransform[cfg["transform"]],
             metering_stride=int(cfg["metering_stride"]), device=device)


def launch_count() -> int:
  """The program's count of kernel launches so far."""
  from taichi_image_tpu_torch.ops import hopper
  return sum(hopper.launch_counts().values())


def program_tracing(on: bool) -> None:
  """Turn the program's own tracer on (its ``enable``) or off (its
  ``disable``); nothing where the loaded program has no such function.
  Never resets it: set-up's ``isp.load`` spans stay for
  ``kernel_load_s``."""
  switch = getattr(sys.modules.get(program_tracer.MODULE),
                   "enable" if on else "disable", None)
  if switch is not None:
    switch()


def kernel_families() -> dict:
  """{kernel family: its kernel symbols}, from ``work/``."""
  return {name: mod.SYMBOLS for name, mod in manifest.modules("work").items()
          if hasattr(mod, "SYMBOLS")}


MARK_EVERY = 256


@dataclass
class LoopResult:
  attempted: int
  completed: int
  window_s: float
  # seconds into the window at which every ``MARK_EVERY``-th set was
  # submitted, for the notes on how steady the window ran
  marks_s: list = field(default_factory=list)

  @property
  def failed(self) -> int:
    return self.attempted - self.completed


@dataclass
class Run:
  """What the metric readers read."""
  cfg: dict
  traffic: dict
  loop: LoopResult
  setup_s: float
  spans: Spans
  slices: list = field(default_factory=list)
  phases: dict = field(default_factory=dict)   # set-up part: seconds


class Context:
  """What a loop kind drives: the ISP, the pool of sets, the chain of
  steps (the pool index of every set the ISP processed, warm-up
  included), the spans and slices of a traced run, and the kept outputs:
  ``keep_sets`` steps of the window drawn from the seed, and the last."""

  def __init__(self, cfg: dict, traffic: dict, seconds: float, seed: int,
               device: torch.device, isp, pool: torch.Tensor, trace: bool):
    self.cfg, self.traffic, self.seconds = cfg, traffic, seconds
    self.device, self.isp, self.pool = device, isp, pool
    self.sets = list(pool)
    self.chain = []
    self.spans = Spans()
    self.tracer = Tracer(trace, int(traffic["trace_slices"]),
                         int(traffic["slice_sets"]), seconds, self.spans,
                         self.sync, self.settle, launch_count,
                         _activities(device),
                         kernel_families() if trace else {},
                         program_tracing=program_tracing)
    self.kwargs = dict(fmt=cfg["raw_format"], ids_format=cfg["ids_format"],
                       gamma=float(cfg["gamma"]),
                       intensity=float(cfg["intensity"]),
                       light_adapt=float(cfg["light_adapt"]),
                       color_adapt=float(cfg["color_adapt"]),
                       color_format=traffic["color_format"],
                       layout=traffic["layout"])
    self._rng = random.Random(seed)
    self._slots, self._seen, self.last = [], 0, None
    self.t_start = self.setup_s = None

  def take(self):
    """(chain position, raws) of the next set."""
    i = len(self.chain) % len(self.sets)
    self.chain.append(i)
    return len(self.chain) - 1, self.sets[i]

  def start_window(self) -> None:
    self.t_start = time.perf_counter()
    self.setup_s = process_age_s()
    self.tracer.start_window(self.t_start)

  def keep(self, pos: int, output) -> None:
    """Offer a window step's output to the kept sample (a reservoir)."""
    self.last = (pos, output)
    k = int(self.traffic["keep_sets"])
    if len(self._slots) < k:
      self._slots.append((pos, output))
    else:
      r = self._rng.randrange(self._seen + 1)
      if r < k:
        self._slots[r] = (pos, output)
    self._seen += 1

  def kept(self) -> dict:
    out = dict(self._slots)
    if self.last is not None:
      out[self.last[0]] = self.last[1]
    return out

  def sync(self) -> None:
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)

  def settle(self) -> None:
    """One small device operation of the benchmark's own, waited for."""
    if self.device.type == "cuda":
      torch.zeros(1, device=self.device)
      torch.cuda.synchronize(self.device)


def _activities(device: torch.device) -> list:
  from torch.profiler import ProfilerActivity
  if device.type == "cuda":
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
  return [ProfilerActivity.CPU]


def wrap_process(ctx: Context) -> None:
  """The benchmark's ``process`` span around the ISP instance's method
  (``process_stream`` calls it through the instance too)."""
  inner = ctx.isp.process

  def process(*args, **kwargs):
    with ctx.spans("process"):
      return inner(*args, **kwargs)
  ctx.isp.process = process



def execute(cfg: dict, traffic: dict, seed: int, seconds: float,
            trace: bool, device: torch.device, loop) -> tuple[Run, Context]:
  """Set up, warm up and run one window of ``loop``. The run's
  ``phases`` hold the seconds of each part of the set-up."""
  phases, t = {}, time.perf_counter()

  def lap(name):
    nonlocal t
    if device.type == "cuda":
      torch.cuda.synchronize(device)
    now = time.perf_counter()
    phases[name] = now - t
    t = now

  torch.empty(0, device=device)
  lap("device")
  isp = make_isp(cfg, device)
  lap("isp")
  pool = inputs.raw_pool(cfg, int(traffic["pool_sets"]), seed, device)
  lap("pool")
  ctx = Context(cfg, traffic, seconds, seed, device, isp, pool, trace)
  if trace:
    wrap_process(ctx)
  loop.warmup(ctx)
  lap("warmup")
  if trace:
    # the profiler's first start loads its tracing library: in set-up
    from torch.profiler import profile
    with profile(activities=_activities(device)):
      ctx.sync()
    lap("profiler")
  ctx.spans.enabled = trace
  if trace:
    # the program's tracer on for the window, off inside each profiler
    # slice (``Tracer``), so the slices read the program as run untraced
    program_tracing(True)
  try:
    result = loop.run(ctx)
  finally:
    ctx.spans.enabled = False
    if trace:
      program_tracing(False)
  return Run(cfg, traffic, result, ctx.setup_s, ctx.spans,
             ctx.tracer.slices, phases), ctx


def free_program(ctx: Context) -> tuple[torch.Tensor, dict]:
  """Drop the ISP and everything of it but the kept outputs; returns
  (its final metering state, the kept outputs)."""
  final = ctx.isp.metrics
  kept = ctx.kept()
  ctx.isp = ctx.last = None
  ctx._slots = []
  if ctx.device.type == "cuda":
    torch.cuda.synchronize(ctx.device)
    torch.cuda.empty_cache()
  return final, kept
