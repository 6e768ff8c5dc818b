"""The readers of the program's own spans and counters on synthetic
snapshots, a program without a tracer read as nothing, the program's spans
left out of the benchmark's own, a whole run's switching of the program's
tracer (on for a traced window, off inside its profiler slices, never
touched by an untraced run), and on the card every kernel launch inside
its ``isp.launch`` span."""

import json
import sys
import tempfile
import types

import pytest

from isp_bench import (compare, harness, inputs, manifest, program_tracer,
                       trace)
from isp_bench.harness import LoopResult, Run
from isp_bench.reference import isp as ref
from isp_bench.trace import Spans

M = manifest.load()
CFG = manifest.config(M, "rig6x4k_f16")
READERS = ("driver_self_ms", "launch_call_ms", "kernel_load_s")
PER_LAYER = [e["name"] for e in manifest.metrics_of(M, "per_layer",
                                                    "rig6x4k_f16.device")]


def _read(name):
  run = Run(CFG, {"color_format": "rgb"}, LoopResult(4, 4, 1.0), 9.0,
            Spans())
  return manifest.module("layer_metrics", name).read(run)


def _program(monkeypatch, snap):
  """A program whose tracer's snapshot is ``snap`` (None: no tracer)."""
  mod = types.SimpleNamespace()
  if snap is not None:
    mod.snapshot = lambda: snap
  monkeypatch.setitem(sys.modules, program_tracer.MODULE, mod)


def _snap(spans=None, launch_ns=None, builds=None, load_ns=None):
  return {"spans": spans or {}, "launch_ns": launch_ns or {},
          "builds": builds or {}, "load_ns": load_ns or {}}


def test_readers_on_a_traced_window(monkeypatch):
  # 4 sets of 300 us, 180 us of it in 5 launches each; 2 loads of 0.3 s
  _program(monkeypatch, _snap(
      spans={"isp.process": {"calls": 4, "ns": 1_200_000, "self_ns": 100},
             "isp.decode": {"calls": 4, "ns": 200_000, "self_ns": 80_000},
             "isp.launch": {"calls": 20, "ns": 720_000, "self_ns": 720_000},
             "isp.load": {"calls": 2, "ns": 600_000_000,
                          "self_ns": 600_000_000}},
      launch_ns={"decode_f16": 120_000, "finish_f16": 600_000},
      builds={"decode.cu": 1}, load_ns={"decode.cu": 550_000_000,
                                        "finish.cu": 50_000_000}))
  assert _read("driver_self_ms") == pytest.approx((1_200_000 - 720_000)
                                                  / 4 / 1e6)
  assert _read("launch_call_ms") == pytest.approx(720_000 / 4 / 1e6)
  assert _read("kernel_load_s") == pytest.approx(0.6)
  # the two add up to the program's process span a set
  assert _read("driver_self_ms") + _read("launch_call_ms") == \
      pytest.approx(0.3)


def test_a_window_the_tracer_did_not_see(monkeypatch):
  # tracing off: only the loads, which are kept regardless
  _program(monkeypatch, _snap(
      spans={"isp.load": {"calls": 5, "ns": 250_000_000,
                          "self_ns": 250_000_000}},
      load_ns={"decode.cu": 250_000_000}))
  assert _read("driver_self_ms") is None
  assert _read("launch_call_ms") is None
  assert _read("kernel_load_s") == pytest.approx(0.25)


def test_sets_with_no_launch_read_no_launch_time(monkeypatch):
  # the plain twins (CPU tensors) launch nothing
  _program(monkeypatch, _snap(
      spans={"isp.process": {"calls": 2, "ns": 5_000_000, "self_ns": 9}}))
  assert _read("driver_self_ms") == pytest.approx(2.5)
  assert _read("launch_call_ms") is None


@pytest.mark.parametrize("snap", [None, _snap()], ids=["no tracer",
                                                       "nothing recorded"])
def test_a_program_without_a_tracer_reads_nothing(monkeypatch, snap):
  _program(monkeypatch, snap)
  assert [_read(name) for name in READERS] == [None, None, None]
  monkeypatch.delitem(sys.modules, program_tracer.MODULE)
  assert program_tracer.snapshot() is None
  assert [_read(name) for name in READERS] == [None, None, None]


def test_the_programs_live_tracer_is_read():
  torch = pytest.importorskip("torch")
  import numpy as np
  from taichi_image_tpu_torch.models.camera_isp import CameraBF16
  from taichi_image_tpu_torch.ops.bayer import BayerPattern
  from taichi_image_tpu_torch.utils import profiling
  profiling.reset()
  isp = CameraBF16(BayerPattern.RGGB, device="cpu")
  raws = torch.from_numpy(np.random.default_rng(0).integers(
      0, 256, (2, 16, 36), dtype=np.uint8))
  try:
    with profiling.tracing():
      for _ in range(3):
        isp.process(raws)
    assert program_tracer.sets(program_tracer.snapshot()) == 3
    assert _read("driver_self_ms") > 0
    assert _read("launch_call_ms") is None   # the CPU launches nothing
  finally:
    profiling.reset()


# -- a whole run on the CPU -----------------------------------------------------

WORKLOAD = "rig6x4k_f16.device"
SEED, SECONDS = 2 ** 31 + 31, 0.6


def _whole_run(trace_on, monkeypatch):
  """A short run of the f16 cell at 2 cameras of 64 x 96, with 2 profiler
  slices of 4 sets, as ``isp_bench.run`` drives it. Returns (the run, the
  program tracer's snapshot, whether it was correct, and (profiling.ON,
  inside a slice) at each ``process`` call, warm-up included)."""
  import torch
  from taichi_image_tpu_torch.utils import profiling
  w = manifest.workload(M, WORKLOAD)
  cfg = dict(manifest.config(M, w["config"]), cameras=2, height=64, width=96)
  traffic = dict(manifest.traffic(w["traffic"]), trace_slices=2,
                 slice_sets=4)
  loop = manifest.module("loops", traffic["loop"])
  calls, inside = [], []
  start, stop = trace.Tracer._start, trace.Tracer._stop

  def _start(self):
    start(self)
    inside.append(True)

  def _stop(self):
    inside.append(False)
    stop(self)
  monkeypatch.setattr(trace.Tracer, "_start", _start)
  monkeypatch.setattr(trace.Tracer, "_stop", _stop)
  make_isp = harness.make_isp

  def recording_isp(*args):
    isp = make_isp(*args)
    process = isp.process

    def record(*a, **kw):
      calls.append((profiling.ON, bool(inside and inside[-1])))
      return process(*a, **kw)
    isp.process = record
    return isp
  monkeypatch.setattr(harness, "make_isp", recording_isp)
  run, ctx = harness.execute(cfg, traffic, SEED, SECONDS, trace_on,
                             torch.device("cpu"), loop)
  snap = program_tracer.snapshot()
  final, kept = harness.free_program(ctx)
  pipe = ref.Pipeline(cfg, ctx.pool, compare.work_dtype(cfg))
  values = compare.readings(pipe, ctx.chain, kept, final,
                            traffic["color_format"])
  correct = compare.judge(values, manifest.limits(WORKLOAD))
  return run, snap, correct, calls


@pytest.fixture
def tracer():
  """The program's tracer, off and cleared, with one kernel library's load
  recorded as set-up records it; off and cleared again after the test."""
  from taichi_image_tpu_torch.utils import profiling
  profiling.disable()
  profiling.reset()
  with profiling.load("decode.cu"):
    pass
  yield profiling
  profiling.disable()
  profiling.reset()


def _readings(run) -> dict:
  return {name: manifest.module("layer_metrics", name).read(run)
          for name in PER_LAYER}


def test_a_traced_run_traces_the_program_outside_its_slices(monkeypatch,
                                                             tracer):
  run, snap, correct, calls = _whole_run(True, monkeypatch)
  assert correct and not tracer.ON
  warm = int(manifest.traffic("device")["warmup_sets"])
  window = calls[warm:]
  assert len(window) == run.loop.attempted and run.slices
  # the tracer off for every set inside a slice, on for every other one
  assert [on for on, _ in calls[:warm]] == [False] * warm
  assert all(on != in_slice for on, in_slice in window)
  in_slices = sum(sl.sets for sl in run.slices)
  assert in_slices == sum(s for _, s in window) > 0
  assert program_tracer.sets(snap) == run.loop.attempted - in_slices > 0
  assert _readings(run)["driver_self_ms"] > 0
  assert program_tracer.spans(snap)[program_tracer.LOAD]["calls"] == 1


@pytest.mark.parametrize("case", ["untraced", "a tracer without enable"])
def test_a_run_that_leaves_the_programs_tracer_off(case, monkeypatch, tracer):
  switched = []
  monkeypatch.setattr(tracer, "enable", lambda: switched.append(True))
  if case != "untraced":
    monkeypatch.delattr(tracer, "enable")
  run, snap, correct, calls = _whole_run(case != "untraced", monkeypatch)
  assert correct and not tracer.ON and switched == []
  assert {on for on, _ in calls} == {False}
  assert program_tracer.PROCESS not in program_tracer.spans(snap)
  assert program_tracer.spans(snap)[program_tracer.LOAD]["calls"] == 1
  readings = _readings(run)
  assert readings.pop("driver_self_ms") is None
  if case != "untraced":
    # otherwise the same metrics read a number as with the tracer on
    monkeypatch.undo()
    on = _readings(_whole_run(True, monkeypatch)[0])
    assert on.pop("driver_self_ms") > 0
    assert ({k: v is None for k, v in readings.items()}
            == {k: v is None for k, v in on.items()})


def test_parse_leaves_the_programs_spans_out_of_the_host_spans():
  events = [
      {"ph": "X", "cat": "user_annotation", "name": "slice", "ts": 1000.0,
       "dur": 500.0},
      {"ph": "X", "cat": "user_annotation", "name": "process", "ts": 1010.0,
       "dur": 40.0},
      {"ph": "X", "cat": "user_annotation", "name": "isp.process set=7",
       "ts": 1011.0, "dur": 38.0},
      {"ph": "X", "cat": "user_annotation", "name": "isp.decode set=7",
       "ts": 1012.0, "dur": 5.0},
      {"ph": "X", "cat": "user_annotation",
       "name": "isp.launch decode_f16 set=7", "ts": 1013.0, "dur": 3.0},
      {"ph": "X", "cat": "user_annotation", "name": "sync", "ts": 1400.0,
       "dur": 90.0},
  ]
  without = [e for e in events if not e["name"].startswith("isp.")]
  families = {"decode": ("decode12_kernel",)}
  sl, bare = (trace.parse(ev, 1, 0, families) for ev in (events, without))
  assert sl.host == bare.host == [("process", 1010.0, 40.0),
                                  ("sync", 1400.0, 90.0)]
  assert sl.device == bare.device == []


# -- on the card --------------------------------------------------------------

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel")


@pytest.mark.card
def test_every_launch_lies_inside_its_launch_span(card):
  import torch
  from torch.profiler import ProfilerActivity, profile
  from taichi_image_tpu_torch.utils import profiling
  isp = harness.make_isp(CFG, card)
  pool = inputs.raw_pool(CFG, 2, 2 ** 31 + 7, card)
  kw = dict(fmt=CFG["raw_format"], gamma=float(CFG["gamma"]))
  for i in range(3):
    isp.process(pool[i % 2], **kw)
  torch.cuda.synchronize(card)
  profiling.reset()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    with profiling.tracing():
      for i in range(20):
        isp.process(pool[i % 2], **kw)
    torch.cuda.synchronize(card)
  with tempfile.TemporaryDirectory() as tmp:
    prof.export_chrome_trace(f"{tmp}/trace.json")
    with open(f"{tmp}/trace.json") as f:
      events = json.load(f)["traceEvents"]
  launches = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
              if e.get("cat") == "cuda_runtime"
              and e.get("name", "").startswith(LAUNCH_CALLS)]
  spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "user_annotation"
           and e.get("name", "").startswith("isp.launch ")]
  inside = sum(any(s <= a and b <= e for s, e in spans)
               for a, b in launches)
  assert len(spans) == 20 * 5
  assert len(launches) >= len(spans) and inside >= 0.99 * len(launches)
  assert program_tracer.sets(program_tracer.snapshot()) == 20
  profiling.reset()
