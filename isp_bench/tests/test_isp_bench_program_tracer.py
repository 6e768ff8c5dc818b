"""The readers of the program's own spans and counters on synthetic
snapshots, a program without a tracer read as nothing, the program's spans
left out of the benchmark's own, and on the card every kernel launch
inside its ``isp.launch`` span."""

import json
import sys
import tempfile
import types

import pytest

from isp_bench import harness, inputs, manifest, program_tracer, trace
from isp_bench.harness import LoopResult, Run
from isp_bench.trace import Spans

M = manifest.load()
CFG = manifest.config(M, "rig6x4k_f16")
READERS = ("driver_self_ms", "launch_call_ms", "kernel_load_s")


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
