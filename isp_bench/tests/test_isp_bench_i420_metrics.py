"""The readers of K4's I420 mode: its launches a set (``i420_rows_per_set``)
on synthetic snapshots of the program's tracer, and its share of its bound
(``finish_yuv420_roofline``) on synthetic trace slices; where there is
nothing to read, each reads nothing. On the card a short traced run of the
I420 cell is correct and reports each of its metrics, every set's I420
from K4's I420 mode and none through the byte tables."""

import json
import subprocess
import sys
import types

import pytest

from isp_bench import manifest, peaks, program_tracer, reduce
from isp_bench.harness import LoopResult, Run
from isp_bench.trace import DeviceOp, Slice, Spans

M = manifest.load()
CELL = "rig6x4k_f16.device_i420"
CFG = manifest.config(M, manifest.workload(M, CELL)["config"])
ROWS, ROOFLINE = "i420_rows_per_set", "finish_yuv420_roofline"
# the kernel's label in a trace: its demangled name, cut to 60 characters
LABEL = "void (anonymous namespace)::finish_yuv420_kernel<__half, fa"


def _read(name, slices=()):
  run = Run(CFG, {"color_format": "yuv420"}, LoopResult(4, 4, 1.0), 9.0,
            Spans(), list(slices))
  return manifest.module("layer_metrics", name).read(run)


def _program(monkeypatch, snap):
  """A program whose tracer's snapshot is ``snap`` (None: no tracer)."""
  mod = types.SimpleNamespace()
  if snap is not None:
    mod.snapshot = lambda: snap
  monkeypatch.setitem(sys.modules, program_tracer.MODULE, mod)


def _snap(sets, i420_paths=None):
  spans = ({"isp.process": {"calls": sets, "ns": 1_000_000 * sets,
                            "self_ns": 1}} if sets else {})
  snap = {"spans": spans, "launch_ns": {}, "tone_forms": {"pow_rcp": sets},
          "finish_layouts": {}, "resize_paths": {}, "builds": {},
          "load_ns": {}}
  if i420_paths is not None:
    snap["i420_paths"] = i420_paths
  return snap


@pytest.mark.parametrize("paths,want", [
    ({"rows": 4}, 1.0),
    ({"rows": 1, "swap": 3}, 0.25),
    ({"rows": 2, "planar_tone": 1, "planar_u8": 1}, 0.5),
    ({"planar_u8": 4}, 0.0),
], ids=["rows only", "rows and swap", "rows and planar", "planar_u8 only"])
def test_rows_launches_a_set(monkeypatch, paths, want):
  _program(monkeypatch, _snap(4, paths))
  assert _read(ROWS) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    None, _snap(0), _snap(0, {"rows": 3}), _snap(4, {}), _snap(4)],
    ids=["no tracer", "nothing recorded", "no set", "no I420 launch",
         "no path counter"])
def test_rows_reads_nothing(monkeypatch, snap):
  _program(monkeypatch, snap)
  assert _read(ROWS) is None


def test_a_program_without_the_module_reads_nothing(monkeypatch):
  monkeypatch.delitem(sys.modules, program_tracer.MODULE, raising=False)
  assert _read(ROWS) is None


def _bound_us():
  work = manifest.module("work", "finish_yuv420")
  return 1e6 * max(work.logical_bytes(CFG, "yuv420") / peaks.HBM_BYTES_S,
                   work.ops(CFG, "yuv420") / peaks.F32_FLOPS)


def _slice(ops, launches=None):
  device = [DeviceOp(reduce.KERNEL, label, ts, dur) for label, ts, dur in ops]
  return Slice(0.0, 1e4, 2, len(device) if launches is None else launches,
               device)


def test_the_bound_is_the_bytes():
  work = manifest.module("work", "finish_yuv420")
  # p in (3 f16 values a pixel), Y and VU out (1.5 bytes a pixel), the maxima
  assert work.logical_bytes(CFG, "yuv420") == 373_248_024
  assert _bound_us() == pytest.approx(373_248_024 / peaks.HBM_BYTES_S * 1e6)


def test_a_kernel_at_its_bound_reads_100():
  b = _bound_us()
  sl = _slice([("decode", 0, 50.0), (LABEL, 100, b), (LABEL, 300, b)])
  assert _read(ROOFLINE, [sl]) == pytest.approx(100.0)


def test_the_mean_launch_over_the_complete_slices():
  b = _bound_us()
  whole = [_slice([(LABEL, 0, 2 * b), (LABEL, 100, 4 * b)]),
           _slice([(LABEL, 0, 3 * b)])]
  # a slice that lost a kernel's record is left out
  lossy = _slice([(LABEL, 0, 100 * b)], launches=2)
  assert _read(ROOFLINE, whole + [lossy]) == pytest.approx(100.0 / 3)


@pytest.mark.parametrize("label", [
    "finish", "void (anonymous namespace)::i420_tile_kernel<__half, (I420)",
    "void yuv420_planar_tone_kernel<float>()",
    "void finish_yuv420_kernel_v2<float>()"],
    ids=["K4's RGB family", "the I420 tile kernel", "the planar form",
         "a longer name"])
def test_the_roofline_selects_its_kernel_by_whole_word(label):
  sl = _slice([("decode", 0, 50.0), (label, 100, 40.0)])
  assert _read(ROOFLINE, [sl]) is None
  assert _read(ROOFLINE, [_slice([(label, 100, 40.0), (LABEL, 200, 40.0)])]) \
      == pytest.approx(100.0 * _bound_us() / 40.0)


def test_the_roofline_reads_nothing_without_a_complete_slice():
  assert _read(ROOFLINE) is None
  assert _read(ROOFLINE, [_slice([(LABEL, 0, 40.0)], launches=2)]) is None


@pytest.mark.card
def test_the_i420_cell_on_the_card(card):
  out = subprocess.run(
      [sys.executable, "-m", "isp_bench.run", "--workload", CELL,
       "--seed", str(2 ** 31 + 131), "--seconds", "2", "--trace", "1"],
      cwd=manifest.CHECKOUT, capture_output=True, text=True, timeout=900,
      check=True)
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result["correct"] and result["failed"] == 0
  metrics = result["metrics"]
  assert set(metrics) == {e["name"] for e in
                          manifest.metrics_of(M, "per_layer", CELL)}
  assert metrics[ROWS]["value"] == 1.0
  assert metrics["tone_table_per_set"]["value"] == 0.0
  assert 0 < metrics[ROOFLINE]["value"] <= 100
