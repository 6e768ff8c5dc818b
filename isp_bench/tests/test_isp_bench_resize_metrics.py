"""The readers of the resize route's kernels: K12's aligned launches a set
(``resize_aligned_per_set``) on synthetic snapshots of the program's
tracer, and K12's and P's shares of their bounds (``resize_roofline``,
``planar_tone_roofline``) on synthetic trace slices; where there is
nothing to read, each reads nothing. On the card a short traced run of the
resized cell is correct and reports each of its metrics, every set's
resize on the aligned path."""

import json
import subprocess
import sys
import types

import pytest

from isp_bench import manifest, peaks, program_tracer, reduce
from isp_bench.harness import LoopResult, Run
from isp_bench.trace import DeviceOp, Slice, Spans

M = manifest.load()
CELL = "rig6x4k_f16_w1920.device"
CFG = manifest.config(M, "rig6x4k_f16_w1920")
ROOFLINES = {"resize_roofline": "resize",
             "planar_tone_roofline": "planar_tone"}


def _read(name, slices=()):
  run = Run(CFG, {"color_format": "rgb"}, LoopResult(4, 4, 1.0), 9.0,
            Spans(), list(slices))
  return manifest.module("layer_metrics", name).read(run)


def _program(monkeypatch, snap):
  """A program whose tracer's snapshot is ``snap`` (None: no tracer)."""
  mod = types.SimpleNamespace()
  if snap is not None:
    mod.snapshot = lambda: snap
  monkeypatch.setitem(sys.modules, program_tracer.MODULE, mod)


def _snap(sets, resize_paths=None):
  spans = ({"isp.process": {"calls": sets, "ns": 1_000_000 * sets,
                            "self_ns": 1}} if sets else {})
  snap = {"spans": spans, "launch_ns": {}, "tone_forms": {"pow_rcp": sets},
          "finish_layouts": {}, "builds": {}, "load_ns": {}}
  if resize_paths is not None:
    snap["resize_paths"] = resize_paths
  return snap


@pytest.mark.parametrize("paths,want", [
    ({"aligned": 4}, 1.0),
    ({"aligned": 1, "direct": 3}, 0.25),
    ({"direct": 4}, 0.0),
], ids=["aligned only", "mixed", "direct only"])
def test_aligned_launches_a_set(monkeypatch, paths, want):
  _program(monkeypatch, _snap(4, paths))
  assert _read("resize_aligned_per_set") == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    None, _snap(0), _snap(0, {"aligned": 3}), _snap(4, {}), _snap(4)],
    ids=["no tracer", "nothing recorded", "no set", "no K12 launch",
         "no path counter"])
def test_aligned_reads_nothing(monkeypatch, snap):
  _program(monkeypatch, snap)
  assert _read("resize_aligned_per_set") is None


def test_a_program_without_the_module_reads_nothing(monkeypatch):
  monkeypatch.delitem(sys.modules, program_tracer.MODULE, raising=False)
  assert _read("resize_aligned_per_set") is None


def _bound_us(family):
  work = manifest.module("work", family)
  return 1e6 * max(work.logical_bytes(CFG, "rgb") / peaks.HBM_BYTES_S,
                   work.ops(CFG, "rgb") / peaks.F32_FLOPS)


def _slice(ops, launches=None):
  device = [DeviceOp(reduce.KERNEL, label, ts, dur) for label, ts, dur in ops]
  return Slice(0.0, 1e4, 2, len(device) if launches is None else launches,
               device)


@pytest.mark.parametrize("name", ROOFLINES)
def test_a_kernel_at_its_bound_reads_100(name):
  fam = ROOFLINES[name]
  b = _bound_us(fam)
  sl = _slice([("decode", 0, 50.0), (fam, 100, b), (fam, 300, b)])
  assert _read(name, [sl]) == pytest.approx(100.0)


@pytest.mark.parametrize("name", ROOFLINES)
def test_the_mean_launch_over_the_complete_slices(name):
  fam = ROOFLINES[name]
  b = _bound_us(fam)
  whole = [_slice([(fam, 0, 2 * b), (fam, 100, 4 * b)]),
           _slice([(fam, 0, 3 * b)])]
  # a slice that lost a kernel's record is left out
  lossy = _slice([(fam, 0, 100 * b)], launches=2)
  assert _read(name, whole + [lossy]) == pytest.approx(100.0 / 3)


@pytest.mark.parametrize("name", ROOFLINES)
def test_a_roofline_reads_nothing_without_its_kernel(name):
  other = "planar_tone" if ROOFLINES[name] == "resize" else "resize"
  assert _read(name) is None
  assert _read(name, [_slice([("decode", 0, 50.0), (other, 100, 40.0)])]) \
      is None
  assert _read(name, [_slice([(ROOFLINES[name], 0, 40.0)], launches=2)]) \
      is None


@pytest.mark.card
def test_the_resized_cell_on_the_card(card):
  out = subprocess.run(
      [sys.executable, "-m", "isp_bench.run", "--workload", CELL,
       "--seed", str(2 ** 31 + 127), "--seconds", "2", "--trace", "1"],
      cwd=manifest.CHECKOUT, capture_output=True, text=True, timeout=900,
      check=True)
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result["correct"] and result["failed"] == 0
  metrics = result["metrics"]
  assert set(metrics) == {e["name"] for e in
                          manifest.metrics_of(M, "per_layer", CELL)}
  assert metrics["resize_aligned_per_set"]["value"] == 1.0
  for name in ROOFLINES:
    assert 0 < metrics[name]["value"] <= 100, name
