"""The readers of the program's set markers (``set_device_ms``,
``host_wait_ms``, ``sets_in_flight``) on synthetic snapshots of its tracer:
nothing without a tracer, without ``markers``, without a marked set or with
a set left unmarked, exact values otherwise. On the card a short traced run
of the f16 cell reads a set's span on the card at least its kernels' time,
a full launch queue and no wait on the host."""

import json
import subprocess
import sys
import types

import pytest

from isp_bench import manifest, program_tracer
from isp_bench.harness import LoopResult, Run
from isp_bench.trace import Spans

M = manifest.load()
CELL = "rig6x4k_f16.device"
CFG = manifest.config(M, manifest.workload(M, CELL)["config"])
READERS = ("set_device_ms", "host_wait_ms", "sets_in_flight")


def _read(name):
  run = Run(CFG, {"color_format": "rgb"}, LoopResult(4, 4, 1.0), 9.0,
            Spans(), [])
  return manifest.module("layer_metrics", name).read(run)


def _program(monkeypatch, snap):
  """A program whose tracer's snapshot is ``snap`` (None: no tracer)."""
  mod = types.SimpleNamespace()
  if snap is not None:
    mod.snapshot = lambda: snap
  monkeypatch.setitem(sys.modules, program_tracer.MODULE, mod)


def _snap(markers=None):
  snap = {"spans": {"isp.process": {"calls": 8, "ns": 8_000_000,
                                    "self_ns": 1}},
          "launch_ns": {}, "tone_forms": {}, "finish_layouts": {},
          "resize_paths": {}, "i420_paths": {}, "builds": {}}
  if markers is not None:
    snap["markers"] = markers
  return snap


def _markers(sets, set_device_ns=0, wait_ns=0, waited_sets=0, in_flight=0,
             unmarked_sets=0):
  return dict(sets=sets, set_device_ns=set_device_ns, wait_ns=wait_ns,
              waited_sets=waited_sets, in_flight=in_flight,
              unmarked_sets=unmarked_sets)


def test_the_readers_read_the_markers(monkeypatch):
  _program(monkeypatch, _snap(_markers(
      4, set_device_ns=2_680_000, wait_ns=9_000, waited_sets=3,
      in_flight=4 * 96)))
  assert _read("set_device_ms") == pytest.approx(0.67)
  assert _read("host_wait_ms") == pytest.approx(0.003)
  assert _read("sets_in_flight") == pytest.approx(96.0)


def test_an_empty_queue_reads_zero(monkeypatch):
  _program(monkeypatch, _snap(_markers(2, set_device_ns=1_000_000,
                                       waited_sets=1)))
  assert _read("sets_in_flight") == 0.0 and _read("host_wait_ms") == 0.0


@pytest.mark.parametrize("snap", [None, _snap(), _snap(_markers(0))],
                         ids=["no tracer", "no markers", "no marked set"])
@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing(monkeypatch, snap, name):
  _program(monkeypatch, snap)
  assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_a_set_left_unmarked_reads_nothing(monkeypatch, name):
  """A set beyond the program's bound of pending sets went unmarked: the
  means would cover only some of the sets, so none is read."""
  _program(monkeypatch, _snap(_markers(
      4, set_device_ns=2_680_000, wait_ns=9_000, waited_sets=3,
      in_flight=4 * 96, unmarked_sets=1)))
  assert _read(name) is None


def test_no_wait_without_a_pair_of_sets(monkeypatch):
  _program(monkeypatch, _snap(_markers(1, set_device_ns=700_000)))
  assert _read("host_wait_ms") is None
  assert _read("set_device_ms") == pytest.approx(0.7)


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_module_reads_nothing(monkeypatch, name):
  monkeypatch.delitem(sys.modules, program_tracer.MODULE, raising=False)
  assert _read(name) is None


@pytest.mark.card
def test_the_f16_cell_on_the_card(card):
  out = subprocess.run(
      [sys.executable, "-m", "isp_bench.run", "--workload", CELL,
       "--seed", str(2 ** 31 + 137), "--seconds", "2", "--trace", "1"],
      cwd=manifest.CHECKOUT, capture_output=True, text=True, timeout=900,
      check=True)
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result["correct"] and result["failed"] == 0
  metrics = {k: v["value"] for k, v in result["metrics"].items()}
  assert metrics["set_device_ms"] >= 0.98 * metrics["kernel_ms"]
  assert metrics["sets_in_flight"] >= 10
  assert metrics["host_wait_ms"] < 0.01
