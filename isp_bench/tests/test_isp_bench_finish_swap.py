"""The reader of K4's axis-swap launches a set (``finish_swap_per_set``)
on synthetic snapshots of the program's tracer, a program without a tracer
or without the counter read as nothing, and on the card each cell's route
counted as it runs: every f32 set through the swap kernel (rotate_90), no
f16 set."""

import sys
import types

import pytest

from isp_bench import harness, inputs, manifest, program_tracer
from isp_bench.harness import LoopResult, Run
from isp_bench.trace import Spans

M = manifest.load()
NAME = "finish_swap_per_set"


def _read(cfg_name="scan6x4k_f32_rot90"):
  run = Run(manifest.config(M, cfg_name), {"color_format": "rgb"},
            LoopResult(4, 4, 1.0), 9.0, Spans())
  return manifest.module("layer_metrics", NAME).read(run)


def _program(monkeypatch, snap):
  """A program whose tracer's snapshot is ``snap`` (None: no tracer)."""
  mod = types.SimpleNamespace()
  if snap is not None:
    mod.snapshot = lambda: snap
  monkeypatch.setitem(sys.modules, program_tracer.MODULE, mod)


def _snap(sets, finish_layouts=None):
  spans = ({"isp.process": {"calls": sets, "ns": 1_000_000 * sets,
                            "self_ns": 1}} if sets else {})
  snap = {"spans": spans, "launch_ns": {}, "tone_forms": {"pow_rcp": sets},
          "builds": {}, "load_ns": {}}
  if finish_layouts is not None:
    snap["finish_layouts"] = finish_layouts
  return snap


@pytest.mark.parametrize("layouts,want", [
    ({"swap": 4}, 1.0),
    ({"swap": 2, "rows": 2}, 0.5),
    ({"rows": 4}, 0.0),
    ({"swap": 8}, 2.0),
], ids=["every set", "half the sets", "rows only", "two a set"])
def test_swap_launches_a_set(monkeypatch, layouts, want):
  _program(monkeypatch, _snap(4, layouts))
  assert _read() == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    None, _snap(0), _snap(0, {"swap": 3}), _snap(4, {}), _snap(4)],
    ids=["no tracer", "nothing recorded", "no set", "no K4 launch",
         "no layout counter"])
def test_nothing_to_read(monkeypatch, snap):
  _program(monkeypatch, snap)
  assert _read() is None


def test_a_program_without_the_module_reads_nothing(monkeypatch):
  monkeypatch.delitem(sys.modules, program_tracer.MODULE, raising=False)
  assert _read() is None


@pytest.mark.card
@pytest.mark.parametrize("cfg_name,want", [("rig6x4k_f16", 0.0),
                                           ("scan6x4k_f32_rot90", 1.0)])
def test_each_cells_route_on_the_card(card, cfg_name, want):
  import torch
  from taichi_image_tpu_torch.utils import profiling
  cfg = manifest.config(M, cfg_name)
  isp = harness.make_isp(cfg, card)
  pool = inputs.raw_pool(cfg, 2, 2 ** 31 + 26, card)
  kw = dict(fmt=cfg["raw_format"], gamma=float(cfg["gamma"]))
  for i in range(2):
    isp.process(pool[i % 2], **kw)
  torch.cuda.synchronize(card)
  profiling.reset()
  try:
    with profiling.tracing():
      for i in range(6):
        isp.process(pool[i % 2], **kw)
    torch.cuda.synchronize(card)
    assert program_tracer.sets(program_tracer.snapshot()) == 6
    assert _read(cfg_name) == want
  finally:
    profiling.reset()
