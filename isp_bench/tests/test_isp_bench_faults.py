"""The comparison rejects a broken timed path and the control.

Each test drives a whole run of a cell but the look for a card, at a
small size on the CPU (the port's plain path), and judges it against the
cell's own limits: a sound run is correct; a run whose step returns its
metering state unchanged, whose metering leaves out half of the cameras
(the mean taken over the rest), or whose step alters an answer where it
is produced, is not; nor is any of the configuration's controls, the
program's class one precision down or the reference in a lower
precision, put in the program's place. The cells run on one card, so no
exchange between cards exists to leave out.
"""

import pytest
import torch

from isp_bench import calibrate, compare, harness, manifest
from isp_bench.reference import isp as ref

M = manifest.load()
CELLS = sorted(w["name"] for w in M["workloads"])
CONTROLS = [(w["name"], kind, what) for w in M["workloads"]
            for kind, what in compare.controls(manifest.config(M, w["config"]))]
SEED = 2 ** 31 + 29
SECONDS = 0.3
CPU = torch.device("cpu")


def _run(workload):
  """(values, limits, the run's context and final state and kept
  outputs) of a short run of the cell at a small size."""
  w = manifest.workload(M, workload)
  cfg = dict(manifest.config(M, w["config"]), cameras=2, height=64, width=96)
  traffic = manifest.traffic(w["traffic"])
  loop = manifest.module("loops", traffic["loop"])
  _, ctx = harness.execute(cfg, traffic, SEED, SECONDS, False, CPU, loop)
  final, kept = harness.free_program(ctx)
  pipe = ref.Pipeline(cfg, ctx.pool, compare.work_dtype(cfg))
  values = compare.readings(pipe, ctx.chain, kept, final,
                            traffic["color_format"])
  return values, manifest.limits(workload), (cfg, traffic, loop, ctx, pipe)


def _state_unchanged(monkeypatch):
  from taichi_image_tpu_torch.models import camera_isp
  step = camera_isp.fused_isp_step

  def broken(raws, prev, *args, **kwargs):
    _, out = step(raws, prev, *args, **kwargs)
    return prev, out
  monkeypatch.setattr(camera_isp, "fused_isp_step", broken)


def _half_the_cameras(monkeypatch):
  from taichi_image_tpu_torch.models import camera_isp
  meter = camera_isp._meter

  def broken(sample, *args, **kwargs):
    return meter(sample[: max(sample.shape[0] // 2, 1)], *args, **kwargs)
  monkeypatch.setattr(camera_isp, "_meter", broken)


def _answer_altered(monkeypatch):
  from taichi_image_tpu_torch.models import camera_isp
  step = camera_isp.fused_isp_step

  def broken(*args, **kwargs):
    metrics, out = step(*args, **kwargs)
    first = out[0] if isinstance(out, tuple) else out
    first[0] += 3          # the first camera's image, where it is made
    return metrics, out
  monkeypatch.setattr(camera_isp, "fused_isp_step", broken)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_the_cameras": _half_the_cameras,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
  values, limits, _ = _run(workload)
  assert compare.judge(values, limits), (values, limits)
  assert values["u8_off_max"] <= 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
  FAULTS[fault](monkeypatch)
  values, limits, _ = _run(workload)
  assert not compare.judge(values, limits), (values, limits)


@pytest.mark.parametrize("workload,kind,what", CONTROLS)
def test_control_is_not_correct(workload, kind, what):
  _, limits, (cfg, traffic, loop, ctx, pipe) = _run(workload)
  positions = range(len(ctx.chain) - 3, len(ctx.chain))
  values = calibrate.control_values(kind, what, cfg, traffic, loop, SEED,
                                    SECONDS, CPU, pipe, ctx.pool, ctx.chain,
                                    positions)
  assert not compare.judge(values, limits), (values, limits)
