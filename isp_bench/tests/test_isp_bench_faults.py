"""The comparison rejects a broken timed path and the control.

Each test drives a whole run of a cell but the look for a card, at a
small size on the CPU (the port's plain path), and judges it against the
cell's own limits: a sound run is correct; a run whose step returns its
metering state unchanged, whose metering leaves out half of the cameras
(the mean taken over the rest), whose step alters an answer where it is
produced, or, on the resize route, whose resize reads its taps one
full-resolution pixel off, is not; nor is any of the configuration's
controls, the program's class one precision down or the reference in a
lower precision, put in the program's place. The cells run on one card,
so no exchange between cards exists to leave out.

Beside the manifest's cells runs a resized rig (``ADDED``: the f16 rig
with ``resize_width`` 1920, under the f16 rig's limits) that a copy of
the benchmark holds as new files and manifest entries only: the harness
takes the resize route without an edit.
"""

import json
import shutil

import pytest
import torch

from isp_bench import calibrate, compare, harness, manifest
from isp_bench.reference import isp as ref

M = manifest.load()
ADDED = "rig6x4k_f16_w1920.device"
CELLS = sorted(w["name"] for w in M["workloads"]) + [ADDED]
CONTROLS = [(w["name"], kind, what) for w in M["workloads"]
            for kind, what in compare.controls(manifest.config(M, w["config"]))
            ] + [(ADDED, kind, what) for kind, what in
                 compare.controls(manifest.config(M, "rig6x4k_f16"))]
SEED = 2 ** 31 + 29
SECONDS = 0.3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def added(tmp_path_factory):
  """A checkout whose benchmark is this one with ``ADDED`` added as new
  files (its configuration and limits) and manifest entries only."""
  root = tmp_path_factory.mktemp("checkout")
  pkg = root / "isp_bench"
  shutil.copytree(manifest.PACKAGE, pkg,
                  ignore=shutil.ignore_patterns("__pycache__"))
  name = "rig6x4k_f16_w1920"
  cfg = dict(manifest.config(M, "rig6x4k_f16"), name=name, resize_width=1920)
  (pkg / "configs" / f"{name}.json").write_text(json.dumps(cfg))
  shutil.copy(pkg / "limits" / "rig6x4k_f16.device.json",
              pkg / "limits" / f"{ADDED}.json")
  m = json.loads(json.dumps(M))
  m["configs"].append({"name": name, "source": "x",
                       "file": f"isp_bench/configs/{name}.json",
                       "reduced": [], "why": "x"})
  m["workloads"].append({"name": ADDED, "config": name, "traffic": "device",
                         "chips": 1, "why": "x"})
  for e in m["end_to_end"] + m["per_layer"]:
    if "workloads" in e:
      e["workloads"].append(ADDED)
  (root / "BENCHMARK.json").write_text(json.dumps(m))
  return root


def _bench(workload, added):
  """(manifest, checkout) that hold the cell."""
  if workload == ADDED:
    return manifest.load(added / "BENCHMARK.json"), added
  return M, manifest.CHECKOUT


def _run(workload, added):
  """(values, limits, the run's context and final state and kept
  outputs) of a short run of the cell at a small size: 2 cameras of
  64 x 96, a resize cut with the width so that its ratio holds."""
  m, root = _bench(workload, added)
  pkg = root / "isp_bench"
  w = manifest.workload(m, workload)
  cfg = manifest.config(m, w["config"], root=root)
  cfg = dict(cfg, cameras=2, height=64, width=96,
             resize_width=int(cfg["resize_width"]) * 96 // cfg["width"])
  traffic = manifest.traffic(w["traffic"], package=pkg)
  loop = manifest.module("loops", traffic["loop"], package=pkg)
  _, ctx = harness.execute(cfg, traffic, SEED, SECONDS, False, CPU, loop)
  final, kept = harness.free_program(ctx)
  pipe = ref.Pipeline(cfg, ctx.pool, compare.work_dtype(cfg))
  values = compare.readings(pipe, ctx.chain, kept, final,
                            traffic["color_format"])
  return (values, manifest.limits(workload, package=pkg),
          (cfg, traffic, loop, ctx, pipe))


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


def _resize_off(monkeypatch):
  """The resize's taps one full-resolution row and column on (clamped to
  the frame). At x0.5 every fraction is 0, so only moved taps show."""
  from taichi_image_tpu_torch.models import camera_isp
  from taichi_image_tpu_torch.ops.hopper import resize
  taps = camera_isp._resize_taps

  def broken(hh, wh, size, scale, device):
    t = taps(hh, wh, size, scale, device)

    def on(a, n):
      return (a.cpu() + 1).clamp_max(n - 1).numpy()
    return resize._device_taps(
        hh, wh, (on(t.r_lo, 2 * hh), on(t.r_hi, 2 * hh), t.r_f.cpu().numpy()),
        (on(t.c_lo, 2 * wh), on(t.c_hi, 2 * wh), t.c_f.cpu().numpy()), device)
  monkeypatch.setattr(camera_isp, "_resize_taps", broken)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_the_cameras": _half_the_cameras,
          "answer_altered": _answer_altered,
          "resize_off": _resize_off}
# faults that only a cell on the resize route can have
RESIZE_ONLY = {"resize_off"}
RESIZED = {ADDED} | {w["name"] for w in M["workloads"]
                     if manifest.config(M, w["config"])["resize_width"] > 0}
CELL_FAULTS = [(w, f) for w in CELLS for f in sorted(FAULTS)
               if w in RESIZED or f not in RESIZE_ONLY]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, added):
  values, limits, _ = _run(workload, added)
  assert compare.judge(values, limits), (values, limits)
  assert values["u8_off_max"] <= 1


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_fault_is_not_correct(workload, fault, monkeypatch, added):
  FAULTS[fault](monkeypatch)
  values, limits, _ = _run(workload, added)
  assert not compare.judge(values, limits), (values, limits)


@pytest.mark.parametrize("workload,kind,what", CONTROLS)
def test_control_is_not_correct(workload, kind, what, added):
  _, limits, (cfg, traffic, loop, ctx, pipe) = _run(workload, added)
  positions = range(len(ctx.chain) - 3, len(ctx.chain))
  values = calibrate.control_values(kind, what, cfg, traffic, loop, SEED,
                                    SECONDS, CPU, pipe, ctx.pool, ctx.chain,
                                    positions)
  assert not compare.judge(values, limits), (values, limits)
