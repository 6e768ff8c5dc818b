"""Camera sharding of the PyTorch port (``parallel/sharding.py``) against
the JAX package's, on the CPU.

The port's ranks are processes joined in a gloo group, started by the
package's own helper (``parallel.run_ranks``) running
``parallel.dryrun.run_variants`` on the plain twins; each world size is
started once for the file (a module-scoped fixture runs every case of
it) and hands each test its numpy results. The JAX side runs in this
process on its 8 virtual CPU devices (tests/conftest.py).

Contracts, the cases of tests/test_sharding.py at 2 and 4 ranks:
  * metrics within 1e-5 of both JAX's sharded step and its unsharded
    ``process``; u8 and I420 within 1 count (2 in bf16, on < 0.1% of
    bytes, as tests/test_torch_resize.py's ``compare_step`` allows), on
    < 1% of bytes (tests/test_spatial.py:87-88);
  * against the port's own unsharded step (each rank, its part): the
    same, and the same metrics on every rank;
  * the camera step issues only the metering's three all_reduce calls;
    the row step adds only its halo exchange (one all_gather) and the
    row max (one all_reduce), counted by wrapping ``torch.distributed``
    in this process around a one-rank gloo group.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
from taichi_image_tpu.ops import packed as jpacked  # noqa: E402
from taichi_image_tpu.parallel import (  # noqa: E402
    make_camera_mesh as jmake_camera_mesh, replicate as jreplicate,
    shard_cameras as jshard_cameras,
    sharded_step_for_isp as jsharded_step_for_isp)
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu_torch import parallel  # noqa: E402
from taichi_image_tpu_torch.parallel import dryrun  # noqa: E402
from conftest import make_test_rgb  # noqa: E402
from oracle import rgb_to_bayer_oracle  # noqa: E402

WORLDS = (2, 4)
JCLASSES = {"Camera16": jtit.Camera16, "Camera32": jtit.Camera32,
            "CameraBF16": jtit.CameraBF16}
SCALARS = ("gamma", "intensity", "light_adapt", "color_adapt")


def rig(n, h=64, w=96, pattern="RGGB"):
  """The JAX tests' rig: n packed12 frames of make_test_rgb scenes."""
  return np.stack([np.asarray(jpacked.encode12(
      rgb_to_bayer_oracle(make_test_rgb(h, w, seed=s), pattern),
      scaled=True)) for s in range(n)])


def spawn_cases(cases):
  """Run every case on its world size, each world once and all at once
  (one thread per world); returns {case name: rank 0's result}."""
  by_world = {}
  for c in cases:
    by_world.setdefault(c["world"], []).append(c)
  got, errors = {}, []

  def run(n, specs):
    try:
      res = parallel.run_ranks(dryrun.run_variants, n, specs, "cpu", True)
      got.update((r["name"], r) for r in res[0])
    except Exception as e:  # raised in the calling thread below
      errors.append(e)

  threads = [threading.Thread(target=run, args=item)
             for item in by_world.items()]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  if errors:
    raise errors[0]
  return got


def jax_isp(case):
  kw = dict(case.get("isp_kw", {}))
  if "transform" in kw:
    kw["transform"] = jtit.ImageTransform[kw["transform"]]
  return JCLASSES[case["cls"]](jtit.BayerPattern[case.get("pattern",
                                                          "RGGB")], **kw)


def proc_kwargs(case):
  return dict(tonemap=case.get("tonemap", "reinhard"),
              **case.get("proc", {}))


def jax_unsharded(case, raws):
  """[(metrics, outputs)] of the JAX ``process`` chained over the case's
  steps."""
  isp = jax_isp(case)
  kw = proc_kwargs(case)
  if case.get("color_format", "rgb") != "rgb":
    kw["color_format"] = case["color_format"]
  res = []
  for _ in range(case.get("steps", 1)):
    out = isp.process(raws, **kw)
    res.append((np.asarray(isp.metrics), outs_np(out)))
  return res


def outs_np(out):
  return tuple(np.asarray(o) for o in (out if isinstance(out, tuple)
                                       else (out,)))


def assert_close(m_port, o_port, m_ref, o_ref, bf16):
  """The port's (metrics, outputs) against a reference's."""
  np.testing.assert_allclose(m_port, m_ref, rtol=0, atol=1e-5)
  for a, b in zip(o_port, o_ref, strict=True):
    a, b = a.astype(np.int64), b.astype(np.int64)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert d.max() <= (2 if bf16 else 1), d.max()
    assert (d > 1).mean() < 1e-3, (d > 1).mean()
    assert (d != 0).mean() < 0.01, (d != 0).mean()


def assert_vs_port(result, bf16):
  """Each rank's part against the port's unsharded step: metrics within
  1e-5, u8 within 1 count (2 in bf16, on < 0.1% of bytes: the sharded
  metering's sums associate differently, and a p that rounds to the
  neighbouring bf16 value moves a pixel by up to a count more), on < 1%
  of bytes; the same metrics on every rank."""
  assert result["metrics_d"] <= 1e-5, result
  assert result["u8_d"] <= (2 if bf16 else 1), result
  assert result["share2"] < 1e-3, result
  assert result["share"] < 0.01, result
  assert result["spread"] == 0.0, result
  assert not result["launches"], result  # the plain twins on the CPU


def check_case(case, result, jax_sharded=None):
  """The port's kept steps against JAX's unsharded ``process`` and, when
  given, JAX's sharded [(metrics, outputs)]."""
  bf16 = case["cls"] == "CameraBF16"
  assert_vs_port(result, bf16)
  raws = case["raws"]
  want = jax_unsharded(case, raws)
  assert len(result["kept"]) == len(want)
  for k, (m, outs, _) in enumerate(result["kept"]):
    assert_close(m, outs, *want[k], bf16)
    if jax_sharded is not None:
      assert_close(m, outs, *jax_sharded[k], bf16)


def jax_camera_sharded(case, n):
  """JAX's camera-sharded step on an n-device mesh, chained like
  ``process`` (t = 0, then 1 - moving_alpha)."""
  raws = case["raws"]
  isp = jax_isp(case)
  mesh = jmake_camera_mesh(n)
  step = jsharded_step_for_isp(isp, mesh, raws.shape,
                               tonemap=case.get("tonemap", "reinhard"))
  proc = dict(gamma=1.0, intensity=1.0, light_adapt=1.0, color_adapt=0.0)
  proc.update(case.get("proc", {}))
  m = jreplicate(jnp.zeros(9, jnp.float32), mesh)
  r = jshard_cameras(jnp.asarray(raws), mesh)
  res = []
  for k in range(case.get("steps", 1)):
    t = 0.0 if k == 0 else 1.0 - isp.moving_alpha
    m, out = step(r, m, jnp.float32(t),
                  *(jnp.float32(proc[s]) for s in SCALARS))
    res.append((np.asarray(m), outs_np(out)))
  return res


def _camera_cases():
  cases = []
  for n in WORLDS:
    for cls in JCLASSES:
      cases.append(dict(name=f"match-{cls}-{n}", world=n, kind="camera",
                        cls=cls, isp_kw=dict(moving_alpha=0.2),
                        proc=dict(gamma=0.8, intensity=2.0),
                        raws=rig(8)))
    cases += [
        dict(name=f"ema2-{n}", world=n, kind="camera", cls="Camera32",
             isp_kw=dict(moving_alpha=0.3), raws=rig(4), steps=2),
        dict(name=f"resize-rot90-{n}", world=n, kind="camera",
             cls="Camera32",
             isp_kw=dict(resize_width=48, transform="rotate_90"),
             raws=rig(4)),
        dict(name=f"linear-{n}", world=n, kind="camera", cls="Camera32",
             isp_kw=dict(moving_alpha=0.2), tonemap="linear",
             proc=dict(gamma=0.8), raws=rig(4)),
        dict(name=f"direct-{n}", world=n, kind="camera", cls="Camera32",
             direct=True, raws=np.random.default_rng(0).integers(
                 0, 256, size=(4, 32, 72), dtype=np.uint8)),
        dict(name=f"i420-{n}", world=n, kind="camera", cls="CameraBF16",
             color_format="yuv420", proc=dict(gamma=0.8, intensity=2.0),
             raws=rig(4)),
        dict(name=f"refuse-cameras-{n}", world=n, kind="refuse",
             kind_of="camera", kwargs=dict(shape=(n + 1, 8, 24))),
    ]
  return cases


CASES = {c["name"]: c for c in _camera_cases()}


@pytest.fixture(scope="module")
def ranks():
  return spawn_cases(CASES.values())


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("cls", JCLASSES)
def test_sharded_step_matches_single_device(ranks, cls, n):
  case = CASES[f"match-{cls}-{n}"]
  check_case(case, ranks[case["name"]], jax_camera_sharded(case, n))


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_ema_second_step(ranks, n):
  case = CASES[f"ema2-{n}"]
  check_case(case, ranks[case["name"]], jax_camera_sharded(case, n))


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_with_resize_transform(ranks, n):
  case = CASES[f"resize-rot90-{n}"]
  res = ranks[case["name"]]
  check_case(case, res, jax_camera_sharded(case, n))
  assert res["kept"][0][1][0].shape == (4, 3, 48, 32)


@pytest.mark.parametrize("n", WORLDS)
def test_output_sharding_layout(ranks, n):
  """Each rank's output holds its own cameras; the metrics are the same
  on every rank."""
  res = ranks[f"match-Camera32-{n}"]
  assert res["kept"][0][2] == [(8 // n, 3, 64, 96)]
  assert res["kept"][0][1][0].shape == (8, 3, 64, 96)
  assert res["spread"] == 0.0


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_linear_tonemap(ranks, n):
  case = CASES[f"linear-{n}"]
  check_case(case, ranks[case["name"]], jax_camera_sharded(case, n))


@pytest.mark.parametrize("n", WORLDS)
def test_make_sharded_isp_step_builder(ranks, n):
  case = CASES[f"direct-{n}"]
  check_case(case, ranks[case["name"]], jax_camera_sharded(case, n))


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_step_yuv420(ranks, n):
  """``color_format`` passes through to the step (the JAX camera-sharded
  step has no I420: held to its unsharded I420 ``process``)."""
  case = CASES[f"i420-{n}"]
  res = ranks[case["name"]]
  check_case(case, res)
  assert res["kept"][0][2] == [(4 // n, 64, 96), (4 // n, 2, 32, 48)]


@pytest.mark.parametrize("n", WORLDS)
def test_shard_cameras_refuses_uneven(ranks, n):
  assert "do not divide" in ranks[f"refuse-cameras-{n}"]["error"]


# --------------------------------------------------------------------------
# The collectives each step issues, counted in this process around a
# one-rank gloo group (every rank issues the same calls).
# --------------------------------------------------------------------------

_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "broadcast", "reduce", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "gather", "scatter", "send", "recv", "isend", "irecv",
                "barrier", "all_gather_object", "broadcast_object_list")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
  """A one-rank gloo group in this process."""
  assert not dist.is_initialized()
  path = tmp_path_factory.mktemp("world1") / "rendezvous"
  dist.init_process_group("gloo", init_method=f"file://{path}",
                          world_size=1, rank=0)
  yield
  dist.destroy_process_group()


@pytest.fixture
def calls(monkeypatch):
  """Every torch.distributed collective wrapped to count its calls."""
  counts = {}
  for name in _COLLECTIVES:
    fn = getattr(dist, name, None)
    if fn is None:
      continue

    def wrapper(*a, _fn=fn, _name=name, **k):
      counts[_name] = counts.get(_name, 0) + 1
      return _fn(*a, **k)
    monkeypatch.setattr(dist, name, wrapper)
  return counts


def _step_args(raws):
  return (torch.from_numpy(raws), torch.zeros(9), 0.9, 1.0, 1.0, 1.0, 0.0)


def test_camera_step_issues_only_the_metering_all_reduces(world1, calls):
  from torch.distributed.device_mesh import init_device_mesh
  raws = rig(2)
  mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("cam",))
  isp = ttit.Camera32(ttit.BayerPattern.RGGB, device="cpu")
  step = parallel.sharded_step_for_isp(isp, mesh, raws.shape)
  calls.clear()
  step(*_step_args(raws))
  assert calls == {"all_reduce": 3}, calls


@pytest.mark.parametrize("tonemap,reduces", [("reinhard", 4), ("linear", 3)])
def test_row_step_adds_only_the_halo_and_the_row_max(world1, calls, tonemap,
                                                     reduces):
  from torch.distributed.device_mesh import init_device_mesh
  raws = rig(2)
  mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("rows",))
  step = parallel.make_spatial_isp_step(
      mesh, work_dtype=torch.float32, pattern=ttit.BayerPattern.RGGB,
      tonemap=tonemap, n_cameras=2, image_hw=(64, 96))
  calls.clear()
  step(*_step_args(raws))
  assert calls == {"all_gather": 1, "all_reduce": reduces}, calls


def test_grid_step_collectives(world1, calls):
  from torch.distributed.device_mesh import init_device_mesh
  raws = rig(2)
  mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("cam", "rows"))
  step = parallel.make_grid_isp_step(
      mesh, work_dtype=torch.float32, pattern=ttit.BayerPattern.RGGB,
      n_cameras=2, image_hw=(64, 96), resize_plan=((48, 32), 0.5))
  calls.clear()
  step(*_step_args(raws))
  assert calls == {"all_gather": 1, "all_reduce": 4}, calls


@pytest.mark.parametrize("kind", ["camera", "rows", "grid"])
@pytest.mark.parametrize("cls", ["CameraBF16", "Camera32"])
def test_one_rank_steps_bitwise_unsharded(world1, kind, cls):
  """On one rank every step is the unsharded step, bitwise: metrics and
  output (a one-rank all_reduce is the local value)."""
  from torch.distributed.device_mesh import init_device_mesh
  raws = rig(2)
  isp = getattr(ttit, cls)(ttit.BayerPattern.RGGB, device="cpu")
  if kind == "camera":
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("cam",))
    step = parallel.sharded_step_for_isp(isp, mesh, raws.shape)
  else:
    shape, names = (((1,), ("rows",)) if kind == "rows"
                    else ((1, 1), ("cam", "rows")))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    factory = (parallel.make_spatial_isp_step if kind == "rows"
               else parallel.make_grid_isp_step)
    step = factory(mesh, work_dtype=isp._work_dtype,
                   pattern=isp.bayer_pattern, n_cameras=2, image_hw=(64, 96))
  m, out = step(torch.from_numpy(raws), torch.zeros(9), 0.0, 0.8, 2.0, 1.0,
                0.0)
  want = isp.process(raws, gamma=0.8, intensity=2.0)
  assert torch.equal(m, isp.metrics)
  assert torch.equal(out, want)


def test_jax_eight_virtual_devices():
  assert len(jax.devices()) == 8
