"""Row sharding of the PyTorch port (``parallel/spatial.py``) against the
JAX package's, on the CPU: the cases of tests/test_spatial.py at 2 and 4
ranks (its 8-device cases at 4), each world started once for the file
(``spawn_cases``, tests/test_torch_sharding.py), the JAX side in this
process on its virtual CPU devices.

Contracts: as tests/test_torch_sharding.py's (metrics within 1e-5 of
JAX's sharded step and of its unsharded ``process``, u8 and I420 within 1
count, 2 in bf16, on < 1% of bytes; each rank's part against the port's
unsharded step the same); ``demosaic_phases_spatial`` within 1e-5 of both
JAX demosaics and bitwise the port's unsharded demosaic. Every refusal
of the JAX package that a call can reach is raised by the port with the
same meaning (JAX's top-halo refusal cannot be reached: truncation
sampling puts the first tap at row 0), and so are the port's own: an odd
metering stride, which the JAX step gets wrong (pinned below), and a
stride that does not divide the rows per shard.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
from taichi_image_tpu import types as jtypes  # noqa: E402
from taichi_image_tpu.ops import bayer as jbayer  # noqa: E402
from taichi_image_tpu.parallel import spatial as jspatial  # noqa: E402
from conftest import make_test_rgb  # noqa: E402
from oracle import rgb_to_bayer_oracle  # noqa: E402
from test_torch_sharding import (  # noqa: E402
    SCALARS, assert_close, check_case, jax_isp, outs_np, rig, spawn_cases)


def jax_spatial(case, n):
  """JAX's row-sharded (or, with ``grid``, cameras x rows) step, chained
  like ``process``."""
  raws = case["raws"]
  n_cam, h, wb = raws.shape
  w = wb * 2 // 3
  isp = jax_isp(case)
  if "grid" in case:
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(case["grid"]),
                ("cam", jspatial.ROW_AXIS))
    spec, factory = P("cam", jspatial.ROW_AXIS), jspatial.make_grid_isp_step
  else:
    mesh = Mesh(np.array(jax.devices()[:n]), (jspatial.ROW_AXIS,))
    spec = P(None, jspatial.ROW_AXIS)
    factory = jspatial.make_spatial_isp_step
  step = factory(mesh, work_dtype=isp._work_dtype, pattern=isp.bayer_pattern,
                 cc=isp._cc_tuple(), stride=isp.metering_stride,
                 tonemap=case.get("tonemap", "reinhard"), n_cameras=n_cam,
                 image_hw=(h, w), resize_plan=isp._resize_plan(h, w),
                 transform=isp.transform,
                 color_format=case.get("color_format", "rgb"))
  proc = dict(gamma=1.0, intensity=1.0, light_adapt=1.0, color_adapt=0.0)
  proc.update(case.get("proc", {}))
  m = jax.device_put(jnp.zeros(9, jnp.float32), NamedSharding(mesh, P()))
  r = jax.device_put(jnp.asarray(raws), NamedSharding(mesh, spec))
  res = []
  for k in range(case.get("steps", 1)):
    t = 0.0 if k == 0 else 1.0 - isp.moving_alpha
    m, out = step(r, m, jnp.float32(t),
                  *(jnp.float32(proc[s]) for s in SCALARS))
    res.append((np.asarray(m), outs_np(out)))
  return res


def _phases(h, w):
  cfa = rgb_to_bayer_oracle(make_test_rgb(h, w), "RGGB")[None]
  return np.asarray(jbayer.cfa_phases(jnp.asarray(cfa)).astype(jnp.float32))


_CC = tuple(np.array([[1.5, -0.2, -0.3], [-0.1, 1.2, -0.1],
                      [0.0, -0.4, 1.4]], np.float32).flatten().tolist())
_STEP = dict(kind="rows", cls="Camera32", isp_kw=dict(moving_alpha=0.2),
             proc=dict(gamma=0.8, intensity=2.0))


def _fuzz_cases():
  """tests/test_spatial.py::test_spatial_shape_fuzz's draws, one case
  each on its drawn world size."""
  rng = np.random.default_rng(11)
  classes = ["Camera32", "Camera16"]
  cases = []
  for trial in range(6):
    n_dev = int(rng.choice([2, 4]))
    n_cam = int(rng.integers(1, 3))
    h = 16 * n_dev * int(rng.integers(1, 3))
    w = 2 * int(rng.integers(24, 56))
    cls = classes[trial % 2]
    pat = list(jbayer.BayerPattern)[int(rng.integers(0, 4))].name
    scale = None
    if rng.random() < 0.5 and (h // 2) % (n_dev * 8) == 0:
      scale = 0.5
    elif rng.random() < 0.5:  # integer upscale
      scale = 2.0
    raws = np.stack([rng.integers(0, 256, size=(h, w * 3 // 2),
                                  dtype=np.uint8) for _ in range(n_cam)])
    cases.append(dict(name=f"fuzz-{trial}", world=n_dev, kind="rows",
                      cls=cls, pattern=pat, isp_kw=dict(scale=scale),
                      proc=dict(gamma=0.8), raws=raws))
  return cases


def _refusal(name, world, kind_of, match, jax_too=True, **kwargs):
  if kind_of != "demosaic":
    kwargs.setdefault("work_dtype", "float32")
    kwargs.setdefault("pattern", "RGGB")
  return dict(name=f"refuse-{name}", world=world, kind="refuse",
              kind_of=kind_of, kwargs=kwargs, match=match, jax_too=jax_too,
              grid=(2, 2) if kind_of == "grid" else None)


REFUSALS = [
    _refusal("rows8", 4, "rows", "multiple of 8", n_cameras=1,
             image_hw=(60, 96)),
    _refusal("divide", 4, "rows", "divide", n_cameras=1, image_hw=(96, 128),
             resize_plan=((40, 30), 0.3125)),
    _refusal("resized-stride", 4, "rows", "multiple of the metering stride",
             n_cameras=1, image_hw=(64, 96), resize_plan=((24, 16), 0.25)),
    _refusal("shift", 2, "rows", "not shift-invariant", n_cameras=1,
             image_hw=(64, 96), resize_plan=((72, 48), 0.75)),
    _refusal("color-format", 2, "rows", "color_format", n_cameras=1,
             image_hw=(64, 96), color_format="nv12"),
    _refusal("grid-color-format", 4, "grid", "color_format", n_cameras=2,
             image_hw=(64, 96), color_format="nv12"),
    _refusal("half-res-rows", 2, "demosaic", "at least 3 half-res rows",
             jax_too=False, shape=(1, 4, 2, 8)),
    _refusal("odd-stride", 2, "rows", "even metering stride", jax_too=False,
             n_cameras=1, image_hw=(64, 96), stride=7),
    _refusal("rows-stride", 4, "rows", "multiple of the metering stride",
             jax_too=False, n_cameras=1, image_hw=(96, 96), stride=16),
    _refusal("tonemap", 2, "rows", "unknown tonemap", jax_too=False,
             n_cameras=1, image_hw=(64, 96), tonemap="drago"),
]


def _cases():
  cases = []
  for n in (2, 4):
    cases += [
        dict(name=f"demosaic-{n}", world=n, kind="demosaic",
             phases=_phases(64, 96)),
        dict(_STEP, name=f"step-{n}", world=n, raws=rig(2)),
        dict(_STEP, name=f"resize-{n}", world=n, raws=rig(2),
             isp_kw=dict(moving_alpha=0.2, scale=0.5)),
        dict(_STEP, name=f"upscale-{n}", world=n, raws=rig(2),
             isp_kw=dict(moving_alpha=0.2, scale=2.0)),
    ]
  frame = rig(1)
  cases += [
      dict(name="demosaic-cc-2", world=2, kind="demosaic",
           phases=_phases(32, 64), cc=_CC),
      dict(name="transform-4", world=4, kind="rows", cls="Camera32",
           isp_kw=dict(transform="rotate_90"), proc=dict(gamma=0.8),
           raws=np.concatenate([frame, frame])),
      *(dict(_STEP, name=f"i420-{cls}-4", world=4, cls=cls, raws=rig(2),
             color_format="yuv420") for cls in ("Camera32", "CameraBF16")),
      dict(name="i420-transform-4", world=4, kind="rows", cls="Camera32",
           isp_kw=dict(transform="rotate_90"), proc=dict(gamma=0.8),
           color_format="yuv420", raws=rig(2)),
      dict(name="i420-resize-2", world=2, kind="rows", cls="Camera32",
           isp_kw=dict(scale=0.5), proc=dict(gamma=0.8),
           color_format="yuv420", raws=rig(2)),
      dict(_STEP, name="grid-4", world=4, kind="grid", grid=(2, 2),
           raws=rig(4)),
      dict(name="grid-resize-4", world=4, kind="grid", grid=(2, 2),
           cls="Camera32", isp_kw=dict(scale=0.5), proc=dict(gamma=0.8),
           raws=rig(4)),
      dict(_STEP, name="grid-i420-4", world=4, kind="grid", grid=(2, 2),
           color_format="yuv420", raws=rig(4)),
      *_fuzz_cases(), *REFUSALS,
  ]
  return cases


CASES = {c["name"]: c for c in _cases()}


@pytest.fixture(scope="module")
def ranks():
  return spawn_cases(CASES.values())


def check_spatial(ranks, name):
  case = CASES[name]
  check_case(case, ranks[name], jax_spatial(case, case["world"]))
  return ranks[name]


def _jax_demosaic(phases, n, cc=None):
  pattern = jbayer.BayerPattern.RGGB
  want = np.asarray(jbayer.demosaic_phases(jnp.asarray(phases), pattern,
                                           cc=cc))
  mesh = Mesh(np.array(jax.devices()[:n]), (jspatial.ROW_AXIS,))
  sharded = jax.device_put(jnp.asarray(phases), NamedSharding(
      mesh, P(None, None, jspatial.ROW_AXIS, None)))
  got = np.asarray(jspatial.demosaic_phases_spatial(sharded, mesh, pattern,
                                                    cc=cc))
  return want, got


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_demosaic_matches_single(ranks, n):
  res = ranks[f"demosaic-{n}"]
  want, jax_sharded = _jax_demosaic(CASES[f"demosaic-{n}"]["phases"], n)
  np.testing.assert_allclose(res["out"], want, atol=1e-5)
  np.testing.assert_allclose(res["out"], jax_sharded, atol=1e-5)
  assert res["d"] == 0.0  # bitwise the port's unsharded demosaic


def test_spatial_demosaic_with_cc(ranks):
  res = ranks["demosaic-cc-2"]
  want, jax_sharded = _jax_demosaic(CASES["demosaic-cc-2"]["phases"], 2,
                                    cc=_CC)
  np.testing.assert_allclose(res["out"], want, atol=1e-5)
  np.testing.assert_allclose(res["out"], jax_sharded, atol=1e-5)
  assert res["d"] == 0.0


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_isp_step_matches_unsharded(ranks, n):
  res = check_spatial(ranks, f"step-{n}")
  assert res["kept"][0][2] == [(2, 3, 64 // n, 96)]


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_step_with_resize(ranks, n):
  res = check_spatial(ranks, f"resize-{n}")
  assert res["kept"][0][1][0].shape == (2, 3, 32, 48)


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_step_with_upscale(ranks, n):
  res = check_spatial(ranks, f"upscale-{n}")
  assert res["kept"][0][1][0].shape == (2, 3, 128, 192)


def test_spatial_step_with_transform(ranks):
  res = check_spatial(ranks, "transform-4")
  # each rank's band rotated: a quarter of the columns of the output
  assert res["kept"][0][2] == [(2, 3, 96, 16)]


@pytest.mark.parametrize("cls", ["Camera32", "CameraBF16"])
def test_spatial_step_yuv420(ranks, cls):
  res = check_spatial(ranks, f"i420-{cls}-4")
  assert [o.shape for o in res["kept"][0][1]] == [(2, 64, 96),
                                                  (2, 2, 32, 48)]


def test_spatial_step_yuv420_with_transform(ranks):
  res = check_spatial(ranks, "i420-transform-4")
  assert res["kept"][0][1][0].shape == (2, 96, 64)  # rotated


def test_spatial_step_yuv420_with_resize(ranks):
  res = check_spatial(ranks, "i420-resize-2")
  assert [o.shape for o in res["kept"][0][1]] == [(2, 32, 48),
                                                  (2, 2, 16, 24)]


@pytest.mark.parametrize("name", ["grid-4", "grid-resize-4", "grid-i420-4"])
def test_grid_2d_mesh_matches_unsharded(ranks, name):
  check_spatial(ranks, name)


@pytest.mark.parametrize("trial", range(6))
def test_spatial_shape_fuzz(ranks, trial):
  check_spatial(ranks, f"fuzz-{trial}")


def _jax_refusal(case):
  kw = dict(case["kwargs"])
  kw["work_dtype"] = jtypes.canonical_dtype(kw["work_dtype"])
  kw["pattern"] = jbayer.BayerPattern[kw["pattern"]]
  n = case["world"]
  if case["kind_of"] == "grid":
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(case["grid"]),
                ("cam", jspatial.ROW_AXIS))
    return jspatial.make_grid_isp_step(mesh, **kw)
  mesh = Mesh(np.array(jax.devices()[:n]), (jspatial.ROW_AXIS,))
  return jspatial.make_spatial_isp_step(mesh, **kw)


@pytest.mark.parametrize("name", [r["name"] for r in REFUSALS])
def test_refusals(ranks, name):
  """The port's factories refuse what the JAX package's refuse, with the
  same meaning, and the configurations the port adds refusals for."""
  case = CASES[name]
  err = ranks[name]["error"]
  assert err is not None and case["match"] in err, err
  if case["jax_too"]:
    with pytest.raises(ValueError, match=case["match"]):
      _jax_refusal(case)


def test_jax_row_step_at_an_odd_stride_disagrees_with_its_unsharded_step():
  """Why the port refuses odd strides: the JAX row-sharded step samples
  phase (0, 0) at stride // 2 on every shard, while its unsharded step
  samples the planar image at the odd stride; at stride 7 the metrics
  move far past the 1e-5 contract and the u8 output with them."""
  raws = rig(2)
  ref = jtit.Camera32(jtit.BayerPattern.RGGB, moving_alpha=0.2,
                      metering_stride=7)
  ref_out = np.asarray(ref.process(raws, gamma=0.8, intensity=2.0))
  mesh = Mesh(np.array(jax.devices()[:2]), (jspatial.ROW_AXIS,))
  step = jspatial.make_spatial_isp_step(
      mesh, work_dtype=jtypes.f32, pattern=jtit.BayerPattern.RGGB,
      n_cameras=2, image_hw=(64, 96), stride=7)
  m, out = step(jax.device_put(jnp.asarray(raws), NamedSharding(
      mesh, P(None, jspatial.ROW_AXIS))), jnp.zeros(9, jnp.float32),
                jnp.float32(0.0), jnp.float32(0.8), jnp.float32(2.0),
                jnp.float32(1.0), jnp.float32(0.0))
  dm = np.abs(np.asarray(m) - np.asarray(ref.metrics)).max()
  du = np.abs(np.asarray(out).astype(int) - ref_out.astype(int)).max()
  assert dm > 0.1 and du > 1, (dm, du)
  # the same configuration at stride 8 agrees
  ref8 = jtit.Camera32(jtit.BayerPattern.RGGB, moving_alpha=0.2)
  ref8.process(raws, gamma=0.8, intensity=2.0)
  step8 = jspatial.make_spatial_isp_step(
      mesh, work_dtype=jtypes.f32, pattern=jtit.BayerPattern.RGGB,
      n_cameras=2, image_hw=(64, 96))
  m8, _ = step8(jax.device_put(jnp.asarray(raws), NamedSharding(
      mesh, P(None, jspatial.ROW_AXIS))), jnp.zeros(9, jnp.float32),
                jnp.float32(0.0), jnp.float32(0.8), jnp.float32(2.0),
                jnp.float32(1.0), jnp.float32(0.0))
  np.testing.assert_allclose(np.asarray(m8), np.asarray(ref8.metrics),
                             atol=1e-5)


def test_assert_close_is_the_contract():
  """The helper holds a 2-count bf16 pixel and a 1-count f32 one."""
  a = np.zeros((1, 100, 100), np.uint8)
  b = a.copy()
  b[0, 0, 0] = 2
  assert_close(np.zeros(9), (a,), np.zeros(9), (b,), bf16=True)
  with pytest.raises(AssertionError):
    assert_close(np.zeros(9), (a,), np.zeros(9), (b,), bf16=False)
