"""P, the resize route's RGB tail (``ops/hopper/finish.py``
``finish_planar_tone``): its plain twin against the JAX package on the
CPU, a numpy emulation of the kernel's store addresses, and its guards.

Contracts:
  * the twin (after the port's map for Reinhard) against JAX's resize-route
    tail, ``reinhard_apply_ca`` or ``linear_apply_ca`` then
    ``_transform_planar``, for the 8 transforms x gamma 1 and 2.2 x both
    tonemaps x the 3 working dtypes: u8 within 1 count, and in bf16 a rare
    2 as tests/test_torch_resize.py's ``compare_step`` allows it (PyTorch's
    and XLA's CPU pow can differ by an f32 ulp, which can round p to the
    neighbouring bf16 value);
  * the kernel's addresses in numpy (each input value (y, x) of a channel
    stored at row flip_y(y), column flip_x(x), or under an axis swap at
    row flip_x(x), column flip_y(y)) of the tone's bytes: bitwise the
    twin, under the 8 transforms, at sizes that are and are not whole runs
    of 8;
  * the wrapper refuses what the kernel does not take, on both routes.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops import hopper  # noqa: E402
from taichi_image_tpu_torch.ops.bayer import (  # noqa: E402
    _TRANSFORM_SFF, BayerPattern)
from taichi_image_tpu_torch.ops.hopper import finish as th_fin  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import meter as th_meter  # noqa: E402
from taichi_image_tpu_torch.ops.interpolate import ImageTransform  # noqa: E402
from test_torch_resize import JDT, _to_torch  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
TRANSFORMS = list(ImageTransform)
T_IDS = [t.value for t in TRANSFORMS]
MODES = ("reinhard", "linear")


@functools.lru_cache(maxsize=None)
def _planar(dtype, h=24, w=44, seed=3):
  """A planar (2, 3, h, w) image of ``dtype`` (JAX, torch) with zeros, as
  the resize route hands it over, and its metrics (the port's metering,
  which tests/test_torch_meter.py holds to JAX's)."""
  x = np.random.default_rng(seed).random((2, 3, h, w), np.float32) * 1.2
  x.ravel()[::13] = 0.0
  j = jnp.asarray(x, JDT[DTYPES[dtype]])
  t = _to_torch(j)
  m = tci.metering_update_ca(t, torch.zeros(9), 0.0)
  return j, t, m


@functools.lru_cache(maxsize=None)
def _jax_tone(dtype, mode, gamma):
  """JAX's untransformed u8 of the resize route's tail."""
  j, _, m = _planar(dtype)
  mj = jnp.asarray(m.numpy())
  if mode == "reinhard":
    return jci.reinhard_apply_ca(j, mj, gamma, 1.0, 1.0, 0.0,
                                 JDT[DTYPES[dtype]])
  return jci.linear_apply_ca(j, mj, gamma)


def _src(dtype, mode):
  """What P takes: K3's map and max (the twin), or the image and M's
  linear vector."""
  _, x, m = _planar(dtype)
  if mode == "reinhard":
    return tci.reinhard_map_max_ca(x, m, 1.0, 1.0, 0.0, DTYPES[dtype])
  return x, th_meter.linear_scal(m)


@pytest.mark.parametrize("t", TRANSFORMS, ids=T_IDS)
@pytest.mark.parametrize("gamma", [1.0, 2.2], ids=["gamma1", "gamma2.2"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_planar_tail_twin_matches_jax(dtype, mode, gamma, t):
  want = np.asarray(jci._transform_planar(_jax_tone(dtype, mode, gamma),
                                          jtit.ImageTransform(t.value)))
  got = th_fin.finish_planar_tone(*_src(dtype, mode), gamma, mode, t).numpy()
  assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
  d = np.abs(got.astype(np.int64) - want.astype(np.int64))
  assert d.max() <= (2 if dtype == "bf16" else 1), d.max()
  assert (d > 1).mean() < 1e-3, (d > 1).mean()


def _emulate(x, scal, gamma, mode, t):
  """The kernel's stores in numpy: the tone's bytes of channel plane
  (y, x) at (flip_y(y), flip_x(x)), or (flip_x(x), flip_y(y)) under a
  swap, each output byte written once."""
  u8 = th_fin._tone_u8(x, scal, gamma, mode).numpy()
  n, c, h, w = u8.shape
  swap, fy, fx = _TRANSFORM_SFF[t]
  out = np.full((n, c, w, h) if swap else (n, c, h, w), 7, np.uint8)
  seen = np.zeros(out.shape, np.int64)
  y = np.arange(h)[:, None] + np.zeros((1, w), int)
  xx = np.arange(w)[None, :] + np.zeros((h, 1), int)
  yo = h - 1 - y if fy else y
  xo = w - 1 - xx if fx else xx
  r, col = (xo, yo) if swap else (yo, xo)
  out[:, :, r, col] = u8
  np.add.at(seen, (slice(None), slice(None), r, col), 1)
  assert (seen == 1).all()
  return out


@pytest.mark.parametrize("t", TRANSFORMS, ids=T_IDS)
def test_planar_tail_emulation_bitwise(t):
  for dtype in DTYPES:
    for h, w in ((24, 44), (16, 64), (9, 13)):  # whole runs or not
      _, x, m = _planar(dtype, h, w, seed=h)
      for mode in MODES:
        if mode == "reinhard":
          src, scal = tci.reinhard_map_max_ca(x, m, 1.0, 1.0, 0.0,
                                              DTYPES[dtype])
        else:
          src, scal = x, th_meter.linear_scal(m)
        for gamma in (1.0, 2.2):
          want = _emulate(src, scal, gamma, mode, t)
          got = th_fin.finish_planar_tone_plain(src, scal, gamma, mode, t)
          assert got.is_contiguous()
          np.testing.assert_array_equal(got.numpy(), want)


def test_planar_tail_is_the_route_tail():
  """The resize route's RGB output is P of its map: the step's twin and
  the stages composed by hand agree bitwise."""
  raws = np.random.default_rng(5).integers(0, 256, (2, 32, 192), np.uint8)
  isp = tci.CameraBF16(BayerPattern.RGGB, resize_width=64,
                       transform=ImageTransform.rotate_90, device="cpu")
  out = isp.process(raws, gamma=2.2)
  phases = tci.load_raw_phases(torch.from_numpy(raws), "packed12",
                               torch.bfloat16)
  x12 = tci.demosaic_phases(phases, BayerPattern.RGGB,
                            out_dtype=torch.bfloat16)
  rgb = tci._resize_x12(x12, (64, 16), 64 / 128, torch.bfloat16)
  mt = th_meter.meter(tci.subsample_hw(rgb, 8, 8), torch.zeros(9), 0.0)
  p, mx = tci.reinhard_map_max_ca(rgb, mt.metrics, 1.0, 1.0, 0.0,
                                  torch.bfloat16, scal=mt.scal)
  want = th_fin.finish_planar_tone(p, mx, 2.2, "reinhard",
                                   ImageTransform.rotate_90)
  assert torch.equal(out, want) and torch.equal(isp.metrics, mt.metrics)


def test_tone_any_layout_takes_other_dtypes():
  """The public tones on any layout take an f64 image (and max) as their
  f32 values: bitwise the torch tone on the f64 tensor, which casts first,
  and within a count of JAX's (its f64 arrays are f32 without x64)."""
  _, t, m = _planar("f32")
  x = t.double().permute(0, 2, 3, 1)  # channels last, f64
  lin = th_meter.linear_scal(m)
  got = tci.linear_apply_ca(x, m, 2.2)
  assert got.shape == x.shape and got.dtype == torch.uint8
  assert torch.equal(got, th_fin.linear_u8(x, lin, 2.2))
  want = np.asarray(jci.linear_apply_ca(jnp.asarray(x.numpy()),
                                        jnp.asarray(m.numpy()), 2.2))
  assert np.abs(got.numpy().astype(int) - want).max() <= 1
  mx = x.amax(dim=(1, 2, 3), keepdim=True)
  got = tci.reinhard_gamma_ca(x, mx, 2.2)
  assert torch.equal(got, th_fin.gamma_u8(x, mx, 2.2))
  assert torch.equal(got, tci.reinhard_gamma_ca(x.float(), mx.float(), 2.2))


@pytest.mark.parametrize("mode", MODES)
def test_tone_any_in_parts_is_one_pass(mode, monkeypatch):
  """Beyond one launch's extent the tone runs on parts (a few images of a
  few values each, each with its images' max): bitwise one pass."""
  x = torch.from_numpy(np.random.default_rng(8).random((5, 6, 4, 3),
                                                       np.float32))
  scal = (x.amax(dim=(1, 2, 3), keepdim=True) if mode == "reinhard"
          else torch.tensor([0.1, 1.25]))
  want = tci._tone_any(x, scal, 2.2, mode)
  monkeypatch.setattr(tci, "_TONE_VALUES", 6)
  monkeypatch.setattr(tci, "_TONE_IMAGES", 2)
  calls = []
  real = th_fin.finish_planar_tone
  monkeypatch.setattr(th_fin, "finish_planar_tone",
                      lambda v, *a, **k: calls.append(v.shape) or real(v, *a,
                                                                      **k))
  got = tci._tone_any(x, scal, 2.2, mode)
  assert torch.equal(got, want)
  # linear: one image of 360 values; Reinhard: 3 parts of <= 2 images of 72
  assert len(calls) == (60 if mode == "linear" else 36)
  assert all(s[2] * s[3] * 3 <= 6 and s[0] <= 2 for s in calls)
  empty = tci._tone_any(x[:0], scal[:0] if mode == "reinhard" else scal,
                        1.0, mode)
  assert empty.shape == (0, 6, 4, 3) and empty.dtype == torch.uint8


def test_planar_tail_refuses_bad_input():
  x = torch.zeros(1, 3, 4, 6)
  one = torch.ones(1, 1, 1, 1)
  with pytest.raises(ValueError, match=r"\(N, 3, h, w\)"):
    th_fin.finish_planar_tone(torch.zeros(1, 12, 4, 6), one, 1.0)
  with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
    th_fin.finish_planar_tone(x.double(), one, 1.0)
  with pytest.raises(ValueError, match=r"\[m0, inv_range\]"):
    th_fin.finish_planar_tone(x, one, 1.0, "linear")
  with pytest.raises(ValueError, match="one value per image"):
    th_fin.finish_planar_tone(torch.zeros(2, 3, 4, 6), one, 1.0)
  with pytest.raises(ValueError, match="unknown finish mode"):
    th_fin.finish_planar_tone(x, one, 1.0, "gamma")
  before = hopper.launch_counts()
  for dtype in DTYPES.values():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
      th_fin.finish_planar_tone(x.to(dtype), one, 1.0, backend="kernel")
  assert hopper.launch_counts() == before
