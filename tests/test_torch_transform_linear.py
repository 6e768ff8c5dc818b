"""Output transforms, the linear tonemap and odd metering strides: the
port's K4 twin (transform folded into its stores, linear mode), the
phase/planar transform helpers, the odd-stride sample gather and the
routes of ``fused_isp_step`` that use them, against the JAX package on
the CPU.

Contracts:
  * transforms: bitwise (pure data movement) — the port's
    ``planar_from_phases_transformed``, ``_transform_phases`` and
    ``_transform_planar`` against JAX's, and K4's twin with each of the
    8 transforms against JAX's ``reinhard_gamma_ca`` +
    ``planar_from_phases_transformed``.
  * linear mode: the twin against the Pallas finish's linear mode in
    interpret mode: bitwise (at gamma != 1 too: measured 0 of 786432
    pixels apart at gamma 2.2 and 0.8, though the two sides take
    log2/exp2 from different math libraries); against the XLA
    ``linear_apply_ca``: bitwise at gamma 1, and at gamma != 1 (as
    tests/test_torch_finish.py) <= 1 count on < 0.01% of pixels.
  * odd strides: the sample gathered from x12 is bitwise
    ``phases_to_planar(x12)[..., ::s, ::s]``.
  * routes: as tests/test_torch_resize.py's ``compare_step``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.ops import bayer as jbayer  # noqa: E402
from taichi_image_tpu.ops.interpolate import (  # noqa: E402
    ImageTransform as JT)
from taichi_image_tpu.ops.pallas import finish as pl_fin  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops import bayer as tbayer  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import finish as th_fin  # noqa: E402
from taichi_image_tpu_torch.ops.interpolate import ImageTransform  # noqa: E402
from test_torch_resize import (  # noqa: E402
    CLASSES, PLANS, _raws, _to_torch, route_vs_jax)

TRANSFORMS = list(ImageTransform)
T_IDS = [t.value for t in TRANSFORMS]


def _x12(n=2, hh=16, wh=256, seed=0, lo=0.0, hi=1.2, dtype=jnp.bfloat16):
  x = np.random.default_rng(seed).random((n, 12, hh, wh), np.float32)
  j = jnp.asarray(lo + x * (hi - lo), dtype)
  return j, _to_torch(j)


def _assert_u8(got, want, gamma):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
  if gamma == 1.0:
    np.testing.assert_array_equal(got, want)
    return
  d = np.abs(got.astype(np.int64) - want.astype(np.int64))
  assert d.max() <= 1 and (d != 0).mean() < 1e-4, (d.max(), (d != 0).sum())


# ------------------------------------------------------- transforms

@pytest.mark.parametrize("t", TRANSFORMS, ids=T_IDS)
def test_transform_helpers_bitwise(t):
  j, tt = _x12(2, 6, 10, seed=1)
  jt = JT(t.value)
  np.testing.assert_array_equal(
      np.asarray(tbayer.planar_from_phases_transformed(tt, t)
                 .view(torch.int16)),
      np.asarray(jci.planar_from_phases_transformed(j, jt)).view(np.int16))
  np.testing.assert_array_equal(
      np.asarray(tci._transform_phases(tt, t).view(torch.int16)),
      np.asarray(jci._transform_phases(j, jt)).view(np.int16))
  planar = jbayer.phases_to_planar(j)
  np.testing.assert_array_equal(
      tci._transform_planar(_to_torch(planar), t).view(torch.int16).numpy(),
      np.asarray(jci._transform_planar(planar, jt)).view(np.int16))


@pytest.mark.parametrize("gamma", [1.0, 2.2])
@pytest.mark.parametrize("t", TRANSFORMS, ids=T_IDS)
def test_finish_transform_matches_xla_tail(t, gamma):
  # negative p included (their log2 is NaN at gamma != 1 -> 0)
  j, tt = _x12(3, 7, 10, seed=2, lo=-0.2)
  mx = np.linspace(0.8, 1.1, 3, dtype=np.float32).reshape(3, 1, 1, 1)
  want = jci.planar_from_phases_transformed(
      jci.reinhard_gamma_ca(j, jnp.asarray(mx), gamma), JT(t.value))
  got = th_fin.finish_planar_u8(tt, torch.from_numpy(mx), gamma,
                                transform=t)
  _assert_u8(got.numpy(), want, gamma)


# ------------------------------------------------------ linear tonemap

METRICS = np.asarray([0.08, 0.93, -4.0, 0.0, -1.0, 0.4, 0.4, 0.4, 0.4],
                     np.float32)


@pytest.mark.parametrize("gamma", [1.0, 2.2, 0.8])
def test_linear_finish_matches_pallas_interpret(gamma):
  j, tt = _x12(seed=3)
  want = pl_fin.finish_planar_u8(j, jnp.asarray(METRICS), "linear", gamma,
                                 interpret=True)
  lin = th_fin.linear_scal(torch.from_numpy(METRICS))
  got = th_fin.finish_planar_u8(tt, lin, gamma, mode="linear")
  _assert_u8(got.numpy(), want, 1.0)  # bitwise at every gamma


@pytest.mark.parametrize("gamma", [1.0, 2.2])
@pytest.mark.parametrize("t", [ImageTransform.none, ImageTransform.rotate_90,
                               ImageTransform.flip_vert],
                         ids=["none", "rotate_90", "flip_vert"])
def test_linear_finish_matches_xla_tail(t, gamma):
  n, hh, wh = 2, 9, 14
  j, tt = _x12(n, hh, wh, seed=4, lo=-0.1)
  want = jci.planar_from_phases_transformed(
      jci.linear_apply_ca(j.reshape(n, 4, 3, hh, wh), jnp.asarray(METRICS),
                          gamma).reshape(n, 12, hh, wh), JT(t.value))
  lin = th_fin.linear_scal(torch.from_numpy(METRICS))
  got = th_fin.finish_planar_u8(tt, lin, gamma, mode="linear", transform=t)
  _assert_u8(got.numpy(), want, gamma)
  # the planar routes' torch linear tonemap
  planar = jbayer.phases_to_planar(j)
  _assert_u8(tci.linear_apply_ca(_to_torch(planar), torch.from_numpy(METRICS),
                                 gamma).numpy(),
             jci.linear_apply_ca(planar, jnp.asarray(METRICS), gamma), gamma)


def test_linear_scal_on_device_is_f32():
  lin = th_fin.linear_scal(torch.from_numpy(METRICS))
  assert lin.dtype == torch.float32 and tuple(lin.shape) == (2,)
  want = np.float32(1.0) / (METRICS[1] - METRICS[0])
  assert lin[1].item() == float(want)


def test_finish_refuses_bad_mode_and_scal():
  x = torch.zeros(1, 12, 2, 2, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="unknown finish mode"):
    th_fin.finish_planar_u8(x, torch.ones(1, 1, 1, 1), 1.0, mode="log")
  with pytest.raises(ValueError, match=r"\[m0, inv_range\]"):
    th_fin.finish_planar_u8(x, torch.ones(9), 1.0, mode="linear")


# -------------------------------------------------------- odd strides

@pytest.mark.parametrize("shape", [(2, 16, 24), (1, 7, 5)])
@pytest.mark.parametrize("step", [1, 3, 5, 7])
def test_planar_subsample_bitwise(step, shape):
  n, hh, wh = shape
  j, tt = _x12(n, hh, wh, seed=5)
  want = np.asarray(jbayer.phases_to_planar(j))[..., ::step, ::step]
  got = tbayer.planar_subsample(tt, step)
  np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                want.view(np.int16))


# ------------------------------------------------------------- routes

@pytest.mark.parametrize("resize", [None, "x0.5"], ids=["phase", "resize"])
@pytest.mark.parametrize("t", TRANSFORMS[1:], ids=T_IDS[1:])
def test_transform_route_bf16(t, resize):
  frames = [_raws(200 + f) for f in range(2)]
  outs = route_vs_jax("CameraBF16", frames, transform=t,
                      plan=PLANS[resize] if resize else None)
  h, w = (32, 128) if resize else (64, 256)
  if t in (ImageTransform.rotate_90, ImageTransform.rotate_270,
           ImageTransform.transpose, ImageTransform.transverse):
    h, w = w, h
  assert tuple(outs[0].shape) == (2, 3, h, w)


@pytest.mark.parametrize("cls", ["Camera16", "Camera32"])
@pytest.mark.parametrize("t,resize", [(ImageTransform.flip_horiz, None),
                                      (ImageTransform.rotate_90, "x0.37")],
                         ids=["flip_horiz", "rotate_90-x0.37"])
def test_transform_route_f16_f32(t, resize, cls):
  route_vs_jax(cls, [_raws(210 + f) for f in range(2)], transform=t,
               plan=PLANS[resize] if resize else None)


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("gamma", [1.0, 2.2])
def test_linear_route(gamma, cls):
  route_vs_jax(cls, [_raws(220 + f) for f in range(2)], tonemap="linear",
               gamma=gamma)


@pytest.mark.parametrize("cls", ["CameraBF16", "Camera32"])
def test_linear_route_with_resize_and_transform(cls):
  route_vs_jax(cls, [_raws(230 + f) for f in range(2)], tonemap="linear",
               gamma=2.2, plan=PLANS["x0.37"],
               transform=ImageTransform.transverse)


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("stride", [3, 7])
def test_odd_stride_route(stride, cls):
  route_vs_jax(cls, [_raws(240 + f) for f in range(2)], stride=stride,
               transform=ImageTransform.rotate_180, color_adapt=0.3)


def test_odd_stride_linear_route():
  route_vs_jax("CameraBF16", [_raws(250 + f) for f in range(2)], stride=7,
               tonemap="linear", gamma=0.8)
