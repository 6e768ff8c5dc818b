"""K3 Reinhard map + per-image max: the port's plain twin against the
JAX map — the Pallas bf16 kernel in interpret mode and the XLA
``reinhard_map_ca``. Bounds are the JAX suite's own
(tests/test_pallas_reinhard.py:40-45): p within rtol 1e-2 / atol 1e-3,
the max within rtol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.ops.pallas import reinhard as pl_rh  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import reinhard as th_rh  # noqa: E402

M = np.asarray([0.02, 0.98, -3.0, -0.1, -1.2, 0.4, 0.45, 0.4, 0.35],
               np.float32)


def _bits(x):
  if isinstance(x, torch.Tensor):
    return x.contiguous().view(torch.int16).numpy().view(np.uint16)
  return np.asarray(x).view(np.uint16)


def _x(shape, seed=0, nan_at=None):
  x = np.asarray(np.random.default_rng(seed).random(shape) * 0.9 + 0.05,
                 np.float32)
  if nan_at is not None:
    x[nan_at] = np.nan
  j = jnp.asarray(x, jnp.bfloat16)
  t = torch.from_numpy(_bits(j).view(np.int16).copy()).view(torch.bfloat16)
  return j, t


def _port_map(t, ca, light_adapt=1.0):
  return tci.reinhard_map_max_ca(t, torch.from_numpy(M), 1.0, light_adapt,
                                 ca, torch.bfloat16)


def _xla_map(x, ca):
  n, c = x.shape[:2]
  p = jci.reinhard_map_ca(x.reshape(n, c // 3, 3, *x.shape[2:]),
                          jnp.asarray(M), 1.0, 1.0, ca)
  mx = jnp.max(p, axis=tuple(range(1, p.ndim)))
  return p.astype(jnp.bfloat16).reshape(x.shape), mx.reshape(n, 1, 1, 1)


def _check(got, want):
  (gp, gm), (wp, wm) = got, want
  assert gp.dtype == torch.bfloat16 and tuple(gp.shape) == wp.shape
  np.testing.assert_allclose(gp.to(torch.float32).numpy(),
                             np.asarray(wp, np.float32), rtol=1e-2,
                             atol=1e-3)
  np.testing.assert_allclose(gm.numpy().ravel(), np.asarray(wm).ravel(),
                             rtol=1e-5)


@pytest.mark.parametrize("ca", [0.0, 0.5])
@pytest.mark.parametrize("shape", [(2, 12, 16, 128), (3, 3, 24, 256)])
def test_map_matches_pallas_interpret(shape, ca):
  j, t = _x(shape)
  want = jax.jit(lambda x: pl_rh.reinhard_map_bf16_dma(
      x, jnp.asarray(M), 1.0, 1.0, color_adapt=ca, interpret=True))(j)
  _check(_port_map(t, ca), want)


@pytest.mark.parametrize("ca", [0.0, 0.5])
@pytest.mark.parametrize("shape", [(2, 12, 16, 128), (3, 3, 24, 256)])
def test_map_matches_xla(shape, ca):
  j, t = _x(shape, seed=1)
  want = jax.jit(lambda x: _xla_map(x, ca))(j)
  _check(_port_map(t, ca), want)


@pytest.mark.parametrize("ca", [0.0, 0.5])
def test_map_f32_matches_xla(ca):
  # the f32 p before the cast: the port's exp2(k*log2(b)) against XLA's
  # pow differs by f32 ulps only
  j, t = _x((2, 6, 8, 32), seed=2)
  want = jci.reinhard_map_ca(j.reshape(2, 2, 3, 8, 32), jnp.asarray(M), 1.2,
                             0.8, ca)
  got = tci.reinhard_map_ca(t, torch.from_numpy(M), 1.2, 0.8, ca)
  np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape),
                             rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ca", [0.0, 0.5])
def test_map_nan_zeroed(ca):
  _, t = _x((1, 3, 16, 128), nan_at=(0, slice(None), 3, 17))
  p, mx = _port_map(t, ca)
  p = p.to(torch.float32).numpy()
  assert np.isfinite(p).all()
  assert (p[0, :, 3, 17] == 0.0).all()
  assert np.isfinite(mx.numpy()).all()


def test_max_covers_negative_p():
  # every pixel below m0 and adapt from the mean alone (light_adapt=0):
  # all p negative, so the max is negative too
  x = torch.full((2, 3, 4, 8), 0.01, dtype=torch.bfloat16)
  p, mx = _port_map(x, 0.0, light_adapt=0.0)
  pf = p.to(torch.float32)
  assert (pf < 0).all() and (mx < 0).all()
  scal = th_rh.reinhard_scal(torch.from_numpy(M), 1.0, 0.0)
  want = th_rh.reinhard_map_f32(x, scal, False).amax(dim=(1, 2, 3))
  np.testing.assert_array_equal(mx.reshape(-1).numpy(), want.numpy())


@pytest.mark.parametrize("ca", [0.0, 0.5])
def test_scal_matches_jax(ca):
  got = (th_rh.reinhard_scal_ca(torch.from_numpy(M), 1.3, 0.7, ca) if ca
         else th_rh.reinhard_scal(torch.from_numpy(M), 1.3, 0.7))
  want = (pl_rh.reinhard_scal_ca(jnp.asarray(M), 1.3, 0.7, ca) if ca
          else pl_rh.reinhard_scal(jnp.asarray(M), 1.3, 0.7))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ----------------------------------------------- zero dividends, m0 == 0

def _div_keep_zero(d, rng):
  """Torch mirror of the kernels' division (csrc/common.cuh
  div_rn_keep_zero): a zero dividend over a positive divisor divides 1
  and is put back; everything else divides as written."""
  zero = (d == 0) & (rng > 0)
  q = torch.where(zero, torch.ones_like(d), d) / rng
  return torch.where(zero, d, q)


_TINY = float(np.float32(1e-45))  # the smallest f32 subnormal
_DIVIDENDS = [0.0, -0.0, _TINY, -_TINY, 1.0, float("nan"), float("inf"),
              float("-inf")]


@pytest.mark.parametrize("rng", [0.7, 1e-40, 0.0, -0.0, -0.7, float("nan"),
                                 float("inf")],
                         ids=["positive", "subnormal", "zero", "minus_zero",
                              "negative", "nan", "inf"])
def test_zero_dividend_select_is_bitwise_division(rng):
  d = torch.tensor(_DIVIDENDS, dtype=torch.float32)
  r = torch.full_like(d, rng)
  got, want = _div_keep_zero(d, r), d / r
  np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                want.view(torch.int32).numpy())


M0 = M.copy()
M0[0] = 0.0  # the metering minimum at 0, as clipped stencil output gives


def _x_clipped(shape, seed):
  """bf16 inputs of which 40% are exactly 0 == m0 (the stencil's clipped
  pixels), as JAX and torch arrays."""
  r = np.random.default_rng(seed)
  x = np.asarray(r.random(shape) * 0.9 + 0.05, np.float32)
  x[r.random(shape) < 0.4] = 0.0
  assert (x == 0).mean() >= 1 / 3
  j = jnp.asarray(x, jnp.bfloat16)
  t = torch.from_numpy(_bits(j).view(np.int16).copy()).view(torch.bfloat16)
  return j, t


def _port_map_m0(t, ca):
  return tci.reinhard_map_max_ca(t, torch.from_numpy(M0), 1.0, 1.0, ca,
                                 torch.bfloat16)


@pytest.mark.parametrize("ca", [0.0, 0.5])
def test_map_at_m0_matches_pallas_interpret(ca):
  j, t = _x_clipped((2, 12, 16, 128), seed=5)
  want = jax.jit(lambda x: pl_rh.reinhard_map_bf16_dma(
      x, jnp.asarray(M0), 1.0, 1.0, color_adapt=ca, interpret=True))(j)
  _check(_port_map_m0(t, ca), want)


@pytest.mark.parametrize("ca", [0.0, 0.5])
@pytest.mark.parametrize("shape", [(2, 3, 5, 37), (1, 12, 9, 30)])
def test_map_at_m0_matches_xla(shape, ca):
  j, t = _x_clipped(shape, seed=6)

  def xla(x):
    n, c = x.shape[:2]
    p = jci.reinhard_map_ca(x.reshape(n, c // 3, 3, *x.shape[2:]),
                            jnp.asarray(M0), 1.0, 1.0, ca)
    return (p.astype(jnp.bfloat16).reshape(x.shape),
            jnp.max(p, axis=tuple(range(1, p.ndim))).reshape(n, 1, 1, 1))
  got = _port_map_m0(t, ca)
  _check(got, jax.jit(xla)(j))
  # a pixel at m0 maps to exactly +0 in every channel
  at_m0 = (t == 0).reshape(t.shape[0], -1, 3, *t.shape[2:]).all(dim=2)
  p = got[0].reshape(t.shape[0], -1, 3, *t.shape[2:])
  assert at_m0.any()
  assert (p.movedim(2, -1)[at_m0].view(torch.int16) == 0).all()


# ------------------------------------------------ the 32-bit offset guard

@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_map_refuses_images_past_32_bit_offsets(backend):
  # 3 x 2^15 x 2^15 values per image: a stride-0 view, nothing allocated
  x = torch.zeros(1, 3, 1, 1, dtype=torch.bfloat16).expand(
      1, 3, 2 ** 15, 2 ** 15)
  with pytest.raises(ValueError, match="32-bit"):
    th_rh.reinhard_map(x, torch.zeros(6), False, backend=backend)
