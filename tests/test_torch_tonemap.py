"""The standalone tonemaps and metering: the port's ``ops/tonemap.py``
(and ``types.to_float``/``from_float``, ``utils.bounds.Bounds``) against
the JAX package's on the CPU.

Contracts: f32 within 1e-5 relative of JAX (the reductions sum in another
order, and PyTorch's and XLA's pow/log/exp may differ by an ulp); u8 and
u16 within 1 count; the standalone metering keeps the reference's negated
log-max.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu import types as jtypes  # noqa: E402
from taichi_image_tpu.ops import tonemap as jtm  # noqa: E402
from taichi_image_tpu.utils import bounds as jbounds  # noqa: E402
from taichi_image_tpu_torch import types as ttypes  # noqa: E402
from taichi_image_tpu_torch.ops import tonemap as ttm  # noqa: E402
from taichi_image_tpu_torch.utils import bounds as tbounds  # noqa: E402
from conftest import make_test_rgb  # noqa: E402

SRC = make_test_rgb(48, 64)


def _assert_close(got, want):
  got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape and got.dtype == want.dtype, (
      got.shape, got.dtype, want.shape, want.dtype)
  if want.dtype.kind == "f":
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
  else:
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, d.max()


SOURCES = {"f32": SRC * 3.0 + 0.25, "u16": (SRC * 60000).astype(np.uint16),
           "u8": (SRC * 255).astype(np.uint8)}
OUTS = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32}


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("gamma", [1.0, 0.6, 2.2])
@pytest.mark.parametrize("src", SOURCES)
def test_tonemap_linear_matches_jax(src, gamma, out):
  x = SOURCES[src]
  _assert_close(ttm.tonemap_linear(torch.from_numpy(x), gamma, OUTS[out]),
                jtm.tonemap_linear(x, gamma, OUTS[out]))


REINHARD = [
    dict(),
    dict(gamma=0.6, intensity=3.0),
    dict(light_adapt=0.8, color_adapt=0.5),
    dict(gamma=0.9, intensity=1.0, light_adapt=0.9, color_adapt=0.0),
]


@pytest.mark.parametrize("out", ["u8", "f32"])
@pytest.mark.parametrize("params", REINHARD, ids=str)
def test_tonemap_reinhard_matches_jax(params, out):
  x = SRC * 2.0
  _assert_close(ttm.tonemap_reinhard(torch.from_numpy(x), dtype=OUTS[out],
                                     **params),
                jtm.tonemap_reinhard(x, dtype=OUTS[out], **params))


@pytest.mark.parametrize("out", ["u8", "f32"])
@pytest.mark.parametrize("gamma", [1.0, 2.2])
def test_tonemap_gamma_matches_jax(gamma, out):
  x = SRC * 1.1
  _assert_close(ttm.tonemap_gamma(torch.from_numpy(x), gamma, OUTS[out]),
                jtm.tonemap_gamma(x, gamma, OUTS[out]))


def test_metering_keeps_the_negated_log_max():
  x = make_test_rgb(16, 16)
  stats = ttm.metering(torch.from_numpy(x))
  _assert_close(stats, jtm.metering(jnp.asarray(x)))
  gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
  log_gray = np.log(np.maximum(gray, 1e-4))
  np.testing.assert_allclose(stats[1].item(), -log_gray.max(), rtol=1e-5)
  np.testing.assert_allclose(stats[0].item(), log_gray.min(), rtol=1e-5)


@pytest.mark.parametrize("params", REINHARD, ids=str)
def test_reinhard_map_matches_jax(params):
  x = np.clip(SRC * 1.5, 0, 1).astype(np.float32)
  stats = np.array(jtm.metering(jnp.asarray(x)))
  args = [params.get(k, d) for k, d in (("intensity", 1.0),
                                        ("light_adapt", 1.0),
                                        ("color_adapt", 0.0))]
  want = jtm.reinhard_map(jnp.asarray(x), jnp.asarray(stats),
                          *[jnp.float32(a) for a in args])
  _assert_close(ttm.reinhard_map(torch.from_numpy(x),
                                 torch.from_numpy(stats), *args), want)


@pytest.mark.parametrize("out", OUTS)
def test_linear_map_matches_jax(out):
  x = SRC * 2.0 - 0.1
  want = jtm.linear_map(jnp.asarray(x), jnp.float32(-0.1), jnp.float32(1.7),
                        jnp.float32(2.2), OUTS[out])
  _assert_close(ttm.linear_map(torch.from_numpy(x), -0.1, 1.7, 2.2,
                               OUTS[out]), want)


def test_metering_roundtrip_np():
  m = ttm.metering_from_np(np.arange(7, dtype=np.float32))
  assert isinstance(m.log_bounds, tbounds.Bounds)
  np.testing.assert_array_equal(ttm.metering_to_np(m), np.arange(7))
  np.testing.assert_array_equal(
      m.to_vec(), jtm.metering_from_np(np.arange(7, dtype=np.float32))
      .to_vec())


def test_bounds_matches_jax():
  a, b = tbounds.Bounds(0.5, 2.0), tbounds.Bounds(-1.0, 1.0)
  ja, jb = jbounds.Bounds(0.5, 2.0), jbounds.Bounds(-1.0, 1.0)
  assert a.span == ja.span
  assert a.union(b) == tbounds.Bounds(-1.0, 2.0)
  assert (a.union(b).min, a.union(b).max) == (ja.union(jb).min,
                                               ja.union(jb).max)
  assert a.expand(3.0) == tbounds.Bounds(0.5, 3.0)
  np.testing.assert_array_equal(a.to_vec(), ja.to_vec())


@pytest.mark.parametrize("src", ["u8", "u16", "f32"])
def test_to_float_matches_jax(src):
  x = SOURCES[src]
  _assert_close(ttypes.to_float(torch.from_numpy(x)), jtypes.to_float(x))


@pytest.mark.parametrize("out", ["uint8", "uint16", "int16", "float16",
                                 "float32"])
def test_from_float_matches_jax(out):
  x = np.linspace(-0.25, 1.25, 97, dtype=np.float32)
  for clip in (True, False):
    if not clip and not out.startswith("float"):
      continue  # out of range: wraps, which neither side defines
    got = ttypes.from_float(torch.from_numpy(x), out, clip=clip)
    want = np.asarray(jtypes.from_float(jnp.asarray(x), out, clip=clip))
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  want.astype(np.float32))


def test_public_names_match_jax():
  assert sorted(ttm.__all__) == sorted(jtm.__all__)
