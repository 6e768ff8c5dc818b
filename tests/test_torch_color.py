"""Color conversions: the port's ``ops/color.py`` against the JAX
package's on the CPU, and both against the numpy oracle.

Contracts:
  * f32 results within 1e-6 absolute of JAX (XLA's 3-term dot may sum in
    another order, and its pow may differ by an ulp);
  * u8 and u16 results within 1 count of JAX (a rounding ulp can cross a
    truncation boundary);
  * the oracle as tests/test_yuv.py holds JAX to it: f32 within 1e-5,
    integers within 1 count;
  * the reference's quirks: V-then-U planes, ``min(1, x)`` as the only
    clamp of f32 output, the matrix on the channel-reversed vector.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu.ops import color as jcolor  # noqa: E402
from taichi_image_tpu_torch.ops import color as tcolor  # noqa: E402
from conftest import make_test_rgb  # noqa: E402
from oracle import rgb_yuv420_oracle, yuv420_rgb_oracle  # noqa: E402

DTYPES = {"u8": np.uint8, "u16": np.uint16, "f32": np.float32}


def _image(dtype, h=32, w=48, seed=0):
  src = make_test_rgb(h, w, seed)
  if dtype == np.float32:
    return src
  return (src * np.iinfo(dtype).max).astype(dtype)


def _assert_close(got, want):
  got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape and got.dtype == want.dtype, (
      got.shape, got.dtype, want.shape, want.dtype)
  if want.dtype.kind == "f":
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
  else:
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, d.max()


POINT_FNS = ["bgr_YCrCb", "rgb_YCrCb", "YCrCb_bgr", "YCrCb_rgb", "rgb_gray",
             "bgr_gray", "rgb_linear", "rgb_ciexyz"]


@pytest.mark.parametrize("fn", POINT_FNS)
def test_point_functions_match_jax(fn):
  x = np.random.default_rng(3).random((5, 7, 3), np.float32)
  want = getattr(jcolor, fn)(jnp.asarray(x))
  _assert_close(getattr(tcolor, fn)(torch.from_numpy(x)), want)
  # numpy input is accepted too, moved to the device asked for
  _assert_close(getattr(tcolor, fn)(x, device="cpu"), want)


@pytest.mark.parametrize("out", [None, "u8", "u16", "f32"])
@pytest.mark.parametrize("src", DTYPES)
def test_rgb_yuv420_matches_jax(src, out):
  img = _image(DTYPES[src])
  out_dt = None if out is None else DTYPES[out]
  yj, uvj = jcolor.rgb_yuv420(img, out_dt)
  yt, uvt = tcolor.rgb_yuv420(torch.from_numpy(img), out_dt)
  _assert_close(yt, yj)
  _assert_close(uvt, uvj)
  _assert_close(tcolor.rgb_yuv420_image(torch.from_numpy(img), out_dt),
                jcolor.rgb_yuv420_image(img, out_dt))


@pytest.mark.parametrize("out", [None, "u8", "f32"])
@pytest.mark.parametrize("src", DTYPES)
def test_yuv420_rgb_matches_jax(src, out):
  yuv = np.array(jcolor.rgb_yuv420_image(_image(DTYPES[src], seed=1)))
  out_dt = None if out is None else DTYPES[out]
  _assert_close(tcolor.yuv420_rgb_image(torch.from_numpy(yuv), out_dt),
                jcolor.yuv420_rgb_image(yuv, out_dt))
  yj, uvj, _ = jcolor.split_yuv_420(yuv)
  _assert_close(tcolor.yuv420_rgb(torch.from_numpy(np.asarray(yj)),
                                  torch.from_numpy(np.asarray(uvj)), out_dt),
                jcolor.yuv420_rgb(yj, uvj, out_dt))


@pytest.mark.parametrize("src", ["u8", "f32"])
def test_rgb_yuv420_vs_oracle(src):
  img = _image(DTYPES[src], seed=2)
  got = tcolor.rgb_yuv420_image(torch.from_numpy(img)).numpy()
  want = rgb_yuv420_oracle(img)
  assert got.dtype == want.dtype
  if src == "f32":
    np.testing.assert_allclose(got, want, atol=1e-5)
  else:
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("src", ["u8", "f32"])
def test_yuv420_rgb_vs_oracle(src):
  yuv = rgb_yuv420_oracle(_image(DTYPES[src], seed=4))
  got = tcolor.yuv420_rgb_image(torch.from_numpy(yuv)).numpy()
  want = yuv420_rgb_oracle(yuv)
  assert got.dtype == want.dtype
  if src == "f32":
    np.testing.assert_allclose(got, want, atol=1e-5)
  else:
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_split_shapes():
  y, uv, (w, h) = tcolor.split_yuv_420(torch.zeros(48, 32, dtype=torch.uint8))
  assert tuple(y.shape) == (32, 32) and tuple(uv.shape) == (2, 16, 16)
  assert (w, h) == (32, 32)


def test_planes_are_v_then_u():
  """A pure-blue block, which the reversed vector reads as red: V (Cr) is
  high and U (Cb) low, and plane 0 holds V."""
  img = np.zeros((2, 2, 3), np.float32)
  img[..., 2] = 1.0
  y, uv = tcolor.rgb_yuv420(torch.from_numpy(img))
  # the matrix applies to the REVERSED vector: blue is its first entry
  np.testing.assert_allclose(y.numpy(), 0.299, atol=1e-7)
  np.testing.assert_allclose(uv[0].numpy(), 0.5 + 0.5 * 1.0, atol=1e-7)
  np.testing.assert_allclose(uv[1].numpy(), np.minimum(1.0, 0.5 - 0.168736),
                             atol=1e-7)


def test_upper_clamp_only():
  """min(1, x): f32 output keeps values below 0, clips those above 1."""
  y = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
  uv = torch.tensor([[[0.0]], [[1.0]]])  # V = 0, U = 1
  rgb = tcolor.yuv420_rgb(y, uv).numpy()
  want = np.asarray(jcolor.yuv420_rgb(y.numpy(), uv.numpy()))
  assert rgb.min() < 0 and rgb.max() <= 1.0
  np.testing.assert_allclose(rgb, want, atol=1e-6)


def test_constants_match_jax():
  for name in ("_GRAY", "_YUV_M", "_YUV_M_INV", "_YUV_OFFSET", "_XYZ_M"):
    got, want = getattr(tcolor, name), getattr(jcolor, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_public_names_match_jax():
  assert sorted(tcolor.__all__) == sorted(jcolor.__all__)
