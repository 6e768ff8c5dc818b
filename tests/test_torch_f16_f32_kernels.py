"""The f16 and f32 instantiations of K1-K4 (Camera16 / Camera32): the
port's plain twins against the JAX package on the CPU, in its XLA routes
and in the TPU kernels they replace, run in interpret mode.

f16 is held to the JAX package's strict f16 route, the semantics its
TPU-only q16 route (K5 decode, K6 stencil, K11 map) approximates within
<=1 u8 count (tests/test_q16.py); here the port is also held to those q16
kernels and to the packed-f16 map K10 directly.

Two limits of the CPU comparison, both measured in this file's inputs:

- XLA's CPU compiler contracts a*b + c into a fused multiply-add, in
  interpret-mode Pallas kernels as well; the port rounds after every op
  (its CUDA kernels are built with --fmad=false). Bitwise agreement in
  f32 therefore holds between each kernel and its twin on the card
  (chip_smoke.py), while on the CPU K2<f32> is held to the Pallas stencil
  within 2^-21 absolute without a CCM (measured 2.4e-7) and 2^-20 with
  one (measured 6.0e-7); in bf16 and f16 the FMA's f32 ulps vanish in the
  final rounding and the stencil is bitwise.
- K8 and the XLA map take jnp.power where the port (like the bf16 TPU
  kernel) takes exp2(k * log2(b)): f32 p agrees within 2e-6 relative
  (measured 3.5e-7, 4-5 f32 ulps), f16 p within 1 f16 ulp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.ops import bayer as jbayer  # noqa: E402
from taichi_image_tpu.ops.pallas import decode as pl_decode  # noqa: E402
from taichi_image_tpu.ops.pallas import demosaic as pl_dm  # noqa: E402
from taichi_image_tpu.ops.pallas import f16pack, q16  # noqa: E402
from taichi_image_tpu.ops.pallas import reinhard as pl_rh  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops import bayer as tbayer  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import decode as th_decode  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import demosaic as th_dm  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import finish as th_fin  # noqa: E402

DT = {"f16": (np.float16, jnp.float16, torch.float16),
      "f32": (np.float32, jnp.float32, torch.float32)}
CCM = tuple((jci.default_cc * np.array([1.8, 1.0, 2.1])).astype(np.float32)
            .ravel().tolist())
M = np.asarray([0.02, 0.98, -3.0, -0.1, -1.2, 0.4, 0.45, 0.4, 0.35],
               np.float32)


def _ulps(a, b):
  """Elementwise distance in ulps of a's float dtype (f16 or f32), on the
  ordered integer view (+0 and -0 coincide)."""
  a = np.asarray(a)
  b = np.asarray(b, a.dtype)
  it = {2: np.int16, 4: np.int32}[a.dtype.itemsize]

  def key(x):
    s = x.view(it).astype(np.int64)
    return np.where(s < 0, -(s & np.iinfo(it).max), s)
  return np.abs(key(a) - key(b))


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("dt", ["f16", "f32"])
def test_decode_matches_xla_route(dt, ids):
  npd, jd, td = DT[dt]
  raws = np.random.default_rng(3).integers(0, 256, size=(2, 38, 150),
                                           dtype=np.uint8)
  want = np.asarray(jci.load_raw_phases(jnp.asarray(raws), "packed12", jd,
                                        ids))
  got = th_decode.decode12_phases(torch.from_numpy(raws), ids, td)
  assert got.dtype == td and tuple(got.shape) == want.shape
  np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                want.view(np.uint8))


@pytest.mark.parametrize("ids", [False, True])
def test_decode_f16_matches_q16_kernel(ids):
  """K5 (interpret mode) decodes the raw 12-bit codes exactly; the
  strict route's f16 phases are f32(code) * f32(1/4095) rounded once."""
  raws = np.random.default_rng(4).integers(0, 256, size=(2, 32, 1152),
                                           dtype=np.uint8)
  words = pl_decode.decode12_phases_q16(jnp.asarray(raws), ids,
                                        interpret=True)
  codes = np.asarray(q16.unpack_channels(words))
  want = (codes.astype(np.float32) * np.float32(1 / 4095)).astype(np.float16)
  got = th_decode.decode12_phases(torch.from_numpy(raws), ids,
                                  torch.float16).numpy()
  np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


# ------------------------------------------------------------------ K2

def _pallas_stencil_f32(ph_f32, cc, hh=32, wh=512):
  w = jbayer._demosaic_tables(jbayer.BayerPattern.RGGB, "mhc")
  fin = jbayer._stencil_finish_spec(w, hh, wh, cc, jnp.float32)
  tiles = pl_dm.tiling_for(hh, wh, 4, in_bf16=False, out_bf16=False)
  x, s = pl_dm.demosaic_stencil(jnp.asarray(ph_f32), w, *tiles,
                                interpret=True, sample_step=4, finish=fin)
  return np.asarray(x), np.asarray(s)


def _port_stencil(ph, cc, dtype, hh=32, wh=512):
  w = tbayer._demosaic_tables(tbayer.BayerPattern.RGGB, "mhc")
  fin = tbayer._stencil_finish_spec(w, hh, wh, cc, dtype)
  x, s = th_dm.demosaic_stencil(torch.from_numpy(ph), w, fin, 4)
  return x.numpy(), s.numpy()


@pytest.mark.parametrize("cc,atol", [(None, 2.0 ** -21), (CCM, 2.0 ** -20)],
                         ids=["nocc", "ccm"])
def test_stencil_f32_matches_pallas_interpret(cc, atol):
  ph = np.random.default_rng(5).random((2, 4, 32, 512), np.float32)
  want_x, want_s = _pallas_stencil_f32(ph, cc)
  got_x, got_s = _port_stencil(ph, cc, torch.float32)
  assert got_x.dtype == np.float32 and got_x.shape == want_x.shape
  np.testing.assert_allclose(got_x, want_x, rtol=0, atol=atol)
  np.testing.assert_allclose(got_s, want_s, rtol=0, atol=atol)
  np.testing.assert_array_equal(got_s, got_x[:, 0:3, ::4, ::4])


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
def test_stencil_f16_is_cast_of_pallas_f32(cc):
  """K2<f16> rounds the same f32 value K2<f32> computes: bitwise against
  the f16 cast of the Pallas f32 finish without a CCM, <=1 f16 ulp on
  <0.1% of pixels with one (the FMA limit above)."""
  ph = np.random.default_rng(6).random((2, 4, 32, 512)).astype(np.float16)
  want_x, want_s = _pallas_stencil_f32(ph.astype(np.float32), cc)
  got_x, got_s = _port_stencil(ph, cc, torch.float16)
  assert got_x.dtype == np.float16
  for got, want in ((got_x, want_x), (got_s, want_s)):
    d = _ulps(got, want.astype(np.float16))
    if cc is None:
      assert d.max() == 0, d.max()
    else:
      assert d.max() <= 1 and (d != 0).mean() < 1e-3, (d.max(),
                                                        (d != 0).mean())
  # and the f32 instantiation on the same phases, cast, is bitwise the f16
  f32_x, _ = _port_stencil(ph.astype(np.float32), cc, torch.float32)
  np.testing.assert_array_equal(f32_x.astype(np.float16).view(np.uint16),
                                got_x.view(np.uint16))


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
@pytest.mark.parametrize("shape", [(2, 4, 24, 96), (3, 4, 19, 50)])
def test_stencil_f16_matches_xla(shape, cc):
  ph = np.random.default_rng(7).random(shape).astype(np.float16)
  want_x, want_s = jbayer.demosaic_phases(
      jnp.asarray(ph), jbayer.BayerPattern.GBRG, cc=cc,
      out_dtype=jnp.float16, backend="xla", sample_step=4)
  w = tbayer.BayerPattern.GBRG
  got_x, got_s = tbayer.demosaic_phases(torch.from_numpy(ph), w, cc=cc,
                                        out_dtype=torch.float16,
                                        sample_step=4)
  for got, want in ((got_x, want_x), (got_s, want_s)):
    d = _ulps(got.numpy(), np.asarray(want))
    assert d.max() <= 1, d.max()


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
def test_stencil_f16_matches_q16_kernel(cc):
  """K6 (interpret mode) runs the stencil on the exact 12-bit codes and
  stores x12 as 16-bit codes; the port stores the same f32 stencil value
  as f16. Held on the phases K6 sees (code / 4095 in f32, through the
  port's stencil and one f16 rounding): within 0.5 f16 ulp + 2e-5, the
  q16 bound of tests/test_q16.py:127 plus the f16 store. The strict
  route, and so K2<f16> in the slice, rounds the phases themselves to
  f16 first (up to 2^-12 at full scale), which K5 avoids; the slice tests
  hold that difference to <=1 u8 count."""
  codes = np.random.default_rng(8).integers(0, 4096, size=(2, 4, 32, 512))
  words = q16.pack_pair(jnp.asarray(codes[:, 0::2], jnp.int32),
                        jnp.asarray(codes[:, 1::2], jnp.int32))
  outw, samp = jbayer.demosaic_phases_q16(words, jbayer.BayerPattern.RGGB,
                                          cc=cc, sample_step=4,
                                          interpret=True)
  k6 = np.asarray(q16.decode_x12(q16.unpack_channels(outw)))
  x32, _ = _port_stencil((codes / 4095.0).astype(np.float32), cc,
                         torch.float32)
  port = x32.astype(np.float16)
  # one f16 rounding of the same value is what K2<f16> stores (the
  # bitwise cast test above)
  ulp = np.spacing(port).astype(np.float32)
  d = np.abs(port.astype(np.float32) - k6)
  assert (d <= 0.5 * ulp + 2e-5).all(), (d / (0.5 * ulp + 2e-5)).max()
  ds = np.abs(port[:, 0:3, ::4, ::4].astype(np.float32) - np.asarray(samp))
  assert (ds <= 0.5 * ulp[:, 0:3, ::4, ::4] + 2e-5).all()


# ------------------------------------------------------------------ K3

def _x12(shape, dtype, seed=0):
  x = np.random.default_rng(seed).random(shape) * 0.9 + 0.05
  return x.astype(dtype)


def test_map_f32_matches_k8_interpret():
  x = _x12((2, 12, 16, 128), np.float32, seed=9)
  want_p, want_m = pl_rh.reinhard_map_pallas(jnp.asarray(x), jnp.asarray(M),
                                             1.0, 1.0, interpret=True)
  got_p, got_m = tci.reinhard_map_max_ca(torch.from_numpy(x),
                                         torch.from_numpy(M), 1.0, 1.0, 0.0,
                                         torch.float32)
  assert got_p.dtype == torch.float32
  np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=2e-6,
                             atol=0)
  np.testing.assert_allclose(got_m.numpy().ravel(),
                             np.asarray(want_m).ravel(), rtol=1e-5)


def test_map_f16_matches_packed_kernel_interpret():
  """K10 reads and writes f16 bits packed two per i32 (K9 is its
  manual-DMA form with the same outputs and no interpret switch)."""
  x = _x12((2, 12, 16, 128), np.float16, seed=10)
  words = f16pack.pack_channel_pairs(jnp.asarray(x))
  pw, want_m = pl_rh.reinhard_map_packed(words, jnp.asarray(M), 1.0, 1.0,
                                         interpret=True)
  want_p = np.asarray(f16pack.unpack_channel_pairs(pw))
  got_p, got_m = tci.reinhard_map_max_ca(torch.from_numpy(x),
                                         torch.from_numpy(M), 1.0, 1.0, 0.0,
                                         torch.float16)
  assert got_p.dtype == torch.float16
  assert _ulps(got_p.numpy(), want_p).max() <= 1
  np.testing.assert_allclose(got_m.numpy().ravel(),
                             np.asarray(want_m).ravel(), rtol=1e-5)


@pytest.mark.parametrize("ca", [0.0, 0.4])
@pytest.mark.parametrize("dt", ["f16", "f32"])
def test_map_matches_xla(dt, ca):
  npd, jd, td = DT[dt]
  x = _x12((2, 12, 16, 128), npd, seed=11)
  p = jci.reinhard_map_ca(jnp.asarray(x).reshape(2, 4, 3, 16, 128),
                          jnp.asarray(M), 1.3, 0.8, ca)
  want_m = np.asarray(jnp.max(p, axis=(1, 2, 3, 4)))
  want_p = np.asarray(p.astype(jd)).reshape(x.shape)
  got_p, got_m = tci.reinhard_map_max_ca(torch.from_numpy(x),
                                         torch.from_numpy(M), 1.3, 0.8, ca,
                                         td)
  assert got_p.dtype == td
  if dt == "f16":
    assert _ulps(got_p.numpy(), want_p).max() <= 1
  else:
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=2e-6, atol=0)
  np.testing.assert_allclose(got_m.numpy().ravel(), want_m, rtol=1e-5)


def test_map_f16_keeps_subnormal_p():
  """p below 6.1e-5 is an f16 subnormal: the twin's store keeps it (the
  kernel is built without -ftz or fast math to do the same)."""
  # f16(0.02) lies 4.3e-6 above m0 = 0.02; with light_adapt 0 the adapt
  # level is the mean's, so p = scaled / (adapt + scaled) is ~1e-5
  x = np.full((1, 3, 2, 4), 0.02, np.float16)
  got_p, _ = tci.reinhard_map_max_ca(torch.from_numpy(x),
                                     torch.from_numpy(M), 1.0, 0.0, 0.0,
                                     torch.float16)
  p = got_p.numpy()
  assert ((p > 0) & (p < np.float16(6.1e-5))).all(), p
  want = jci.reinhard_map_ca(jnp.asarray(x).reshape(1, 1, 3, 2, 4),
                             jnp.asarray(M), 1.0, 0.0, 0.0)
  np.testing.assert_array_equal(
      p.view(np.uint16),
      np.asarray(want.astype(jnp.float16)).reshape(p.shape).view(np.uint16))


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("gamma", [1.0, 2.2])
@pytest.mark.parametrize("dt", ["f16", "f32"])
def test_finish_matches_xla_tail(dt, gamma):
  npd, jd, td = DT[dt]
  rng = np.random.default_rng(12)
  x = (rng.random((3, 12, 19, 50)) * 1.4 - 0.2).astype(npd)
  mx = np.linspace(0.8, 1.1, 3, dtype=np.float32).reshape(3, 1, 1, 1)
  want = np.asarray(jbayer.phases_to_planar(
      jci.reinhard_gamma_ca(jnp.asarray(x), jnp.asarray(mx), gamma)))
  got = th_fin.finish_planar_u8(torch.from_numpy(x), torch.from_numpy(mx),
                                gamma).numpy()
  assert got.dtype == np.uint8 and got.shape == (3, 3, 38, 100)
  if gamma == 1.0:
    np.testing.assert_array_equal(got, want)
  else:
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d != 0).mean() < 1e-4, (d.max(), (d != 0).sum())
