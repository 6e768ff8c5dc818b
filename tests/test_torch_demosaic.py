"""K2 demosaic stencil (with fused finish and metering samples): the
port's plain twin against the JAX demosaic — its XLA route and the
Pallas stencil in interpret mode. Contract: x12 and samples bitwise
without a CCM; with one, <=1 bf16 ulp on <0.1% of pixels
(tests/test_pallas.py:158-168). Also the table equality of §6: the
port's stencil tables equal the JAX ones exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu.models.camera_isp import default_cc  # noqa: E402
from taichi_image_tpu.ops import bayer as jbayer  # noqa: E402
from taichi_image_tpu.ops.pallas import demosaic as pl_dm  # noqa: E402
from taichi_image_tpu_torch.ops import bayer as tbayer  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import demosaic as th_dm  # noqa: E402

PATTERNS = ["RGGB", "GRBG", "GBRG", "BGGR"]
# the default CCM with the default white balance folded in, as the ISP
# builds it (camera_isp.py:374-387)
CCM = tuple((default_cc * np.array([1.8, 1.0, 2.1])).astype(np.float32)
            .ravel().tolist())


def _bits(x):
  if isinstance(x, torch.Tensor):
    return x.contiguous().view(torch.int16).numpy().view(np.uint16)
  return np.asarray(x).view(np.uint16)


def _phases(shape, seed=0):
  """bf16 phase planes, as numpy bits and as (jax, torch) arrays."""
  x = np.random.default_rng(seed).random(shape, np.float32)
  j = jnp.asarray(x, jnp.bfloat16)
  t = torch.from_numpy(_bits(j).view(np.int16).copy()).view(torch.bfloat16)
  return j, t


def _assert_contract(got, want, cc, name):
  g = _bits(got).astype(np.int64)
  w = _bits(want).astype(np.int64)
  assert g.shape == w.shape, name
  if cc is None:
    np.testing.assert_array_equal(g, w, err_msg=name)
  else:
    d = np.abs(g - w)
    assert d.max() <= 1 and (d != 0).mean() < 1e-3, (name, d.max(),
                                                      (d != 0).mean())


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_demosaic_matches_xla(pattern, cc):
  pat = jbayer.BayerPattern[pattern]
  jp, tp = _phases((2, 4, 24, 96), seed=pat.value)
  want_x, want_s = jbayer.demosaic_phases(jp, pat, cc=cc,
                                          out_dtype=jnp.bfloat16,
                                          backend="xla", sample_step=4)
  got_x, got_s = tbayer.demosaic_phases(tp, tbayer.BayerPattern[pattern],
                                        cc=cc, out_dtype=torch.bfloat16,
                                        sample_step=4)
  _assert_contract(got_x, want_x, cc, "x12")
  _assert_contract(got_s, want_s, cc, "sample")


@pytest.mark.parametrize("method", ["mhc", "bilinear"])
def test_demosaic_odd_shape_matches_xla(method):
  jp, tp = _phases((3, 4, 19, 50), seed=7)
  pat = jbayer.BayerPattern.GRBG
  want_x, want_s = jbayer.demosaic_phases(jp, pat, method=method,
                                          out_dtype=jnp.bfloat16,
                                          backend="xla", sample_step=4)
  got_x, got_s = tbayer.demosaic_phases(tp, tbayer.BayerPattern.GRBG,
                                        method=method,
                                        out_dtype=torch.bfloat16,
                                        sample_step=4)
  assert tuple(got_s.shape) == (3, 3, 5, 13)
  _assert_contract(got_x, want_x, None, "x12")
  _assert_contract(got_s, want_s, None, "sample")


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
@pytest.mark.parametrize("pattern", ["RGGB", "BGGR"])
def test_demosaic_matches_pallas_interpret(pattern, cc):
  hh, wh = 32, 512
  jp, tp = _phases((2, 4, hh, wh), seed=11)
  pat = jbayer.BayerPattern[pattern]
  weights = jbayer._demosaic_tables(pat, "mhc")
  fin = jbayer._stencil_finish_spec(weights, hh, wh, cc, jnp.bfloat16)
  tiles = pl_dm.tiling_for(hh, wh, 4, in_bf16=True, out_bf16=True)
  want_x, want_s = pl_dm.demosaic_stencil(jp, weights, *tiles,
                                          interpret=True, sample_step=4,
                                          finish=fin)
  want_s = want_s.astype(jnp.bfloat16)  # the kernel emits final f32
  got_x, got_s = tbayer.demosaic_phases(tp, tbayer.BayerPattern[pattern],
                                        cc=cc, out_dtype=torch.bfloat16,
                                        sample_step=4)
  _assert_contract(got_x, want_x, cc, "x12")
  _assert_contract(got_s, want_s, cc, "sample")


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
def test_sample_is_strided_x12(cc):
  _, tp = _phases((2, 4, 30, 70), seed=3)
  x12, samp = tbayer.demosaic_phases(tp, tbayer.BayerPattern.RGGB, cc=cc,
                                     out_dtype=torch.bfloat16, sample_step=4)
  np.testing.assert_array_equal(_bits(samp), _bits(x12[:, 0:3, ::4, ::4]))


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
@pytest.mark.parametrize("method", ["mhc", "bilinear"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_tables_equal_jax(pattern, method, cc):
  hh, wh = 19, 50
  jw = jbayer._demosaic_tables(jbayer.BayerPattern[pattern], method)
  tw = tbayer._demosaic_tables(tbayer.BayerPattern[pattern], method)
  assert tw.dtype == jw.dtype and np.array_equal(tw, jw)
  jf = jbayer._stencil_finish_spec(jw, hh, wh, cc, jnp.bfloat16)
  tf = tbayer._stencil_finish_spec(tw, hh, wh, cc, torch.bfloat16)
  assert set(jf) == set(tf)
  for k in jf:
    if k == "out_dtype":
      assert tf[k] == torch.bfloat16
    elif jf[k] is None or np.isscalar(jf[k]):
      assert tf[k] == jf[k], k
    else:
      assert tf[k].dtype == jf[k].dtype and np.array_equal(tf[k], jf[k]), k
  # the kernel's parameter block carries exactly these weights: every
  # nonzero one sits on its output phase's diamond taps
  block = th_dm.stencil_params(tw, tf)
  assert block.size == th_dm.PARAM_FLOATS
  w13 = block[:156].reshape(12, 13)
  for oc in range(12):
    want = np.zeros(36, np.float32)
    want[th_dm.DIAMOND_TAPS[oc // 3]] = w13[oc]
    np.testing.assert_array_equal(want, jw[oc].reshape(-1))


def test_kernel_tap_table_matches_python():
  """The stencil's compile-time kTaps (csrc/stencil.cuh, shared by K2
  and K7) equals the table the wrapper gathers the weights with
  (ops/hopper/demosaic.DIAMOND_TAPS)."""
  import re
  src = (th_dm.hopper.CSRC / "stencil.cuh").read_text()
  body = re.search(r"kTaps\[4\]\[13\] = \{(.*?)\};", src, re.S).group(1)
  rows = [[int(v) for v in r.split(",")]
          for r in re.findall(r"\{([^{}]*)\}", body)]
  np.testing.assert_array_equal(np.array(rows), th_dm.DIAMOND_TAPS)
