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


def _c_table(name):
  """The rows of a brace-initialised table in csrc/stencil.cuh."""
  import re
  src = (th_dm.hopper.CSRC / "stencil.cuh").read_text()
  body = re.search(name + r"\[[^\]]*\]\[\d+\] = \{(.*?)\};", src,
                   re.S).group(1)
  return [[int(v, 0) for v in r.split(",")]
          for r in re.findall(r"\{([^{}]*)\}", body)]


VARIANT_IDS = [f"{p.name}-{m}" for p, m in th_dm.VARIANTS]


def _nonzero_masks(weights):
  """Per channel, the 13-bit mask of nonzero weights at its phase's
  diamond taps, from a (12, 4, 3, 3) weight table."""
  w36 = np.asarray(weights).reshape(12, 36)
  return [sum(1 << k for k, tap in enumerate(th_dm.DIAMOND_TAPS[oc // 3])
              if w36[oc, tap] != 0) for oc in range(12)]


@pytest.mark.parametrize("variant", range(8), ids=VARIANT_IDS)
def test_kernel_tap_masks_match_tables(variant):
  """Row ``variant`` of the stencil's compile-time kTapMasks is the
  nonzero pattern of the JAX package's weight table for that (pattern,
  method), and no weight lies off the masks."""
  pattern, method = th_dm.VARIANTS[variant]
  jw = jbayer._demosaic_tables(jbayer.BayerPattern[pattern.name], method)
  table = _c_table("kTapMasks")
  assert len(table) == len(th_dm.VARIANTS)
  assert table[variant] == _nonzero_masks(jw)
  live = sum(bin(m).count("1") for m in table[variant])
  assert live == (84 if method == "mhc" else 28)


@pytest.mark.parametrize("variant", range(8), ids=VARIANT_IDS)
def test_tap_variant_picks_each_table(variant):
  pattern, method = th_dm.VARIANTS[variant]
  weights = tbayer._demosaic_tables(pattern, method)
  assert th_dm.tap_variant(weights) == variant
  assert th_dm.TAP_MASKS[variant] == tuple(_nonzero_masks(weights))


@pytest.mark.parametrize("change", ["drop_tap", "add_tap", "dense"])
def test_tap_variant_refuses_other_patterns(change):
  """Weights whose zero pattern no compiled variant has are refused:
  the kernel sums only the masked taps and has no all-13-tap path."""
  w = tbayer._demosaic_tables(tbayer.BayerPattern.RGGB, "mhc").copy()
  w36 = w.reshape(12, 36)
  taps = th_dm.DIAMOND_TAPS[1]          # channel 3's phase
  if change == "drop_tap":
    w36[3, taps[np.flatnonzero(w36[3, taps])[0]]] = 0.0
  elif change == "add_tap":
    w36[3, taps[np.flatnonzero(w36[3, taps] == 0)[0]]] = 0.5
  else:
    for oc in range(12):
      w36[oc, th_dm.DIAMOND_TAPS[oc // 3]] = 1.0 / 13
  with pytest.raises(ValueError, match="no compiled variant"):
    th_dm.tap_variant(w)


def _masked_twin(phases, weights, fin):
  """The kernel's arithmetic in torch: per channel, only the taps its
  compile-time mask keeps, summed from -0 in DIAMOND_TAPS order, then
  inv_full, the border factor, the CCM, the clip and one cast."""
  n, _, hh, wh = phases.shape
  xp = torch.nn.functional.pad(phases.to(torch.float32), (1, 1, 1, 1))
  block = th_dm.stencil_params(weights, fin)
  w13, inv_full = block[:156].reshape(12, 13), block[156:168]
  masks = th_dm.TAP_MASKS[th_dm.tap_variant(weights)]
  outs = []
  for ph in range(4):
    vals = []
    for c in range(3):
      oc = ph * 3 + c
      a = torch.full((n, hh, wh), -0.0)
      for k in range(13):
        if masks[oc] >> k & 1:
          q, u, v = np.unravel_index(th_dm.DIAMOND_TAPS[ph][k], (4, 3, 3))
          a = a + xp[:, q, u:u + hh, v:v + wh] * float(w13[oc, k])
      val = a * float(inv_full[oc])
      vals.append(val * th_dm._border_factor(oc, hh, wh, fin, a.device))
    if fin["cc"] is not None:
      ccm = fin["cc"]
      vals = [vals[0] * float(ccm[d, 0]) + vals[1] * float(ccm[d, 1])
              + vals[2] * float(ccm[d, 2]) for d in range(3)]
    outs += [torch.clamp(v, 0.0, 1.0).to(fin["out_dtype"]) for v in vals]
  return torch.stack(outs, dim=1)


def _int_bits(t):
  it = torch.int32 if t.dtype == torch.float32 else torch.int16
  return t.contiguous().view(it).numpy()


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
@pytest.mark.parametrize("variant", range(8), ids=VARIANT_IDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_masked_tap_sum_is_twin(dtype, variant, cc):
  """Summing only the masked taps from -0 (the kernel's order) gives the
  plain twin's x12 bit for bit, sign of zero included, on phases with
  exact zeros: a dark band, a zero column and scattered zero pixels."""
  dt = getattr(torch, dtype)
  n, hh, wh = 2, 12, 21
  rng = np.random.default_rng(variant)
  x = rng.random((n, 4, hh, wh), np.float32)
  x[rng.random(x.shape) < 0.3] = 0.0
  x[:, :, 3:6, :] = 0.0
  x[:, :, :, 7] = 0.0
  phases = torch.from_numpy(x).to(dt)
  pattern, method = th_dm.VARIANTS[variant]
  weights = tbayer._demosaic_tables(pattern, method)
  fin = tbayer._stencil_finish_spec(weights, hh, wh, cc, dt)
  want, _ = th_dm.demosaic_stencil_plain(phases, weights, fin)
  got = _masked_twin(phases, weights, fin)
  np.testing.assert_array_equal(_int_bits(got), _int_bits(want))


@pytest.mark.parametrize("method", ["mhc", "bilinear"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_params_block_inv_full(pattern, method):
  """The parameter block's inv_full is f32(1 / sum of weights) with the
  sum's f32 value divided in Python double, as the JAX stencil takes it."""
  w = tbayer._demosaic_tables(tbayer.BayerPattern[pattern], method)
  fin = tbayer._stencil_finish_spec(w, 19, 50, None, torch.bfloat16)
  block = th_dm.stencil_params(w, fin)
  want = [np.float32(1.0 / float(s)) for s in w.sum(axis=(1, 2, 3))]
  np.testing.assert_array_equal(block[156:168], np.array(want, np.float32))


def test_params_refuse_weights_off_the_diamond():
  w = tbayer._demosaic_tables(tbayer.BayerPattern.RGGB, "mhc").copy()
  w36 = w.reshape(12, 36)
  off = np.setdiff1d(np.arange(36), th_dm.DIAMOND_TAPS[0])[0]
  w36[0, off] = 0.25
  fin = tbayer._stencil_finish_spec(w, 19, 50, None, torch.bfloat16)
  with pytest.raises(ValueError, match="outside the diamond"):
    th_dm.stencil_params(w, fin)
  with pytest.raises(ValueError, match="outside the diamond"):
    th_dm.tap_variant(w)
