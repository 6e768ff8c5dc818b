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


# ------------------------------------------ banded mode (the large frames)
#
# The large-frame band loop reads a row band with one halo row on each
# side and gates the top and bottom factors at the image's own edges
# (top_row = 1 on the first band, bot_row = hb on the last, -1 elsewhere),
# as the JAX package's banded drivers do (tests/test_pallas.py:400). K7
# takes the same finish spec.

BAND_CC = tuple(np.array([[1.2, -0.1, 0.0], [-0.05, 1.1, -0.05],
                          [0.0, -0.1, 1.3]], np.float32).ravel().tolist())


def _band_kinds(hh, b):
  """(r0, top_row, bot_row) of each band of b rows of an hh-row frame."""
  return [(r0, 1 if r0 == 0 else -1, b if r0 + b == hh else -1)
          for r0 in range(0, hh, b)]


@pytest.mark.parametrize("cc", [None, BAND_CC], ids=["nocc", "ccm"])
@pytest.mark.parametrize("n_bands", [1, 2, 3])
def test_banded_twin_matches_pallas_interpret(n_bands, cc):
  """K2's twin in banded mode (a halo'd band in, its own rows out, with
  their sample) against the Pallas stencil in interpret mode on the same
  band with the same finish spec, its halo rows' outputs dropped: bitwise
  without a CCM, the K2 contract with one. One band carries both gates."""
  hh, wh, b = 8 * n_bands, 256, 8
  jp, tp = _phases((1, 4, hh, wh), seed=20 + n_bands)
  jw = jbayer._demosaic_tables(jbayer.BayerPattern.RGGB, "mhc")
  tw = tbayer._demosaic_tables(tbayer.BayerPattern.RGGB, "mhc")
  jpad = jnp.pad(jp, ((0, 0), (0, 0), (1, 1), (0, 0)))
  tpad = torch.nn.functional.pad(tp, (0, 0, 1, 1))
  tiles = pl_dm.tiling_for(b + 2, wh, in_bf16=True, out_bf16=True)
  bands, samples = [], []
  for r0, top, bot in _band_kinds(hh, b):
    fin_j = jbayer._stencil_finish_spec(jw, b + 2, wh, cc, jnp.bfloat16,
                                        top_row=top, bot_row=bot)
    want = pl_dm.demosaic_stencil(jpad[:, :, r0:r0 + b + 2], jw, *tiles,
                                  finish=fin_j, interpret=True)[:, :, 1:b + 1]
    fin_t = tbayer._stencil_finish_spec(tw, b + 2, wh, cc, torch.bfloat16,
                                        top_row=top, bot_row=bot)
    got, samp = th_dm.demosaic_stencil(tpad[:, :, r0:r0 + b + 2], tw, fin_t,
                                       4, rows=(1, b + 1))
    assert tuple(got.shape) == (1, 12, b, wh) and got.is_contiguous()
    _assert_contract(got, want, cc, f"band {r0}")
    np.testing.assert_array_equal(_bits(samp), _bits(got[:, 0:3, ::4, ::4]))
    bands.append(got)
    samples.append(samp)
  # the bands joined are the whole frame's stencil, bit for bit (the CCM
  # too: the twin's arithmetic is the same per pixel), and so are their
  # samples (band starts on the sample grid)
  whole, whole_s = tbayer.demosaic_phases(tp, tbayer.BayerPattern.RGGB, cc=cc,
                                          out_dtype=torch.bfloat16,
                                          sample_step=4)
  np.testing.assert_array_equal(_bits(torch.cat(bands, 2)), _bits(whole))
  np.testing.assert_array_equal(_bits(torch.cat(samples, 2)), _bits(whole_s))


@pytest.mark.parametrize("cc", [None, BAND_CC], ids=["nocc", "ccm"])
@pytest.mark.parametrize("n_bands", [2, 3])
def test_banded_front_fused_twin_matches_pallas_interpret(n_bands, cc):
  """K7's twin with the banded finish spec against the Pallas K7 in
  interpret mode on each band: p of the band's rows within one bf16 ulp
  (two with a CCM; tests/test_torch_front_fused.py says why), the max
  over the rows read within 1e-6 relative."""
  from taichi_image_tpu.models import camera_isp as jci
  from taichi_image_tpu.ops.pallas.reinhard import reinhard_scal as j_scal
  from taichi_image_tpu_torch.ops.hopper import front_fused as th_ff
  from taichi_image_tpu_torch.ops.hopper import reinhard as th_rh
  hh, wh, b = 8 * n_bands, 256, 8
  jp, tp = _phases((2, 4, hh, wh), seed=30 + n_bands)
  samp = jbayer.demosaic_samples(jp, jbayer.BayerPattern.RGGB, cc=cc,
                                 out_dtype=jnp.bfloat16, sample_step=4)
  metrics = jci.metering_update_ca(samp.astype(jnp.float32),
                                   jnp.zeros(9, jnp.float32),
                                   jnp.float32(0.0))
  scal_t = th_rh.reinhard_scal(torch.from_numpy(np.array(metrics)), 1.0, 1.0)
  jw = jbayer._demosaic_tables(jbayer.BayerPattern.RGGB, "mhc")
  tw = tbayer._demosaic_tables(tbayer.BayerPattern.RGGB, "mhc")
  jpad = jnp.pad(jp, ((0, 0), (0, 0), (1, 1), (0, 0)))
  tpad = torch.nn.functional.pad(tp, (0, 0, 1, 1))
  tiles = pl_dm.tiling_for(b + 2, wh, in_bf16=True, out_bf16=True,
                           extra_f32_tmp=pl_dm._TONEMAP_TMPS)
  for r0, top, bot in _band_kinds(hh, b):
    fin_j = jbayer._stencil_finish_spec(jw, b + 2, wh, cc, jnp.bfloat16,
                                        top_row=top, bot_row=bot)
    p_j, mx_j = pl_dm.demosaic_reinhard_stencil(
        jpad[:, :, r0:r0 + b + 2], jw, *tiles, j_scal(metrics, 1.0, 1.0),
        fin_j, interpret=True)
    fin_t = tbayer._stencil_finish_spec(tw, b + 2, wh, cc, torch.bfloat16,
                                        top_row=top, bot_row=bot)
    p_t, mx_t = th_ff.front_fused(tpad[:, :, r0:r0 + b + 2], tw, fin_t,
                                  scal_t)
    d = np.abs(_bits(p_t[:, :, 1:b + 1]).astype(np.int64)
               - _bits(p_j[:, :, 1:b + 1]).astype(np.int64))
    assert d.max() <= (1 if cc is None else 2), (r0, d.max())
    np.testing.assert_allclose(mx_t.numpy().ravel(),
                               np.asarray(mx_j).ravel(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["first", "interior", "last", "single"])
@pytest.mark.parametrize("hb", [30, 33, 64, 272])
@pytest.mark.parametrize("crop", [True, False], ids=["k2", "k7"])
def test_banded_edge_tiles_hold_the_gates(crop, hb, kind):
  """The kernels evaluate the border factors only on tiles that hold a
  gated row or an edge column (stencil.cuh tile_on_edge): on a halo'd
  band of hb + 2 rows, with K2's tiles starting at the first stored row
  (row 1) and K7's at row 0, every factor of every other tile's rows is
  exactly 1, and every pixel whose factor is not 1 lies on an edge
  tile."""
  import re
  src = (th_dm.hopper.CSRC / "stencil.cuh").read_text()
  tile_h = int(re.search(r"constexpr int kTileH = (\d+);", src).group(1))
  tile_w = int(re.search(r"constexpr int kRunsX = (\d+);", src).group(1)) * 4
  hh, wh = hb + 2, 300
  top = 1 if kind in ("first", "single") else -1
  bot = hb if kind in ("last", "single") else -1
  w = tbayer._demosaic_tables(tbayer.BayerPattern.GRBG, "mhc")
  fin = tbayer._stencil_finish_spec(w, hh, wh, CCM, torch.bfloat16,
                                    top_row=top, bot_row=bot)
  factor = torch.stack([th_dm._border_factor(oc, hh, wh, fin, "cpu")
                        for oc in range(12)])
  r0, end = (1, hb + 1) if crop else (0, hh)
  covered = torch.zeros(hh, wh, dtype=torch.bool)
  for y0 in range(r0, end, tile_h):
    for x0 in range(0, wh, tile_w):
      rows = range(y0, min(y0 + tile_h, end))
      if top in rows or bot in rows or x0 == 0 or x0 + tile_w >= wh:
        covered[y0:rows.stop, x0:x0 + tile_w] = True
      else:
        assert (factor[:, y0:rows.stop, x0:x0 + tile_w] == 1.0).all()
  stored = (factor != 1.0).any(0)
  stored[:r0] = stored[end:] = False
  assert covered[stored].all()
  # a gated row is the only row with the top or bottom factor
  rows_off = (factor[:, :, 1:-1] != 1.0).any(0).any(1)
  assert set(torch.nonzero(rows_off).ravel().tolist()) == (
      {top, bot} - {-1})


def test_banded_rows_refused_outside_the_frame():
  _, tp = _phases((1, 4, 10, 64))
  w = tbayer._demosaic_tables(tbayer.BayerPattern.RGGB, "mhc")
  fin = tbayer._stencil_finish_spec(w, 10, 64, None, torch.bfloat16,
                                    top_row=1, bot_row=-1)
  for rows in ((1, 11), (-1, 5), (6, 5)):
    with pytest.raises(ValueError, match="outside the frame"):
      th_dm.demosaic_stencil(tp, w, fin, rows=rows)
