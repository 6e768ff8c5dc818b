"""K7, the front-fused demosaic + Reinhard map: the metering pre-pass
``demosaic_samples``, K7's plain twin and the chain the JAX package's
front-fused route runs (pre-pass -> M -> ``demosaic_reinhard_front`` ->
K4), against the JAX package on the CPU and against ``process``, which
never takes that chain.

Contracts:
  * ``edge_renorm_factor_sampled``: bitwise (the same numpy).
  * ``demosaic_samples``: within one ulp of the working dtype of JAX's
    for bf16 and f16 (its strided convolution sums the taps in another
    order; f32 phases: within 5e-7), and bitwise equal to the port's
    own K2 sample emission (the same arithmetic, in the twin's tap
    order).
  * K7's twin vs the Pallas K7 in interpret mode: p within one bf16 ulp
    (the Pallas kernel's exp2/log2 come from XLA's CPU library, the
    twin's from PyTorch's), two with a CCM (XLA's CPU compiler contracts
    the CCM into FMAs, which moves x12 by a bf16 ulp before the map, as
    tests/test_torch_demosaic.py measures for K2), the per-image max
    within 1e-6 relative. For every tap-mask variant, p with a CCM is
    held to 2**-8 absolute instead: the moved x12 can turn a p of 0 into
    a tiny one, which is many ulps but not more than that.
  * the chain vs the JAX step with its front-fused gate forced open (K7
    in interpret mode, as tests/test_pallas.py runs it): as
    tests/test_torch_resize.py's ``compare_step``; vs ``process``:
    bitwise, metrics and u8 (the samples, x12 rounding and map are the
    same arithmetic).
  * ``TAICHI_IMAGE_TPU_FRONT_FUSED``, the JAX package's opt-in, changes
    nothing in ``process``: the same metrics and bytes as with it unset,
    and K7 never runs.
"""

import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu import types as jtypes  # noqa: E402
from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.ops import bayer as jbayer  # noqa: E402
from taichi_image_tpu.ops.pallas import demosaic as pl_dm  # noqa: E402
from taichi_image_tpu.ops.pallas.reinhard import (  # noqa: E402
    reinhard_scal as j_scal)
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops import bayer as tbayer  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import demosaic as th_dm  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import front_fused as th_ff  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import reinhard as th_rh  # noqa: E402
from test_torch_resize import (  # noqa: E402
    JDT, PLANS, _raws, _to_torch, compare_step)

ENV = "TAICHI_IMAGE_TPU_FRONT_FUSED"
CCM = tuple(np.array([[1.2, -0.1, 0.0], [-0.05, 1.1, -0.05],
                      [0.0, -0.1, 1.3]], np.float32).ravel().tolist())


def _phases(dtype=torch.bfloat16, n=2, hh=32, wh=128, seed=0):
  x = np.random.default_rng(seed).random((n, 4, hh, wh), np.float32)
  j = jnp.asarray(x, JDT[dtype])
  return j, _to_torch(j)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
  it, mag = ((torch.int32, 0x7FFFFFFF) if a.dtype == torch.float32
             else (torch.int16, 0x7FFF))

  def key(t):
    s = t.contiguous().view(it).to(torch.int64)
    return torch.where(s < 0, -(s & mag), s)
  return int((key(a) - key(b)).abs().max())


# ------------------------------------------------- the sample pre-pass

@pytest.mark.parametrize("shape,step", [((32, 128), 4), ((19, 50), 3),
                                        ((8, 12), 1)])
def test_edge_renorm_factor_sampled_bitwise(shape, step):
  w = jbayer._demosaic_tables(jbayer.BayerPattern.RGGB, "mhc")
  got = tbayer.edge_renorm_factor_sampled(w, *shape, step)
  want = np.asarray(jbayer.edge_renorm_factor_sampled(w, *shape, step))
  assert got.dtype == np.float32
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", list(JDT), ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("cc", [None, CCM], ids=["plain", "ccm"])
@pytest.mark.parametrize("pattern,step", [("RGGB", 4), ("GBRG", 3)])
def test_demosaic_samples(pattern, step, cc, dtype):
  j, t = _phases(dtype, hh=19, wh=50, seed=1)
  want = jbayer.demosaic_samples(j, jbayer.BayerPattern[pattern], cc=cc,
                                 out_dtype=JDT[dtype], sample_step=step)
  got = tbayer.demosaic_samples(t, tbayer.BayerPattern[pattern], cc=cc,
                                out_dtype=dtype, sample_step=step)
  assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
  if dtype == torch.float32:
    # f32 phases are not exact sums: the order moves the f32 result
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-7)
  else:
    assert _ulps(got, _to_torch(want)) <= 1
  # the port's own K2 sample emission: the same arithmetic
  _, samp = tbayer.demosaic_phases(t, tbayer.BayerPattern[pattern], cc=cc,
                                   out_dtype=dtype, sample_step=step)
  assert torch.equal(got.view(torch.uint8), samp.view(torch.uint8))


# ----------------------------------------------------------- K7's twin

def _front_inputs(cc, seed=2, hh=64, wh=256):
  j, t = _phases(n=2, hh=hh, wh=wh, seed=seed)
  samp = jbayer.demosaic_samples(j, jbayer.BayerPattern.RGGB, cc=cc,
                                 out_dtype=jnp.bfloat16, sample_step=4)
  metrics = jci.metering_update_ca(samp.astype(jnp.float32),
                                   jnp.zeros(9, jnp.float32),
                                   jnp.float32(0.0))
  return j, t, metrics


@pytest.mark.parametrize("cc", [None, CCM], ids=["plain", "ccm"])
def test_front_fused_twin_vs_pallas_k7(cc):
  j, t, metrics = _front_inputs(cc)
  hh, wh = j.shape[-2:]
  wj = jbayer._demosaic_tables(jbayer.BayerPattern.RGGB, "mhc")
  fin_j = jbayer._stencil_finish_spec(wj, hh, wh, cc, jnp.bfloat16)
  tiles = pl_dm.tiling_for(hh, wh, in_bf16=True, out_bf16=True,
                           extra_f32_tmp=pl_dm._TONEMAP_TMPS)
  p_j, mx_j = pl_dm.demosaic_reinhard_stencil(
      j, wj, *tiles, j_scal(metrics, 1.0, 1.0), fin_j, interpret=True)

  m_t = torch.from_numpy(np.array(metrics))
  p_t, mx_t = tci.demosaic_reinhard_front(t, m_t, 1.0, 1.0,
                                          tbayer.BayerPattern.RGGB, cc)
  assert p_t.dtype == torch.bfloat16 and tuple(p_t.shape) == (2, 12, hh, wh)
  assert _ulps(p_t, _to_torch(p_j)) <= (1 if cc is None else 2)
  np.testing.assert_allclose(mx_t.numpy().ravel(), np.asarray(mx_j).ravel(),
                             rtol=1e-6, atol=0)


def test_front_fused_twin_is_composed_twins():
  _, t, metrics = _front_inputs(CCM, seed=3, hh=19, wh=50)
  hh, wh = t.shape[-2:]
  w = tbayer._demosaic_tables(tbayer.BayerPattern.RGGB, "mhc")
  fin = tbayer._stencil_finish_spec(w, hh, wh, CCM, torch.bfloat16)
  scal = th_rh.reinhard_scal(torch.from_numpy(np.array(metrics)), 1.2, 0.8)
  p, mx = th_ff.front_fused(t, w, fin, scal)
  x12 = tbayer.demosaic_phases(t, tbayer.BayerPattern.RGGB, cc=CCM,
                               out_dtype=torch.bfloat16)
  p_c, mx_c = th_rh.reinhard_map(x12, scal, False)
  assert torch.equal(p.view(torch.int16), p_c.view(torch.int16))
  assert torch.equal(mx, mx_c)


@pytest.mark.parametrize("variant", range(8))
@pytest.mark.parametrize("cc", [None, CCM], ids=["plain", "ccm"])
@pytest.mark.parametrize("hw", [(33, 136), (48, 256)], ids=str)
def test_front_fused_twin_vs_pallas_k7_every_variant(hw, cc, variant):
  """K7's twin, which the card holds K7 to, against the Pallas K7 in
  interpret mode for every tap-mask variant (the kernel's compile-time
  variants), on a ragged frame (the Pallas kernel pads it to its tile
  grid) and on one of whole tiles. Without a CCM, p within one bf16 ulp;
  with one, XLA's contracted CCM moves x12 by a bf16 ulp, which moves p
  by at most a bf16 ulp of 1 (2**-8), a p of 0 against a tiny one
  included, so that case is held to 2**-8 absolute. The per-image max
  within 1e-6 relative."""
  pattern, method = th_dm.VARIANTS[variant]
  hh, wh = hw
  j, t = _phases(n=2, hh=hh, wh=wh, seed=10 + variant)
  wj = jbayer._demosaic_tables(jbayer.BayerPattern[pattern.name], method)
  w = tbayer._demosaic_tables(pattern, method)
  assert th_dm.tap_variant(w) == variant
  samp = jbayer.demosaic_samples(j, jbayer.BayerPattern[pattern.name],
                                 cc=cc, out_dtype=jnp.bfloat16,
                                 sample_step=4)
  metrics = jci.metering_update_ca(samp.astype(jnp.float32),
                                   jnp.zeros(9, jnp.float32),
                                   jnp.float32(0.0))
  fin_j = jbayer._stencil_finish_spec(wj, hh, wh, cc, jnp.bfloat16)
  tiles = pl_dm.tiling_for(hh, wh, in_bf16=True, out_bf16=True,
                           extra_f32_tmp=pl_dm._TONEMAP_TMPS)
  p_j, mx_j = pl_dm.demosaic_reinhard_stencil(
      j, wj, *tiles, j_scal(metrics, 1.0, 1.0), fin_j, interpret=True)

  fin = tbayer._stencil_finish_spec(w, hh, wh, cc, torch.bfloat16)
  scal = th_rh.reinhard_scal(torch.from_numpy(np.array(metrics)), 1.0, 1.0)
  p_t, mx_t = th_ff.front_fused(t, w, fin, scal)
  assert p_t.dtype == torch.bfloat16 and tuple(p_t.shape) == (2, 12, hh, wh)
  if cc is None:
    assert _ulps(p_t, _to_torch(p_j)) <= 1
  else:
    np.testing.assert_allclose(p_t.float().numpy(),
                               np.asarray(p_j, np.float32), rtol=0,
                               atol=2 ** -8)
  np.testing.assert_allclose(mx_t.numpy().ravel(), np.asarray(mx_j).ravel(),
                             rtol=1e-6, atol=0)


# -------------------------------------------- K7's tile, shared with K2

def _stencil_constants() -> dict:
  src = (th_ff.hopper.CSRC / "stencil.cuh").read_text()
  return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                              src).group(1))
          for name in ("kRunsX", "kRowsY", "kTileH")}


def test_k7_and_k2_share_the_stencil_loader():
  """K7 stages its tile, slides its run window and finishes its phases
  through the same stencil.cuh functions as K2, on the same 32 x 8 block
  and 32-row tile; the per-pixel device-memory loader is gone."""
  assert _stencil_constants() == {"kRunsX": 32, "kRowsY": 8, "kTileH": 32}
  header = (th_ff.hopper.CSRC / "stencil.cuh").read_text()
  assert "stencil_taps" not in header
  for source in ("demosaic.cu", "front_fused.cu"):
    src = (th_ff.hopper.CSRC / source).read_text()
    for fn in ("tit::stage_tile<", "tit::load_window<",
               "tit::stencil_run_phase<", "tit::tile_on_edge<"):
      assert fn in src, (source, fn)
  # the per-image max counts the blocks of an image on a 2-D grid
  assert "gridDim.x * gridDim.y, tid)" in (
      th_ff.hopper.CSRC / "front_fused.cu").read_text()


@pytest.mark.parametrize("kv", [2, 4])
@pytest.mark.parametrize("hw", [(64, 300), (70, 256), (33, 129)], ids=str)
def test_interior_tiles_need_no_border_factors(hw, kv):
  """K2 and K7 skip the border and corner factors on tiles that do not
  touch the frame's edge (stencil.cuh tile_on_edge): every factor of every
  channel is exactly 1 on such a tile, and every pixel whose factor is not
  1 lies on an edge tile."""
  hh, wh = hw
  k = _stencil_constants()
  tile_h, tile_w = k["kTileH"], k["kRunsX"] * kv
  w = tbayer._demosaic_tables(tbayer.BayerPattern.GRBG, "mhc")
  fin = tbayer._stencil_finish_spec(w, hh, wh, CCM, torch.bfloat16)
  factor = torch.stack([th_dm._border_factor(oc, hh, wh, fin, "cpu")
                        for oc in range(12)])
  covered = torch.zeros(hh, wh, dtype=torch.bool)
  for y0 in range(0, hh, tile_h):
    for x0 in range(0, wh, tile_w):
      edge = (y0 == 0 or y0 + tile_h >= hh or x0 == 0
              or x0 + tile_w >= wh)
      if edge:
        covered[y0:y0 + tile_h, x0:x0 + tile_w] = True
      else:
        assert (factor[:, y0:y0 + tile_h, x0:x0 + tile_w] == 1.0).all()
  assert covered[(factor != 1.0).any(0)].all()


# ------------------------------------------------------------- the route

def _open_jax_gate(monkeypatch):
  monkeypatch.setattr(pl_dm, "front_fused_available",
                      lambda hh, wh, in_bf16: True)
  monkeypatch.setattr(pl_dm, "demosaic_reinhard_stencil",
                      functools.partial(pl_dm.demosaic_reinhard_stencil,
                                        interpret=True))


def front_fused_step(raws, prev, t, gamma, pattern, cc=None, stride=8,
                     transform=ttit.ImageTransform.none, color_format="rgb",
                     intensity=1.0, light_adapt=1.0):
  """The JAX package's front-fused route on packed12 bf16 raws, chained
  from the port's stages: the metering pre-pass, M, K7 and K4 (or K4's
  I420 mode); ``(new metrics, output)`` as ``fused_isp_step`` returns."""
  wd = torch.bfloat16
  phases = tci.load_raw_phases(raws, "packed12", wd, False)
  mt = tci._meter(tbayer.demosaic_samples(phases, pattern, cc=cc,
                                          out_dtype=wd,
                                          sample_step=max(stride // 2, 1)),
                  prev, t, intensity=intensity, light_adapt=light_adapt)
  p, max_out = tci.demosaic_reinhard_front(phases, mt.metrics, intensity,
                                           light_adapt, pattern, cc,
                                           scal=mt.scal)
  return mt.metrics, tci._finish(p, max_out, gamma, "reinhard", transform,
                                 color_format, "auto")


@pytest.mark.parametrize("kw", [
    {},
    {"gamma": 2.2, "transform": "rotate_90", "cc": CCM},
], ids=["default", "gamma-rot90-ccm"])
def test_front_fused_route_matches_jax(kw, monkeypatch):
  _open_jax_gate(monkeypatch)
  gamma = kw.get("gamma", 1.0)
  cc = kw.get("cc")
  tr = kw.get("transform", "none")
  jstep = jax.jit(lambda r, prev, t: jci.fused_isp_step(
      r, prev, t, gamma, 1.0, 1.0, 0.0, "packed12", False, jtypes.bf16,
      jtit.BayerPattern.RGGB, cc, None, 8, jtit.ImageTransform(tr),
      "reinhard"))
  m_j, m_t = jnp.zeros(9, jnp.float32), torch.zeros(9)
  for f in range(3):
    raws = _raws(300 + f)
    t = 0.0 if f == 0 else 0.9
    m_j, o_j = jstep(jnp.asarray(raws), m_j, jnp.float32(t))
    m_t, o_t = front_fused_step(torch.from_numpy(raws), m_t, t, gamma,
                                ttit.BayerPattern.RGGB, cc,
                                transform=ttit.ImageTransform(tr))
    compare_step(m_t, o_t, m_j, o_j, torch.bfloat16)


def test_front_fused_route_equals_composed_route():
  isp = ttit.CameraBF16(ttit.BayerPattern.BGGR, correct_colors=True,
                        device="cpu")
  for f in range(3):
    raws = _raws(310 + f)
    prev, t = isp._prev_t()
    m_f, o_f = front_fused_step(torch.from_numpy(raws), prev, t, 2.2,
                                isp.bayer_pattern, isp._cc_tuple(),
                                isp.metering_stride, isp.transform,
                                intensity=1.3)
    o_c = isp.process(raws, gamma=2.2, intensity=1.3)
    assert torch.equal(m_f, isp.metrics)
    assert torch.equal(o_f, o_c)


@pytest.mark.parametrize("env,cls,isp_kw,kw", [
    ("1", "CameraBF16", {}, {}),
    ("1", "CameraBF16", {"metering_stride": 4}, {"gamma": 0.8}),
    (None, "CameraBF16", {}, {}),
    ("0", "CameraBF16", {}, {}),
    ("1", "Camera16", {}, {}),
    ("1", "Camera32", {}, {}),
    ("1", "CameraBF16", {"scale": 0.5}, {}),
    ("1", "CameraBF16", {"metering_stride": 7}, {}),
    ("1", "CameraBF16", {}, {"tonemap": "linear"}),
    ("1", "CameraBF16", {}, {"color_adapt": 0.5}),
])
def test_front_fused_gate(env, cls, isp_kw, kw, monkeypatch):
  """The JAX package's opt-in leaves ``process`` as it is: the metrics
  and bytes of the same ISP with the variable unset, and no K7."""
  monkeypatch.setattr(tci, "demosaic_reinhard_front",
                      lambda *a, **k: pytest.fail("process ran K7"))
  raws = _raws(320)
  monkeypatch.delenv(ENV, raising=False)
  unset = getattr(ttit, cls)(ttit.BayerPattern.RGGB, device="cpu", **isp_kw)
  want = unset.process(raws, **kw)
  if env is not None:
    monkeypatch.setenv(ENV, env)
  isp = getattr(ttit, cls)(ttit.BayerPattern.RGGB, device="cpu", **isp_kw)
  out = isp.process(raws, **kw)
  assert torch.equal(isp.metrics, unset.metrics)
  assert torch.equal(out, want)
  if isp_kw.get("scale"):
    assert tuple(out.shape[-2:]) == PLANS["x0.5"][0][::-1]
