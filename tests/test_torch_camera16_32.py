"""The Camera16 (f16) and Camera32 (f32) slices end to end: the port's
``process`` against the JAX package's classes, 2 cameras x 64 x 1152 raw
bytes (W=768), 2 frames with the EMA carried over. On the CPU the JAX
Camera16 takes its strict f16 route (tests/test_q16.py:273-278), the
semantics the port implements. Bounds: metrics within 1e-5, u8 within 1
count on <2% of pixels (as tests/test_torch_isp.py).

The port's Camera16 is also held to the TPU's own Camera16 route, the q16
kernels K5 -> K6 -> K11 composed as fused_isp_step wires them
(tests/test_q16.py:198-213, interpret mode), at its smallest tiling
(H, W = 64, 1024): u8 within 1 count, metrics within 5e-3 (the q16
route's own bounds against the strict route, which put no limit on the
share of pixels one count apart: the q16 codes round x12 and p on other
grids than f16, so up to 8% of bytes differ by one count here)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.ops import bayer as jbayer  # noqa: E402
from taichi_image_tpu.ops import packed  # noqa: E402
from taichi_image_tpu.ops.interpolate import ImageTransform  # noqa: E402
from taichi_image_tpu.ops.pallas import decode as pl_decode  # noqa: E402
from taichi_image_tpu.ops.pallas import reinhard as pl_rh  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from conftest import make_test_rgb  # noqa: E402
from oracle import rgb_to_bayer_oracle  # noqa: E402

N_CAM, H, WB = 2, 64, 1152
FRAMES = 2
CLASSES = {"Camera16": (jtit.Camera16, ttit.Camera16),
           "Camera32": (jtit.Camera32, ttit.Camera32)}


def _raws(seed, h=H, wb=WB):
  return np.random.default_rng(seed).integers(0, 256, size=(N_CAM, h, wb),
                                              dtype=np.uint8)


def _compare(m_port, o_port, m_ref, o_ref, metrics_atol=1e-5,
             max_share=0.02):
  np.testing.assert_allclose(m_port.numpy(), np.asarray(m_ref), rtol=0,
                             atol=metrics_atol)
  a = o_port.numpy().astype(np.int64)
  b = np.asarray(o_ref).astype(np.int64)
  assert a.shape == b.shape
  d = np.abs(a - b)
  assert d.max() <= 1, d.max()
  assert (d != 0).mean() < max_share, (d != 0).mean()


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("pattern,kw", [
    ("RGGB", {}),
    ("GBRG", {"color_adapt": 0.5, "gamma": 0.8}),
    ("BGGR", {"ids_format": True, "intensity": 1.4, "light_adapt": 0.6}),
    # above the TPU route's gamma <= 1.5 gate, a limit of its q16 grid
    ("GRBG", {"gamma": 2.2}),
])
def test_process_matches_jax(cls, pattern, kw):
  jcls, tcls = CLASSES[cls]
  jisp = jcls(jtit.BayerPattern[pattern])
  tisp = tcls(ttit.BayerPattern[pattern], device="cpu")
  for f in range(FRAMES):
    raws = _raws(50 + f)
    oj = jisp.process(raws, **kw)
    ot = tisp.process(raws, **kw)
    assert ot.dtype == torch.uint8
    _compare(tisp.metrics, ot, jisp.metrics, oj)


@pytest.mark.parametrize("cls", CLASSES)
def test_process_correct_colors_matches_jax(cls):
  jcls, tcls = CLASSES[cls]
  jisp = jcls(jtit.BayerPattern.RGGB, correct_colors=True)
  tisp = tcls(ttit.BayerPattern.RGGB, correct_colors=True, device="cpu")
  for f in range(FRAMES):
    raws = _raws(60 + f)
    oj, ot = jisp.process(raws), tisp.process(raws)
    _compare(tisp.metrics, ot, jisp.metrics, oj)


@pytest.mark.parametrize("cls", CLASSES)
def test_step_stages_run_in_the_working_dtype(cls):
  """Phases, x12 and p are materialized in the class's dtype; metering
  and the per-image max stay f32."""
  _, tcls = CLASSES[cls]
  wd = tcls._work_dtype
  raws = torch.from_numpy(_raws(70))
  phases = tci.load_raw_phases(raws, "packed12", wd)
  x12, samp = tci.demosaic_phases(phases, ttit.BayerPattern.RGGB,
                                  out_dtype=wd, sample_step=4)
  m = tci.metering_update_ca(samp, torch.zeros(9), 0.0)
  p, mx = tci.reinhard_map_max_ca(x12, m, 1.0, 1.0, 0.0, wd)
  assert phases.dtype == x12.dtype == samp.dtype == p.dtype == wd
  assert m.dtype == mx.dtype == torch.float32


@pytest.mark.parametrize("cls", CLASSES)
def test_load_state_continues_jax_stream(cls):
  jcls, tcls = CLASSES[cls]
  jisp = jcls(jtit.BayerPattern.RGGB)
  for f in range(2):
    jisp.process(_raws(80 + f))
  tisp = tcls(ttit.BayerPattern.RGGB, device="cpu")
  tisp.load_state(ttit.state_from_jax(jisp.state_dict()))
  np.testing.assert_array_equal(tisp.metrics.numpy(),
                                np.asarray(jisp.metrics))
  raws = _raws(82)
  oj, ot = jisp.process(raws), tisp.process(raws)
  _compare(tisp.metrics, ot, jisp.metrics, oj)


# ------------------------------------------------- the q16 route (K5/K6/K11)

def _scene_raws(n=2, h=64, w=1024, seed=0):
  """A natural-ish scene as packed12 (tests/test_q16.py:35-39)."""
  img = make_test_rgb(h, w, seed)
  cfa = rgb_to_bayer_oracle(np.clip(img, 0, 1), "RGGB")
  raw = np.asarray(packed.encode12(cfa, scaled=True))
  return np.stack([np.roll(raw, i, axis=0) for i in range(n)])


def _q16_step(raws, prev, t, gamma, intensity, color_adapt):
  """The TPU's Camera16 route, composed as fused_isp_step wires it
  (tests/test_q16.py:198-213), with the kernels in interpret mode."""
  words = pl_decode.decode12_phases_q16(jnp.asarray(raws), interpret=True)
  x12q, samp = jbayer.demosaic_phases_q16(words, jbayer.BayerPattern.RGGB,
                                          sample_step=4, interpret=True)
  metrics = jci.metering_update_ca(samp, prev, t)
  cast, mx = pl_rh.reinhard_map_q16_dma(x12q, metrics, intensity, 1.0,
                                        color_adapt=color_adapt,
                                        interpret=True)
  out12 = jci.reinhard_gamma_ca(cast, mx, gamma)
  return metrics, jci.planar_from_phases_transformed(out12,
                                                     ImageTransform.none)


@pytest.mark.parametrize("ca", [0.0, 0.3])
@pytest.mark.parametrize("gamma,intensity", [(1.0, 1.0), (0.9, 3.0),
                                             (0.6, 1.0)])
def test_camera16_matches_q16_route(gamma, intensity, ca):
  raws = _scene_raws()
  tisp = ttit.Camera16(ttit.BayerPattern.RGGB, device="cpu",
                       moving_alpha=0.8)
  m_q = jnp.zeros(9, jnp.float32)
  for f in range(FRAMES):
    # frame 1 seeds the EMA (t = 0); frame 2 blends with t = 0.2
    m_q, o_q = _q16_step(raws, m_q, 0.0 if f == 0 else 0.2, gamma,
                         intensity, ca)
    o_t = tisp.process(raws, gamma=gamma, intensity=intensity,
                       color_adapt=ca)
    _compare(tisp.metrics, o_t, m_q, o_q, metrics_atol=5e-3, max_share=0.1)
