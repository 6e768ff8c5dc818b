"""The slice end to end: the port's ``CameraBF16.process`` against the
JAX package's, 2 cameras x 64 x 1152 raw bytes (W=768), 3 frames with
the EMA carried over. Bounds as tests/test_pallas_reinhard.py:197-201:
metrics within 1e-5, u8 within 1 count on <2% of pixels (2 counts at
gamma 2.2, where the 1/gamma root's slope amplifies the map's ulps)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu import types as jtypes  # noqa: E402
from taichi_image_tpu.models.camera_isp import fused_isp_step  # noqa: E402

N_CAM, H, WB = 2, 64, 1152
FRAMES = 3


def _raws(seed):
  return np.random.default_rng(seed).integers(0, 256, size=(N_CAM, H, WB),
                                              dtype=np.uint8)


def _compare(m_port, o_port, m_jax, o_jax, max_count=1):
  np.testing.assert_allclose(m_port.numpy(), np.asarray(m_jax), rtol=0,
                             atol=1e-5)
  a = o_port.numpy().astype(np.int64)
  b = np.asarray(o_jax).astype(np.int64)
  assert a.shape == b.shape == (N_CAM, 3, H, WB * 2 // 3)
  d = np.abs(a - b)
  assert d.max() <= max_count, d.max()
  assert (d != 0).mean() < 0.02, (d != 0).mean()


@pytest.mark.parametrize("pattern,kw", [
    ("RGGB", {}),
    ("GBRG", {"color_adapt": 0.5}),
    ("BGGR", {"ids_format": True, "intensity": 1.4, "light_adapt": 0.6}),
])
def test_process_matches_jax_xla_route(pattern, kw):
  jisp = jtit.CameraBF16(jtit.BayerPattern[pattern])
  tisp = ttit.CameraBF16(ttit.BayerPattern[pattern], device="cpu")
  for f in range(FRAMES):
    raws = _raws(f)
    oj = jisp.process(raws, **kw)
    ot = tisp.process(raws, **kw)
    _compare(tisp.metrics, ot, jisp.metrics, oj)


def test_process_correct_colors_matches_jax():
  jisp = jtit.CameraBF16(jtit.BayerPattern.RGGB, correct_colors=True)
  tisp = ttit.CameraBF16(ttit.BayerPattern.RGGB, correct_colors=True,
                         device="cpu")
  for f in range(FRAMES):
    raws = _raws(10 + f)
    oj, ot = jisp.process(raws), tisp.process(raws)
    _compare(tisp.metrics, ot, jisp.metrics, oj)


def test_process_gamma_matches_jax():
  jisp = jtit.CameraBF16(jtit.BayerPattern.RGGB)
  tisp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu")
  for f in range(FRAMES):
    raws = _raws(20 + f)
    oj = jisp.process(raws, gamma=2.2)
    ot = tisp.process(raws, gamma=2.2)
    _compare(tisp.metrics, ot, jisp.metrics, oj, max_count=2)


def test_process_matches_jax_pallas_interpret_route(monkeypatch):
  """The JAX step with every bf16 Pallas gate forced open (interpret
  mode), as test_fused_step_bf16_kernel_route_integrated does."""
  from taichi_image_tpu.ops.pallas import decode as pld
  from taichi_image_tpu.ops.pallas import demosaic as pldm
  from taichi_image_tpu.ops.pallas import reinhard as plrh
  monkeypatch.setattr(pld, "decode_pallas_available", lambda h, wb: True)
  monkeypatch.setattr(pld, "decode12_phases_bf16",
                      functools.partial(pld.decode12_phases_bf16,
                                        interpret=True))
  monkeypatch.setattr(pldm, "pallas_available", lambda hh, wh: True)
  monkeypatch.setattr(pldm, "demosaic_stencil",
                      functools.partial(pldm.demosaic_stencil,
                                        interpret=True))
  monkeypatch.setattr(plrh, "reinhard_bf16_available",
                      lambda nc, hh, wh: True)
  monkeypatch.setattr(plrh, "reinhard_map_bf16_dma",
                      functools.partial(plrh.reinhard_map_bf16_dma,
                                        interpret=True))
  # a fresh jit: the process() jit cache may hold the XLA route
  step = jax.jit(lambda r, prev, t: fused_isp_step(
      r, prev, t, 1.0, 1.0, 1.0, 0.0, "packed12", False, jtypes.bf16,
      jtit.BayerPattern.RGGB, None, None, 8, jtit.ImageTransform.none,
      "reinhard"))
  tisp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu")
  m = jnp.zeros(9, jnp.float32)
  for f in range(FRAMES):
    raws = _raws(30 + f)
    m, oj = step(jnp.asarray(raws), m, jnp.float32(0.0 if f == 0 else 0.9))
    ot = tisp.process(raws)
    _compare(tisp.metrics, ot, m, oj)


def test_load_state_continues_jax_stream():
  jisp = jtit.CameraBF16(jtit.BayerPattern.RGGB)
  for f in range(2):
    jisp.process(_raws(40 + f))
  tisp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu")
  tisp.load_state(ttit.state_from_jax(jisp.state_dict()))
  np.testing.assert_array_equal(tisp.metrics.numpy(),
                                np.asarray(jisp.metrics))
  raws = _raws(42)
  oj = jisp.process(raws)
  ot = tisp.process(raws)
  _compare(tisp.metrics, ot, jisp.metrics, oj)
  # and the port's own state round-trips
  state = tisp.state_dict()
  again = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu")
  again.load_state(state)
  np.testing.assert_array_equal(again.metrics.numpy(), state["metrics"])
