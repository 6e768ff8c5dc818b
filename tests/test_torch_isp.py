"""The slice end to end: the port's ``CameraBF16.process`` against the
JAX package's, 2 cameras x 64 x 1152 raw bytes (W=768), 3 frames with
the EMA carried over. Bounds: the port's bf16 contract
(tests/test_torch_resize.py ``compare_step``): metrics within 1e-5, u8
within 1 count on < 2% of bytes, 2 counts on < 0.1%. A byte 2 counts
apart is a map value the two CPU compilers round to neighbouring bf16
values; XLA's CPU code for the map moves with the host's instruction
set, so which bytes those are does too
(``test_two_count_bytes_are_neighbouring_bf16_roundings``)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu import types as jtypes  # noqa: E402
from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.models.camera_isp import fused_isp_step  # noqa: E402
from taichi_image_tpu.ops import bayer as jbayer  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from test_torch_resize import compare_step  # noqa: E402

N_CAM, H, WB = 2, 64, 1152
FRAMES = 3


def _raws(seed):
  return np.random.default_rng(seed).integers(0, 256, size=(N_CAM, H, WB),
                                              dtype=np.uint8)


def _compare(m_port, o_port, m_jax, o_jax):
  """The port's bf16 contract, test_torch_resize.compare_step: metrics
  within 1e-5, u8 within 1 count on < 2% of bytes, 2 counts on < 0.1%
  (test_two_count_bytes_are_neighbouring_bf16_roundings pins why)."""
  assert tuple(o_port.shape) == (N_CAM, 3, H, WB * 2 // 3)
  compare_step(m_port, o_port, m_jax, o_jax, torch.bfloat16)


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
    _compare(tisp.metrics, ot, jisp.metrics, oj)


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


# the map p of the same x12 on both sides agrees to this many f32 ulps
# (measured: at most 4 with XLA's default, AVX2 and SSE4.2 CPU code)
P_ULPS = 8


def _bits(p: np.ndarray) -> np.ndarray:
  """f32 values as int64 bits (p >= 0: ordered as the values are)."""
  return np.ascontiguousarray(p, np.float32).view(np.int32).astype(np.int64)


def test_two_count_bytes_are_neighbouring_bf16_roundings():
  """The mechanism behind the bf16 2-count bytes, on the case that shows
  one on an AVX-512 host ([BGGR-kw2], frame 1): from the same x12, each
  side's f32 map p is within P_ULPS ulps of the other's, every byte is
  within 2 counts, and each byte 2 counts apart is a pixel where the two
  p round to neighbouring bf16 values (a bf16 step of p is 255/256 of a
  count before the division by a per-image max below 1)."""
  kw = {"ids_format": True, "intensity": 1.4, "light_adapt": 0.6}
  jisp = jtit.CameraBF16(jtit.BayerPattern.BGGR)
  tisp = ttit.CameraBF16(ttit.BayerPattern.BGGR, device="cpu")
  for f in range(2):
    raws = _raws(f)
    oj = np.asarray(jisp.process(raws, **kw)).astype(np.int64)
    ot = tisp.process(raws, **kw).numpy().astype(np.int64)
  wd = torch.bfloat16
  phases = tci.load_raw_phases(torch.from_numpy(raws), "packed12", wd,
                               ids_format=True)
  x12 = tci.demosaic_phases(phases, ttit.BayerPattern.BGGR, cc=None,
                            out_dtype=wd)
  n, _, hh, wh = x12.shape
  p_t = tci.reinhard_map_ca(x12, tisp.metrics, 1.4, 0.6, 0.0).numpy()
  xj = jnp.asarray(x12.view(torch.int16).numpy().view(jnp.bfloat16))
  p_j = np.array(jax.jit(lambda x, m: jci.reinhard_map_ca(
      x.reshape(n, 4, 3, hh, wh), m, 1.4, 0.6, 0.0))(xj, jisp.metrics))
  p_j = p_j.reshape(p_t.shape)
  assert np.abs(_bits(p_t) - _bits(p_j)).max() <= P_ULPS

  def bf16_bits(p):
    """Each pixel's bf16 rounding of p, as int64 bits in the output's
    planar layout."""
    b = torch.from_numpy(p).to(wd).view(torch.int16).numpy()
    return np.asarray(jbayer.phases_to_planar(jnp.asarray(b))).astype(
        np.int64)

  step = np.abs(bf16_bits(p_t) - bf16_bits(p_j))
  d = np.abs(ot - oj)
  assert d.max() <= 2, d.max()
  assert (step[d == 2] == 1).all(), np.argwhere((d == 2) & (step != 1))
