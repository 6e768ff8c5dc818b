"""K1 packed12 decode: the port's plain twin against the JAX decode
(the Pallas kernel in interpret mode, and the XLA route). Contract:
bitwise, in the standard and IDS layouts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu import types as jtypes  # noqa: E402
from taichi_image_tpu.models.camera_isp import load_raw_phases  # noqa: E402
from taichi_image_tpu.ops.pallas import decode as pl_decode  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import decode as th_decode  # noqa: E402


def _bits(x):
  """bf16 array (JAX or torch) -> its uint16 bit patterns (numpy)."""
  if isinstance(x, torch.Tensor):
    return x.contiguous().view(torch.int16).numpy().view(np.uint16)
  return np.asarray(x).view(np.uint16)


def _raws(shape, fill, seed=0):
  if fill is None:
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)
  return np.full(shape, fill, np.uint8)


@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("fill", [None, 0x00, 0xFF])
def test_decode_matches_pallas_interpret(ids, fill):
  raws = _raws((2, 32, 1152), fill)  # W=768 -> 1152 bytes (decode.py:57)
  want = pl_decode.decode12_phases_bf16(jnp.asarray(raws), ids,
                                        interpret=True)
  got = th_decode.decode12_phases_plain(torch.from_numpy(raws), ids,
                                        torch.bfloat16)
  assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
  np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("shape", [(3, 38, 150), (2, 64, 1152)])
def test_decode_matches_xla_route(ids, shape):
  raws = _raws(shape, None, seed=shape[1])
  want = load_raw_phases(jnp.asarray(raws), "packed12", jtypes.bf16, ids)
  got = th_decode.decode12_phases(torch.from_numpy(raws), ids,
                                  torch.bfloat16)
  assert tuple(got.shape) == (shape[0], 4, shape[1] // 2, shape[2] // 3)
  np.testing.assert_array_equal(_bits(got), _bits(want))


def test_decode_phase_order():
  # one known pixel pair per row parity: codes land on planes
  # (row % 2) * 2 + col % 2 at [y // 2, j]
  raws = np.zeros((1, 2, 3), np.uint8)
  raws[0, 0] = [0x21, 0x43, 0x65]  # even=0x321, odd=0x654
  raws[0, 1] = [0xFF, 0x0F, 0x00]  # even=0xFFF, odd=0x000
  got = th_decode.decode12_phases_plain(torch.from_numpy(raws), False,
                                        torch.bfloat16)
  codes = np.array([0x321, 0x654, 0xFFF, 0x000], np.float32)
  want = torch.from_numpy(codes * np.float32(1 / 4095)).to(torch.bfloat16)
  np.testing.assert_array_equal(_bits(got[0, :, 0, 0]), _bits(want))
