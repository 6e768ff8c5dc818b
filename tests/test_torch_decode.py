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


# widths whose column pairs are not a whole number of the kernel's
# 16-pair vectors: the ragged 6x4K-like row and 16k + 5 pairs
_DTYPES = {"bf16": (jtypes.bf16, torch.bfloat16),
           "f16": (jnp.float16, torch.float16),
           "f32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("dt", list(_DTYPES))
@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("wb", [3009, 3 * (16 * 3 + 5)])
def test_decode_ragged_widths_match_xla_route(wb, ids, dt):
  jd, td = _DTYPES[dt]
  raws = _raws((2, 6, wb), None, seed=wb)
  want = np.asarray(load_raw_phases(jnp.asarray(raws), "packed12", jd, ids))
  got = th_decode.decode12_phases(torch.from_numpy(raws), ids, td)
  assert got.dtype == td and tuple(got.shape) == want.shape
  np.testing.assert_array_equal(got.contiguous().view(torch.uint8).numpy(),
                                want.view(np.uint8))


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_decode_refuses_frames_past_32_bit_offsets(backend):
  # 2^16 rows of 3 * 2^15 bytes: a stride-0 view, nothing allocated
  raws = torch.zeros(1, 1, 1, dtype=torch.uint8).expand(1, 2 ** 16,
                                                        3 * 2 ** 15)
  with pytest.raises(ValueError, match="32-bit"):
    th_decode.decode12_phases(raws, False, torch.bfloat16, backend=backend)


@pytest.mark.parametrize("count,ok", [(2 ** 31 - 1, True), (2 ** 31, False),
                                      (12 * 1080 * 1920, True)])
def test_int32_extent_guard(count, ok):
  from taichi_image_tpu_torch.ops import hopper
  if ok:
    hopper.check_int32_extent("x", count)
  else:
    with pytest.raises(ValueError, match="32-bit"):
      hopper.check_int32_extent("x", count)
