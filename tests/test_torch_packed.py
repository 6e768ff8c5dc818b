"""The packed codecs (``ops/packed.py``) against the JAX package's on the
CPU: every codec bitwise, in both 12-bit layouts, scaled and unscaled,
from and to u8, u16, f16, bf16 and f32; the same shapes raise the same
``ValueError``s; ``PackedMono12`` indexing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu.ops import packed as jpk  # noqa: E402
from taichi_image_tpu_torch.ops import packed as tpk  # noqa: E402

LAYOUTS = [False, True]
OUT_DTYPES = {"u8": np.uint8, "u16": np.uint16, "f16": np.float16,
              "bf16": jnp.bfloat16, "f32": np.float32}
_TORCH = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
          np.dtype(np.float16): torch.float16,
          np.dtype(jnp.bfloat16): torch.bfloat16,
          np.dtype(np.float32): torch.float32}


def _bits(x) -> np.ndarray:
  """The bytes of an array or tensor (bf16 through int16)."""
  if isinstance(x, torch.Tensor):
    if x.dtype == torch.bfloat16:
      x = x.view(torch.int16)
    return x.reshape(-1).numpy().view(np.uint8)
  return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _assert_same(got, want):
  want = np.asarray(want)
  assert tuple(got.shape) == want.shape
  assert got.dtype == _TORCH[want.dtype], (got.dtype, want.dtype)
  np.testing.assert_array_equal(_bits(got), _bits(want))


def _codes(shape=(3, 8, 10), seed=0):
  return np.random.default_rng(seed).integers(0, 4096, shape,
                                              dtype=np.uint16)


def _normalised(dtype, shape=(3, 8, 10), seed=1):
  """Values in [0, 1] of ``dtype``'s range, the encoders' scaled input."""
  rng = np.random.default_rng(seed)
  if dtype == np.uint8:
    return rng.integers(0, 256, shape, dtype=np.uint8)
  if dtype == np.uint16:
    return rng.integers(0, 65536, shape, dtype=np.uint16)
  x = rng.random(shape, np.float32)
  x.flat[::7] = 1.0
  x.flat[::11] = 0.0
  return x.astype(dtype)


@pytest.mark.parametrize("ids", LAYOUTS, ids=["std", "ids"])
def test_pairs_bitwise(ids):
  p0, p1 = _codes((50,), 2), _codes((50,), 3)
  want = jpk.encode12_pairs(jnp.asarray(p0), jnp.asarray(p1), ids)
  got = tpk.encode12_pairs(p0, p1, ids, device="cpu")
  for g, w in zip(got, want, strict=True):
    _assert_same(g, w)
  want = jpk.decode12_pairs(*want, ids_format=ids)
  got = tpk.decode12_pairs(*got, ids_format=ids, device="cpu")
  for g, w in zip(got, want, strict=True):
    _assert_same(g, w)


@pytest.mark.parametrize("ids", LAYOUTS, ids=["std", "ids"])
def test_encode12_unscaled_bitwise(ids):
  v = _codes()
  _assert_same(tpk.encode12(v, ids_format=ids, device="cpu"),
               jpk.encode12(v, ids_format=ids))
  # from a tensor, and from floats holding the codes (truncated)
  _assert_same(tpk.encode12(torch.from_numpy(v.astype(np.float32) + 0.75),
                            ids_format=ids),
               jpk.encode12(v.astype(np.float32) + 0.75, ids_format=ids))


@pytest.mark.parametrize("ids", LAYOUTS, ids=["std", "ids"])
@pytest.mark.parametrize("src", ["u8", "u16", "f16", "f32"])
def test_encode12_scaled_bitwise(src, ids):
  v = _normalised(OUT_DTYPES[src])
  _assert_same(tpk.encode12(v, scaled=True, ids_format=ids, device="cpu"),
               jpk.encode12(v, scaled=True, ids_format=ids))


def test_encode12_scaled_bf16_bitwise():
  x = jnp.asarray(_normalised(np.float32), jnp.bfloat16)
  t = torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
      torch.bfloat16)
  _assert_same(tpk.encode12(t, scaled=True), jpk.encode12(x, scaled=True))


@pytest.mark.parametrize("scaled", [False, True], ids=["codes", "scaled"])
@pytest.mark.parametrize("ids", LAYOUTS, ids=["std", "ids"])
@pytest.mark.parametrize("out", list(OUT_DTYPES))
def test_decode12_bitwise(out, ids, scaled):
  packed = np.asarray(jpk.encode12(_codes(), ids_format=ids))
  _assert_same(tpk.decode12(packed, OUT_DTYPES[out], scaled=scaled,
                            ids_format=ids, device="cpu"),
               jpk.decode12(packed, OUT_DTYPES[out], scaled=scaled,
                            ids_format=ids))


@pytest.mark.parametrize("scaled", [False, True], ids=["codes", "scaled"])
@pytest.mark.parametrize("out", list(OUT_DTYPES))
def test_decode16_bitwise(out, scaled):
  b = np.random.default_rng(4).integers(0, 256, (3, 8, 20), dtype=np.uint8)
  _assert_same(tpk.decode16(b, OUT_DTYPES[out], scaled=scaled,
                            device="cpu"),
               jpk.decode16(b, OUT_DTYPES[out], scaled=scaled))


@pytest.mark.parametrize("scaled", [False, True], ids=["codes", "scaled"])
@pytest.mark.parametrize("src", ["u8", "u16", "f16", "f32"])
def test_encode16_bitwise(src, scaled):
  v = (_normalised(OUT_DTYPES[src]) if scaled
       else np.random.default_rng(5).integers(0, 65536, (3, 8, 10),
                                              dtype=np.uint16))
  _assert_same(tpk.encode16(v, scaled=scaled, device="cpu"),
               jpk.encode16(v, scaled=scaled))


def test_roundtrips():
  """The standard layout and packed16 round-trip. The IDS layout does not,
  in the JAX package as here: its encoder puts p0's low nibble in b2's
  high half and its decoder reads it from the low half (the pair tests
  hold the port to both as they are)."""
  v = _codes()
  np.testing.assert_array_equal(
      tpk.decode12(tpk.encode12(v, device="cpu")).numpy(), v)
  w = np.random.default_rng(6).integers(0, 65536, (4, 6), dtype=np.uint16)
  np.testing.assert_array_equal(
      tpk.decode16(tpk.encode16(w, device="cpu")).numpy(), w)


# (function, argument, the message of the ValueError both raise)
ERRORS = [
    ("encode12", np.zeros((2, 5), np.uint16), "even for 12-bit encoding"),
    ("decode12", np.zeros((2, 6), np.uint16), "must be u8"),
    ("decode12", np.zeros((2, 7), np.uint8), "factor of 3"),
    ("decode16", np.zeros((2, 6), np.float32), "must be u8"),
    ("decode16", np.zeros((2, 7), np.uint8), "factor of 2"),
]


@pytest.mark.parametrize("fn,arg,match", ERRORS,
                         ids=[f"{e[0]}-{i}" for i, e in enumerate(ERRORS)])
def test_shape_errors_match_jax(fn, arg, match):
  with pytest.raises(ValueError, match=match) as jerr:
    getattr(jpk, fn)(arg)
  with pytest.raises(ValueError, match=match) as terr:
    getattr(tpk, fn)(arg, device="cpu")
  assert str(terr.value) == str(jerr.value)


def test_packed_mono12_indexing_matches_jax():
  v = _codes((6, 10), 7)
  packed = np.asarray(jpk.encode12(v))
  jm, tm = jpk.PackedMono12(packed), tpk.PackedMono12(packed, device="cpu")
  assert tm.shape == jm.shape == (6, 10)
  rows = np.array([0, 1, 3, 5, 5])
  cols = np.array([0, 3, 9, 4, 5])
  _assert_same(tm[rows, cols], jm[rows, cols])
  _assert_same(tm[2, 7], jm[2, 7])
  assert int(tm[2, 7]) == v[2, 7]
  _assert_same(tm.decode(), jm.decode())
  flat = tpk.PackedMono12(packed.reshape(-1), width=10, device="cpu")
  _assert_same(flat[rows, cols], jm[rows, cols])


@pytest.mark.parametrize("arg,kw,match", [
    (np.zeros(30, np.uint8), {}, "width required"),
    (np.zeros((4, 7), np.uint8), {}, "3k-byte"),
    (np.zeros((4, 6), np.uint16), {}, "must be u8"),
], ids=["flat-no-width", "bad-row", "not-u8"])
def test_packed_mono12_errors_match_jax(arg, kw, match):
  with pytest.raises(ValueError, match=match):
    jpk.PackedMono12(arg, **kw)
  with pytest.raises(ValueError, match=match):
    tpk.PackedMono12(arg, device="cpu", **kw)
