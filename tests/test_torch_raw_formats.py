"""The raw formats other than packed12, frames under 4x4 pixels and the
rest of ``ops/bayer.py`` and ``ops/kernel.py``, against the JAX package
on the CPU.

Contracts:
  * ``load_raw_phases`` for packed16, u16, f16 and f32 into bf16, f16 and
    f32: bitwise (the twins of K1's packed16 mode and of the CFA split).
  * A numpy emulation of each new kernel's index map and arithmetic (its
    grid, its vector and element paths, the words it unpacks) is bitwise
    its twin, as the emulations of tests/test_torch_resize.py and
    tests/test_torch_yuv420.py are; the kernels themselves are held to
    the twins on the card by chip_smoke.py.
  * ``process`` for each format and class at 2 x 16 x 64, and on frames
    of 2 x 2, 2 x 6 and 6 x 2 pixels: test_torch_resize.compare_step's
    contract (metrics within 1e-5, u8 within 1 count, a rare 2 in bf16).
  * The f32 demosaic of ``bayer_to_rgb`` and of frames under 4x4 (the
    JAX package's denominator route): within 2^-21 absolute of JAX's,
    2^-20 with a CCM, as tests/test_torch_f16_f32_kernels.py holds the
    f32 stencil (XLA's CPU convolution and CCM einsum sum the cancelling
    taps and terms in their own order and contract FMAs); integer
    outputs of ``bayer_to_rgb`` within 1 count on < 2% of values (the
    truncation of those f32s).
  * The other ``ops/bayer.py`` and ``ops/kernel.py`` helpers: bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.ops import bayer as jbayer  # noqa: E402
from taichi_image_tpu.ops import kernel as jkernel  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops import bayer as tbayer  # noqa: E402
from taichi_image_tpu_torch.ops import kernel as tkernel  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import decode as th_dec  # noqa: E402
from test_torch_resize import CLASSES, JDT, compare_step  # noqa: E402

FORMATS = ["packed16", "u16", "f16", "f32"]
DTYPES = [torch.bfloat16, torch.float16, torch.float32]
_NP = {torch.bfloat16: jnp.bfloat16, torch.float16: np.float16,
       torch.float32: np.float32}
_T = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
      np.dtype(np.float32): torch.float32}
# the f32 demosaic's contract with XLA's convolution, as
# tests/test_torch_f16_f32_kernels.py holds the f32 stencil: 2^-21, and
# 2^-20 with a CCM (XLA sums the cancelling taps and the CCM's terms,
# which reach ~3.2 with the WB gains, in its own order, and contracts
# FMAs)
F32_ATOL = {False: 2.0 ** -21, True: 2.0 ** -20}
CCM = tuple((tci.default_cc * np.array([1.8, 1.0, 2.1])).astype(np.float32)
            .ravel().tolist())


def _raws(fmt, n=2, h=16, w=64, seed=0, wide=False):
  """A raw batch of ``fmt`` for an h x w frame: packed16 bytes, u16 over
  every code (zeros included), or floats (in [0, 1), or with ``wide``
  random signs and exponents, f16 subnormals and past f16's range)."""
  rng = np.random.default_rng(seed)
  if fmt == "packed16":
    return rng.integers(0, 256, (n, h, 2 * w), dtype=np.uint8)
  if fmt == "u16":
    x = rng.integers(0, 65536, (n, h, w), dtype=np.uint16)
    x.flat[::11] = 0
    return x
  if wide:
    x = (rng.standard_normal((n, h, w)) * np.exp2(
        rng.integers(-30, 18, (n, h, w)))).astype(np.float32)
  else:
    x = rng.random((n, h, w), np.float32)
  with np.errstate(over="ignore"):  # past f16's range on purpose
    return x.astype(np.float16 if fmt == "f16" else np.float32)


def _tensor(a: np.ndarray) -> torch.Tensor:
  if a.dtype == np.uint16:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.uint16)
  return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    if x.dtype == torch.bfloat16:
      x = x.view(torch.int16)
    return x.contiguous().numpy().view(np.uint8)
  return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _assert_bitwise(got: torch.Tensor, want):
  want = np.asarray(want)
  assert tuple(got.shape) == want.shape
  np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------------------------------ the decodes

@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_load_raw_phases_bitwise(fmt, dtype):
  raws = _raws(fmt, 3, 6, 20, seed=FORMATS.index(fmt), wide=True)
  want = jci.load_raw_phases(jnp.asarray(raws), fmt, JDT[dtype])
  got = tci.load_raw_phases(_tensor(raws), fmt, dtype)
  assert got.dtype == dtype
  _assert_bitwise(got, want)


@pytest.mark.parametrize("src,fmt", [(np.float16, "f32"),
                                     (np.float32, "f16")])
def test_float_formats_take_either_float(src, fmt):
  """The float formats cast whichever float CFA they are given, as the
  JAX ``cfa_phases(raws).astype(wd)`` does."""
  raws = _raws("f32", 2, 4, 8, seed=9, wide=True).astype(src)
  for dtype in DTYPES:
    _assert_bitwise(tci.load_raw_phases(_tensor(raws), fmt, dtype),
                    jci.load_raw_phases(jnp.asarray(raws), fmt, JDT[dtype]))


def test_formats_refuse_other_dtypes():
  with pytest.raises(ValueError, match="u16 raws must be"):
    tci.load_raw_phases(torch.zeros(1, 4, 4), "u16", torch.float32)
  with pytest.raises(ValueError, match="f32 raws must be"):
    tci.load_raw_phases(torch.zeros(1, 4, 4, dtype=torch.int32), "f32",
                        torch.float32)
  with pytest.raises(ValueError, match="unknown raw format"):
    tci.load_raw_phases(torch.zeros(1, 4, 4), "f64", torch.float32)
  with pytest.raises(ValueError, match="W_bytes % 4"):
    th_dec.decode16_phases(torch.zeros(1, 4, 6, dtype=torch.uint8),
                           torch.float32)


def _round(x32: np.ndarray, dtype) -> np.ndarray:
  """f32 values rounded once to ``dtype`` (nearest even), as bits."""
  with np.errstate(over="ignore"):
    return np.ascontiguousarray(x32.astype(_NP[dtype])).view(np.uint8)


def _emulate(raws: np.ndarray, dtype, fmt: str) -> np.ndarray:
  """The split kernel in numpy, with its packed16 source mode: the
  launcher's choice of path, then per raw row y and thread the kernel's
  pairs, words and stores (csrc/split.cu split_kernel). Returns the
  output's bits."""
  packed = fmt == "packed16"
  if packed:  # packed16 bytes are little-endian u16 pixels
    raws = raws.view("<u2")
  n, h, w = raws.shape
  wh = w // 2
  # whole runs of 4 pairs in every row (the tensors here are aligned)
  pairs_per_thread = 4 if w % 8 == 0 else 1
  out = np.zeros((n, 4, h // 2, wh), np.float32)
  for b in range(n):
    for y in range(h):
      for t0 in range(0, wh, pairs_per_thread):
        for j in range(t0, min(t0 + pairs_per_thread, wh)):
          e, o = raws[b, y, 2 * j], raws[b, y, 2 * j + 1]
          if packed:
            ev = np.float32(e) * np.float32(1 / 65535)
            od = np.float32(o) * np.float32(1 / 65535)
          elif raws.dtype == np.uint16:
            ev = np.float32(e) / np.float32(65535.0)
            od = np.float32(o) / np.float32(65535.0)
          else:
            ev, od = np.float32(e), np.float32(o)
          out[b, 2 * (y & 1), y >> 1, j] = ev
          out[b, 2 * (y & 1) + 1, y >> 1, j] = od
  return _round(out, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("w", [16, 10], ids=["vector", "element"])
def test_kernel_emulation_bitwise_to_twin(w, fmt, dtype):
  """w = 16: every row whole 16-byte runs (the vector path, 4 pairs a
  thread); w = 10: rows that are not (the element path)."""
  raws = _raws(fmt, 2, 4, w, seed=w, wide=True)
  twin = tci.load_raw_phases(_tensor(raws), fmt, dtype)
  np.testing.assert_array_equal(_bits(twin), _emulate(raws, dtype, fmt))


# ------------------------------------------------------ process

def _route(cls, frames, fmt, **kw):
  jcls, tcls = CLASSES[cls]
  jisp = jcls(jtit.BayerPattern.GRBG, **kw)
  tisp = tcls(ttit.BayerPattern.GRBG, device="cpu", **kw)
  for raws in frames:
    oj = jisp.process(raws, fmt=fmt)
    ot = tisp.process(raws, fmt=fmt)
    compare_step(tisp.metrics, ot, jisp.metrics, oj, tcls._work_dtype)
  return ot


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_process_formats_match_jax(fmt, cls):
  frames = [_raws(fmt, 2, 16, 64, seed=20 + f) for f in range(2)]
  out = _route(cls, frames, fmt)
  assert tuple(out.shape) == (2, 3, 16, 64)


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("hw", [(2, 2), (2, 6), (6, 2)],
                         ids=["2x2", "2x6", "6x2"])
def test_small_frames_match_jax(hw, cls):
  h, w = hw
  rng = np.random.default_rng(h * 10 + w)
  frames = [rng.integers(0, 256, (2, h, w * 3 // 2), dtype=np.uint8)
            for _ in range(2)]
  out = _route(cls, frames, "packed12", correct_colors=True)
  assert tuple(out.shape) == (2, 3, h, w)


@pytest.mark.parametrize("fmt", ["u16", "f32"])
def test_small_frames_formats_match_jax(fmt):
  frames = [_raws(fmt, 2, 2, 4, seed=30 + f) for f in range(2)]
  _route("Camera32", frames, fmt, resize_width=2)


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
@pytest.mark.parametrize("method", ["mhc", "bilinear"])
@pytest.mark.parametrize("pattern", ["RGGB", "GRBG", "GBRG", "BGGR"])
@pytest.mark.parametrize("hw", [(1, 1), (1, 3), (3, 1)],
                         ids=["1x1", "1x3", "3x1"])
def test_denominator_demosaic_matches_jax(hw, pattern, method, cc):
  x = np.random.default_rng(sum(hw)).random((2, 4, *hw), np.float32)
  want = np.asarray(jbayer.demosaic_phases(
      jnp.asarray(x), jbayer.BayerPattern[pattern], cc=cc, method=method,
      out_dtype=jnp.float32, backend="xla"))
  got, samp = tbayer.demosaic_phases(torch.from_numpy(x),
                                     tbayer.BayerPattern[pattern], cc=cc,
                                     method=method, sample_step=2)
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=F32_ATOL[cc is not None])
  assert torch.equal(samp, got[:, 0:3, ::2, ::2])


# ------------------------------------------------------ ops/bayer helpers

def test_cfa_phases_bitwise():
  for fmt in ("u16", "f32"):
    raws = _raws(fmt, 2, 6, 8, seed=40)
    _assert_bitwise(tbayer.cfa_phases(_tensor(raws)),
                    jbayer.cfa_phases(jnp.asarray(raws)))


def test_scale_kernel_matches_jax():
  k = jbayer.bayer_kernels[1]
  assert tbayer.scale_kernel(k, (1.8, 1.0, 2.1)) == jbayer.scale_kernel(
      k, (1.8, 1.0, 2.1))


@pytest.mark.parametrize("top,bot", [(True, True), (False, True),
                                     (True, False), (False, False)])
@pytest.mark.parametrize("hw", [(5, 7), (2, 2), (3, 2)],
                         ids=["5x7", "2x2", "3x2"])
def test_edge_renorm_factor_bitwise(hw, top, bot):
  w = jbayer._demosaic_tables(jbayer.BayerPattern.GBRG, "mhc")
  want = jbayer.edge_renorm_factor(w, *hw, is_top=top, is_bot=bot)
  got = tbayer.edge_renorm_factor(
      tbayer._demosaic_tables(tbayer.BayerPattern.GBRG, "mhc"), *hw,
      is_top=top, is_bot=bot)
  _assert_bitwise(got, np.broadcast_to(np.asarray(want), got.shape))


def test_interleaves_bitwise():
  x12 = np.random.default_rng(41).random((2, 12, 3, 5), np.float32)
  x4 = x12[:, :4]
  _assert_bitwise(tbayer.phases_to_plane(torch.from_numpy(x4)),
                  jbayer.phases_to_plane(jnp.asarray(x4)))
  stack = tbayer.phases_to_planar_stack(torch.from_numpy(x12))
  _assert_bitwise(stack, jbayer.phases_to_planar_stack(jnp.asarray(x12)))
  assert torch.equal(stack, tbayer.phases_to_planar(torch.from_numpy(x12)))
  planar = np.asarray(jbayer.phases_to_planar(jnp.asarray(x12)))
  _assert_bitwise(tbayer.planar_to_phases(torch.from_numpy(planar.copy())),
                  jbayer.planar_to_phases(jnp.asarray(planar)))


def _cfa(dtype, h=12, w=16, seed=42):
  rng = np.random.default_rng(seed)
  if dtype == np.float32:
    return rng.random((h, w), np.float32)
  return rng.integers(0, np.iinfo(dtype).max, (h, w)).astype(dtype)


def _assert_demosaic_contract(got, want, ccm=False):
  """The f32 demosaic within F32_ATOL of JAX's; an integer output (its
  truncation) within 1 count on < 2% of values."""
  want = np.asarray(want)
  assert tuple(got.shape) == want.shape and got.dtype == _T[want.dtype]
  if want.dtype == np.float32:
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_ATOL[ccm])
  else:
    d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d != 0).mean() < 0.02, (d.max(),
                                                      (d != 0).mean())


@pytest.mark.parametrize("cc", [None, CCM], ids=["nocc", "ccm"])
@pytest.mark.parametrize("method", ["mhc", "bilinear"])
@pytest.mark.parametrize("src,out", [
    (np.uint8, None), (np.uint16, None), (np.float32, None),
    (np.uint16, np.float32), (np.float32, np.uint8)],
    ids=["u8", "u16", "f32", "u16-f32", "f32-u8"])
def test_bayer_to_rgb_matches_jax(src, out, method, cc):
  img = _cfa(src)
  pat = "BGGR"
  want = np.asarray(jbayer.bayer_to_rgb(
      img, jbayer.BayerPattern[pat],
      None if cc is None else np.array(cc).reshape(3, 3), out, method))
  got = tbayer.bayer_to_rgb(
      _tensor(img), tbayer.BayerPattern[pat],
      None if cc is None else np.array(cc).reshape(3, 3), out, method)
  assert got.shape == want.shape == (12, 16, 3)
  _assert_demosaic_contract(got, want, cc is not None)


def test_bayer_to_rgb_batch_and_errors_match_jax():
  imgs = np.stack([_cfa(np.uint16, seed=s) for s in range(3)])
  _assert_demosaic_contract(tbayer.bayer_to_rgb_batch(_tensor(imgs)),
                            jbayer.bayer_to_rgb_batch(imgs))
  for bad, match in ((np.zeros((4, 4, 1), np.uint8), "mono bayer"),
                     (np.zeros((4, 5), np.uint8), "even size")):
    with pytest.raises(ValueError, match=match):
      jbayer.bayer_to_rgb(bad)
    with pytest.raises(ValueError, match=match):
      tbayer.bayer_to_rgb(bad, device="cpu")
  with pytest.raises(ValueError, match="batch of mono"):
    tbayer.bayer_to_rgb_batch(np.zeros((4, 4), np.uint8), device="cpu")


@pytest.mark.parametrize("pattern", ["RGGB", "GRBG", "GBRG", "BGGR"])
def test_rgb_to_bayer_bitwise(pattern):
  img = np.random.default_rng(43).random((6, 8, 3), np.float32)
  _assert_bitwise(tbayer.rgb_to_bayer(img, tbayer.BayerPattern[pattern],
                                      device="cpu"),
                  jbayer.rgb_to_bayer(img, jbayer.BayerPattern[pattern]))
  with pytest.raises(ValueError, match="RGB"):
    tbayer.rgb_to_bayer(np.zeros((4, 4)), device="cpu")


# ------------------------------------------------------ ops/kernel

def test_kernel_tables_match_jax():
  w = list(range(25))
  assert tkernel.kernel_square(w) == jkernel.kernel_square(w)
  taps = jkernel.kernel_square([1, 2, 1, 2, 4, 2, 1, 2, 1], 3)
  np.testing.assert_array_equal(tkernel.taps_to_dense(taps, 1),
                                jkernel.taps_to_dense(taps, 1))
  np.testing.assert_array_equal(tkernel.taps_to_dense(taps, 2),
                                jkernel.taps_to_dense(taps, 2))


@pytest.mark.parametrize("taps", [
    jkernel.kernel_square([1, 2, 1, 2, 4, 2, 1, 2, 1], 3),
    jkernel.kernel_square([0.5] * 25, 5),
    (((0, 2), 3.0), ((-1, 0), -1.0), ((1, -1), 2.0))],
    ids=["gauss3", "box5", "sparse"])
def test_conv_bitwise(taps):
  img = np.random.default_rng(44).integers(0, 256, (9, 11, 3),
                                           dtype=np.uint8)
  _assert_bitwise(tkernel.conv(img, taps, device="cpu"),
                  jkernel.conv(img, taps))
