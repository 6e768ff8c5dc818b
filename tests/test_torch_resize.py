"""The resize: the port's interpolate API, K12's plain twin and the
resize route of ``fused_isp_step``, against the JAX package on the CPU.

Contracts:
  * ``_axis_samples``: bitwise (the same numpy).
  * interpolate API (HWC; u8, u16, f32 in): nearest and exact taps
    bitwise. At inexact taps XLA's CPU compiler contracts each
    ``lo + f * (hi - lo)`` into an FMA, and the port rounds the product
    and the sum apart (as the kernels do, built with --fmad=false): f32
    out within 1 ulp, integer out within 1 count on < 1% of pixels; the
    port is bitwise equal to the same arithmetic in numpy.
  * K12's twin vs JAX ``_resize_from_phases`` (bf16, f16, f32): bitwise
    (XLA keeps the products and sums apart on this route: measured).
  * K12's twin vs the Pallas K12 in interpret mode: bitwise at x0.5; K12's
    own bounds elsewhere (max relative 2.5e-2, mean 4e-3), its bf16
    weights being the approximation.
  * ``fused_isp_step``'s resize route, all three classes, 3 frames with
    the EMA carried over: metrics within 1e-5, u8 within 1 count on < 2%
    of bytes, and in bf16 a rare pixel 2 counts apart (``compare_step``
    says why; the other route tests share it and ``route_vs_jax``).
"""

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
from taichi_image_tpu.ops import interpolate as jin  # noqa: E402
from taichi_image_tpu.ops.pallas import resize as pl_rs  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops import interpolate as tin  # noqa: E402
from taichi_image_tpu_torch.ops.interpolate import ImageTransform  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import resize as th_rs  # noqa: E402

N_CAM, H, WB = 2, 64, 384          # W = 256; phases 32 x 128
W = WB * 2 // 3
FRAMES = 3
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
       torch.float32: jnp.float32}
CLASSES = {"CameraBF16": (jtit.CameraBF16, ttit.CameraBF16),
           "Camera16": (jtit.Camera16, ttit.Camera16),
           "Camera32": (jtit.Camera32, ttit.Camera32)}


def _to_torch(a) -> torch.Tensor:
  a = np.asarray(a)
  if a.dtype == jnp.bfloat16:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
  return torch.from_numpy(a.copy())


def _f32(t: torch.Tensor) -> np.ndarray:
  return t.to(torch.float32).numpy()


def _x12(dtype, seed=0, n=N_CAM, hh=H // 2, wh=W // 2):
  x = np.random.default_rng(seed).random((n, 12, hh, wh), np.float32)
  j = jnp.asarray(x, JDT[dtype])
  return j, _to_torch(j)


def _raws(seed, h=H, wb=WB):
  return np.random.default_rng(seed).integers(0, 256, size=(N_CAM, h, wb),
                                              dtype=np.uint8)


# ------------------------------------------------------------ the API

@pytest.mark.parametrize("n_out,n_in,scale", [
    (32, 64, 0.5), (50, 40, 1.5), (23, 64, 0.37), (1080, 2160, 0.5),
    (1920, 3840, 1920 / 3840), (7, 3, 7 / 3)])
def test_axis_samples_bitwise(n_out, n_in, scale):
  for got, want in zip(tin._axis_samples(n_out, n_in, scale),
                       jin._axis_samples(n_out, n_in, scale)):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _image(dtype, seed=1, h=40, w=60):
  rng = np.random.default_rng(seed)
  if dtype == np.float32:
    return rng.random((h, w, 3), np.float32)
  return rng.integers(0, np.iinfo(dtype).max, (h, w, 3)).astype(dtype)


def _np_bilinear(img, size, scale, out_dtype):
  """The resize in numpy, rounding each product and sum apart."""
  in_dt = np.dtype(img.dtype)
  out_dt = np.dtype(out_dtype or in_dt)
  h, w = img.shape[:2]
  sy, sx = jin._norm_scale_hw(h, w, size, scale)
  r_lo, r_hi, r_f = jin._axis_samples(size[1], h, sy)
  c_lo, c_hi, c_f = jin._axis_samples(size[0], w, sx)
  x = img.astype(np.float32)
  top, bot = x[r_lo], x[r_hi]
  rows = top + r_f[:, None, None] * (bot - top)
  left, right = rows[:, c_lo], rows[:, c_hi]
  out = left + c_f[None, :, None] * (right - left)
  s = jtypes.scale_of(out_dt) / jtypes.scale_of(in_dt)
  out = out * np.float32(s)
  if out_dt.kind in "ui":
    out = np.clip(out, 0, jtypes.scale_of(out_dt))
  return out.astype(out_dt)


# (function, its arguments, the (size, scale) it resizes a 40 x 60 image
# by, exact taps)
API_CASES = [
    ("resize_bilinear", ((30, 20), 0.5), ((30, 20), 0.5), True),
    ("resize_bilinear", ((33, 21),), ((33, 21), None), False),
    ("resize_bilinear", ((90, 50), 1.5), ((90, 50), 1.5), False),
    ("resize_nearest", ((33, 21),), None, True),
    ("resize_nearest", ((90, 60), 1.5), None, True),
    ("resize_width", (25,), ((25, 16), 25 / 60), False),
    ("scale_bilinear", (0.37,), ((22, 14), 0.37), False),
]


@pytest.mark.parametrize("in_dtype", [np.uint8, np.uint16, np.float32],
                         ids=["u8", "u16", "f32"])
@pytest.mark.parametrize("fn,args,plan,exact", API_CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(API_CASES)])
def test_interpolate_api_matches_jax(fn, args, plan, exact, in_dtype):
  img = _image(in_dtype)
  for out_dtype in (None, np.uint8, np.float32):
    want = np.asarray(getattr(jin, fn)(img, *args, dtype=out_dtype))
    got = getattr(tin, fn)(torch.from_numpy(img), *args,
                           dtype=out_dtype).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
      np.testing.assert_array_equal(got, want)
      continue
    np.testing.assert_array_equal(got, _np_bilinear(img, *plan, out_dtype))
    if got.dtype == np.float32:
      np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-7)
    else:
      d = np.abs(got.astype(np.int64) - want.astype(np.int64))
      assert d.max() <= 1 and (d != 0).mean() < 0.01, (d.max(), d.mean())


@pytest.mark.parametrize("t", list(tin.ImageTransform), ids=lambda t: t.value)
def test_api_transform_and_size(t):
  img = _image(np.uint8, h=6, w=10)
  jt = jin.ImageTransform(t.value)
  got = tin.transform(torch.from_numpy(img), t).numpy()
  np.testing.assert_array_equal(got, np.asarray(jin.transform(img, jt)))
  assert tin.transformed_size((10, 6), t) == jin.transformed_size((10, 6), jt)
  assert got.shape[1::-1] == tin.transformed_size((10, 6), t)


# ----------------------------------------------------- K12's plain twin

RESIZES = [((128, 32), 0.5), ((96, 48), None), ((200, 50), None),
           ((128, round(H * 128 / W)), 128 / W),      # resize_width policy
           ((round(W * 0.37), round(H * 0.37)), 0.37)]  # odd h', w'
RESIZE_IDS = ["x0.5", "96x48", "200x50", "width128", "x0.37"]


@pytest.mark.parametrize("dtype", list(JDT), ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("size,scale", RESIZES, ids=RESIZE_IDS)
def test_resize_twin_matches_xla_route(size, scale, dtype):
  j, t = _x12(dtype)
  want = np.asarray(jci._resize_from_phases(j, size, scale, JDT[dtype]),
                    np.float32)
  got = tci._resize_from_phases(t, size, scale, dtype)
  assert got.dtype == dtype
  assert tuple(got.shape) == (N_CAM, 3, size[1], size[0])
  np.testing.assert_array_equal(_f32(got), want)
  # the stage wrapper (the kernel's route on a CUDA tensor) on the CPU
  np.testing.assert_array_equal(
      _f32(tci._resize_x12(t, size, scale, dtype)), want)


@pytest.mark.parametrize("size,scale", RESIZES, ids=RESIZE_IDS)
def test_resize_twin_vs_pallas_k12(size, scale):
  j, t = _x12(torch.bfloat16, seed=3)
  sy, sx = jci._plan_scales(H, W, size, scale)
  want = np.asarray(pl_rs.resize_x12_bf16(j, size, (sy, sx), interpret=True),
                    np.float32)
  got = _f32(tci._resize_x12(t, size, scale, torch.bfloat16))
  assert got.shape == want.shape
  if scale == 0.5:
    np.testing.assert_array_equal(got, want)
  else:
    err = np.abs(got - want) / (np.abs(got) + 1e-3)
    assert err.max() < 2.5e-2 and err.mean() < 4e-3, (err.max(), err.mean())


def test_resize_planar_matches_xla():
  j, t = _x12(torch.float32, seed=4, hh=20, wh=30)
  jp = jnp.asarray(np.asarray(j).reshape(N_CAM, 3, 40, 60))
  tp = t.reshape(N_CAM, 3, 40, 60)
  for size, scale in (((30, 20), 0.5), ((17, 11), None)):
    want = np.asarray(jci._resize_planar(jp, size, scale, jnp.bfloat16),
                      np.float32)
    np.testing.assert_array_equal(
        _f32(tci._resize_planar(tp, size, scale, torch.bfloat16)), want)


def test_resize_taps_cached_and_checked():
  dev = torch.device("cpu")
  a = th_rs.resize_taps(32, 128, (128, 32), (0.5, 0.5), dev)
  assert th_rs.resize_taps(32, 128, (128, 32), (0.5, 0.5), dev) is a
  assert a.r_lo.dtype == torch.int32 and a.r_f.dtype == torch.float32
  with pytest.raises(ValueError, match="taps are for"):
    th_rs.resize_x12(torch.zeros(1, 12, 16, 128), a)


# ------------------------------------------------ K12's launch plan

PLAN_SCALES = [0.25, 0.37, 0.5, "128/W", 1.0, 1.5]
# half-res shapes: rows of whole 16-byte copies in every dtype, and
# ragged ones (150 is 4 mod 8: f32 rows are whole copies, 16-bit not)
PLAN_SHAPES = {"even": (48, 256), "ragged": (19, 150)}


def _plan(hh, wh, scale, device="cpu"):
  """(size, taps) of resizing an (hh, wh) half-res frame by ``scale``
  ("128/W": to 128 wide) as the ISP plans it."""
  if scale == "128/W":
    scale = 128 / (2 * wh)
  size = (max(1, round(2 * wh * scale)), max(1, round(2 * hh * scale)))
  sy_sx = tci._plan_scales(2 * hh, 2 * wh, size, scale)
  return size, scale, th_rs.resize_taps(hh, wh, size, sy_sx,
                                        torch.device(device))


def test_k12_tile_constants_match_the_source():
  """resize.cu is built with resize.py's tile geometry as -D flags, so
  the wrapper's plan and the kernel read it from one place."""
  flags = th_rs.hopper.nvcc_flags("resize.cu")
  assert f"-DTIT_RESIZE_RUNS_X={th_rs.RUNS_X}" in flags
  assert f"-DTIT_RESIZE_TILE_H={th_rs.TILE_H}" in flags
  assert not any("TIT_RESIZE" in f
                 for f in th_rs.hopper.nvcc_flags("demosaic.cu"))
  assert th_rs.tile_w(2) == 256 and th_rs.tile_w(4) == 128


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("scale", PLAN_SCALES, ids=str)
def test_k12_path_cut_over(scale, shape):
  """The aligned path exactly where the taps are the half-res grid and
  x12's rows are whole 16-byte runs from an aligned start; the direct
  path elsewhere, an x12 that starts off a 16-byte boundary included."""
  hh, wh = PLAN_SHAPES[shape]
  _, _, taps = _plan(hh, wh, scale)
  for dtype in JDT:
    x12 = torch.zeros(1, 12, hh, wh, dtype=dtype)
    run = 16 // x12.element_size()
    want = "aligned" if taps.aligned and wh % run == 0 else "direct"
    assert th_rs.plan(x12, taps) == want
    off = torch.zeros(12 * hh * wh + 1, dtype=dtype)[1:].view(1, 12, hh, wh)
    assert th_rs.plan(off, taps) == "direct"


def test_k12_path_cut_over_at_6x4k():
  """The paths at 6 x 4K that resize.cu's header and PERF.md name: x0.5
  (the resize to 1920) aligned, every other scale direct, in every
  dtype."""
  paths = {}
  for scale in (0.25, 0.37, 0.5, 0.75, 0.8, 1.0, 1.5):
    _, _, taps = _plan(1080, 1920, scale)
    paths[scale] = {th_rs.plan(torch.empty(1, 12, 1080, 1920, dtype=dtype),
                               taps) for dtype in JDT}
  assert paths == {0.25: {"direct"}, 0.37: {"direct"}, 0.5: {"aligned"},
                   0.75: {"direct"}, 0.8: {"direct"}, 1.0: {"direct"},
                   1.5: {"direct"}}


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("scale", PLAN_SCALES, ids=str)
def test_k12_aligned_exactly_when_halving(scale, shape):
  """The aligned path's taps: output (i, j) reads half-res (i, j) in all
  four phases, which holds exactly when the resize halves both axes."""
  hh, wh = PLAN_SHAPES[shape]
  size, _, taps = _plan(hh, wh, scale)
  halves = size == (wh, hh)
  assert taps.aligned == (halves and scale in (0.5, "128/W"))
  if taps.aligned:
    i = np.arange(hh)
    np.testing.assert_array_equal(taps.r_lo.numpy(), 2 * i)
    np.testing.assert_array_equal(taps.r_hi.numpy(), 2 * i + 1)


def _emulate_k12(x12: torch.Tensor, taps) -> torch.Tensor:
  """csrc/resize.cu's direct path tile by tile in numpy, in its index
  arithmetic: each run's column taps folded into offsets once, each row's
  taps uniform across it, runs cut at w'; f32 lerps, one rounding to
  x12's dtype."""
  n, _, hh, wh = x12.shape
  plane = hh * wh
  kv = 16 // x12.element_size()  # run length
  tw, th = th_rs.tile_w(x12.element_size()), th_rs.TILE_H
  r_lo, r_hi, r_f = (taps.r_lo.numpy(), taps.r_hi.numpy(), taps.r_f.numpy())
  c_lo, c_hi, c_f = (taps.c_lo.numpy(), taps.c_hi.numpy(), taps.c_f.numpy())
  h_out, w_out = taps.h_out, taps.w_out
  out = np.full((n, 3, h_out, w_out), np.nan, np.float32)
  tiles = [(b, oy0, ox0) for b in range(n) for oy0 in range(0, h_out, th)
           for ox0 in range(0, w_out, tw)]
  for b, oy0, ox0 in tiles:
    src = x12[b].to(torch.float32).numpy().ravel()
    runs = ox0 + np.arange(0, tw, kv)
    ox = (runs[runs < w_out][:, None] + np.arange(kv)).ravel()
    o = np.minimum(ox, w_out - 1)
    lo = (c_lo[o] & 1) * 6 * plane + (c_lo[o] >> 1)
    hi = (c_hi[o] & 1) * 6 * plane + (c_hi[o] >> 1)
    oy = np.arange(oy0, min(oy0 + th, h_out))
    top = ((r_lo[oy] & 1) * 3 * plane + (r_lo[oy] >> 1) * wh)[:, None]
    bot = ((r_hi[oy] & 1) * 3 * plane + (r_hi[oy] >> 1) * wh)[:, None]
    fr, g, keep = r_f[oy][:, None], c_f[o], ox < w_out
    for c in range(3):
      tl, bl = src[c * plane + top + lo], src[c * plane + bot + lo]
      tr, br = src[c * plane + top + hi], src[c * plane + bot + hi]
      with np.errstate(invalid="ignore"):  # inf - inf: NaN, as on the card
        left = tl + fr * (bl - tl)
        right = tr + fr * (br - tr)
        val = left + g * (right - left)
      out[b, c, oy[:, None], ox[keep][None, :]] = val[:, keep]
  return torch.from_numpy(out).to(x12.dtype)


def _emulate_k12_aligned(x12: torch.Tensor, taps) -> torch.Tensor:
  """csrc/resize.cu's aligned path in numpy: color c of output (i, j)
  from half-res (i, j) of channels c, 3 + c, 6 + c, 9 + c."""
  x = x12.to(torch.float32).numpy()
  fr = taps.r_f.numpy()[None, :, None]
  g = taps.c_f.numpy()[None, None, :]
  out = []
  with np.errstate(invalid="ignore"):
    for c in range(3):
      tl, bl, tr, br = (x[:, q * 3 + c] for q in range(4))
      left = tl + fr * (bl - tl)
      right = tr + fr * (br - tr)
      out.append(left + g * (right - left))
  return torch.from_numpy(np.stack(out, 1)).to(x12.dtype)


@pytest.mark.parametrize("dtype", list(JDT), ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_k12_aligned_path_emulation_bitwise(shape, dtype):
  hh, wh = PLAN_SHAPES[shape]
  size, sc, taps = _plan(hh, wh, 0.5)
  assert taps.aligned
  x = np.random.default_rng(8).random((2, 12, hh, wh), np.float32)
  x.ravel()[::97] = -np.inf
  x.ravel()[::131] = np.nan
  j = jnp.asarray(x, JDT[dtype])
  t = _to_torch(j)
  got = _emulate_k12_aligned(t, taps)
  assert _same_bits(got, th_rs.resize_x12_plain(t, taps))
  assert _same_bits(got, _to_torch(jci._resize_from_phases(j, size, sc,
                                                           JDT[dtype])))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
  """Bitwise equal, NaN payloads aside (a NaN tap's NaN in both)."""
  nan = torch.isnan(a)
  return (torch.equal(nan, torch.isnan(b))
          and torch.equal(a[~nan].view(-1), b[~nan].view(-1))
          and torch.equal(torch.signbit(a[~nan]), torch.signbit(b[~nan])))


@pytest.mark.parametrize("dtype", list(JDT), ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("scale", PLAN_SCALES, ids=str)
def test_k12_tiled_gather_emulation_bitwise(scale, shape, dtype):
  """The numpy emulation of K12's tiled gather (the direct path) is
  bitwise the plain twin and JAX's _resize_from_phases, NaN and inf taps
  included (all four taps are read even where a fraction is 0)."""
  hh, wh = PLAN_SHAPES[shape]
  size, sc, taps = _plan(hh, wh, scale)
  x = np.random.default_rng(7).random((1, 12, hh, wh), np.float32)
  x.ravel()[::211] = np.inf
  x.ravel()[::307] = np.nan
  j = jnp.asarray(x, JDT[dtype])
  t = _to_torch(j)
  got = _emulate_k12(t, taps)
  assert not torch.isnan(got).all()
  assert _same_bits(got, th_rs.resize_x12_plain(t, taps))
  want = _to_torch(jci._resize_from_phases(j, size, sc, JDT[dtype]))
  assert _same_bits(got, want)


# --------------------------------------------------- the resize route

def route_vs_jax(cls, frames, plan=None, stride=8,
                 transform=ImageTransform.none, tonemap="reinhard",
                 pattern="GRBG", gamma=1.0, intensity=1.0, light_adapt=1.0,
                 color_adapt=0.0):
  """Run the frames through the port's ``fused_isp_step`` on the CPU and
  through the JAX one, the EMA carried over (t = 0, then 0.9), holding
  each frame to :func:`compare_step`. Returns the port's outputs."""
  wd = CLASSES[cls][1]._work_dtype
  args = (gamma, intensity, light_adapt, color_adapt, "packed12", False)
  tail = (None, plan, stride)
  jstep = jax.jit(lambda r, prev, t: jci.fused_isp_step(
      r, prev, t, *args, JDT[wd], jtit.BayerPattern[pattern], *tail,
      jtit.ImageTransform(transform.value), tonemap))
  m_j, m_t = jnp.zeros(9, jnp.float32), torch.zeros(9)
  outs = []
  for f, raws in enumerate(frames):
    t = 0.0 if f == 0 else 0.9
    m_j, o_j = jstep(jnp.asarray(raws), m_j, jnp.float32(t))
    m_t, o_t = tci.fused_isp_step(torch.from_numpy(raws), m_t, t, *args, wd,
                                  ttit.BayerPattern[pattern], *tail,
                                  transform, tonemap)
    compare_step(m_t, o_t, m_j, o_j, wd)
    outs.append(o_t)
  return outs


def compare_step(m_port, o_port, m_jax, o_jax, wd):
  """Metrics within 1e-5; u8 within 1 count on < 2% of bytes. In bf16 a
  pixel may be 2 counts apart, on < 0.1% of bytes: PyTorch's and XLA's
  CPU log2/exp2 (and XLA's jnp.power) can differ by an f32 ulp, which can
  round p to the neighbouring bf16 value; above 0.5 that is 255/256 of a
  count before the division by a per-image max below 1 (measured: 2 of
  24576 bytes at x0.5)."""
  np.testing.assert_allclose(m_port.numpy(), np.asarray(m_jax), rtol=0,
                             atol=1e-5)
  a = o_port.numpy().astype(np.int64)
  b = np.asarray(o_jax).astype(np.int64)
  assert a.shape == b.shape
  d = np.abs(a - b)
  assert d.max() <= (2 if wd == torch.bfloat16 else 1), d.max()
  assert (d > 1).mean() < 1e-3, (d > 1).mean()
  assert (d != 0).mean() < 0.02, (d != 0).mean()


PLANS = {"x0.5": ((W // 2, H // 2), 0.5),
         "x0.37": ((round(W * 0.37), round(H * 0.37)), 0.37),
         "width160": ((160, round(H * 160 / W)), 160 / W)}


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("plan", PLANS)
def test_resize_route_matches_jax(plan, cls):
  frames = [_raws(100 + f) for f in range(FRAMES)]
  outs = route_vs_jax(cls, frames, plan=PLANS[plan])
  size = PLANS[plan][0]
  assert tuple(outs[0].shape) == (N_CAM, 3, size[1], size[0])


def test_resize_route_vs_pallas_k12_route(monkeypatch):
  """The JAX step with the Pallas resize gate forced open too (interpret
  mode, as tests/test_pallas_resize.py runs it): at x0.5 its K12 is
  bitwise, so the steps agree as with the XLA resize."""
  monkeypatch.setattr(pl_rs, "resize_pallas_available", lambda *a: True)
  monkeypatch.setattr(pl_rs, "resize_x12_bf16",
                      functools.partial(pl_rs.resize_x12_bf16,
                                        interpret=True))
  route_vs_jax("CameraBF16", [_raws(110 + f) for f in range(2)],
               plan=PLANS["x0.5"], pattern="RGGB")


@pytest.mark.parametrize("cls", CLASSES)
def test_load_state_continues_jax_resize_stream(cls):
  """A JAX ISP's state_dict() carried over mid-EMA: the port's resize
  stream goes on as the JAX one does (the resize is configuration, not
  state)."""
  jcls, tcls = CLASSES[cls]
  kw = dict(resize_width=128, transform=jtit.ImageTransform.rotate_90)
  jisp = jcls(jtit.BayerPattern.RGGB, **kw)
  for f in range(2):
    jisp.process(_raws(120 + f))
  tisp = tcls(ttit.BayerPattern.RGGB, resize_width=128,
              transform=ttit.ImageTransform.rotate_90, device="cpu")
  tisp.load_state(ttit.state_from_jax(jisp.state_dict()))
  np.testing.assert_array_equal(tisp.metrics.numpy(),
                                np.asarray(jisp.metrics))
  raws = _raws(122)
  oj, ot = jisp.process(raws), tisp.process(raws)
  assert tuple(ot.shape) == (N_CAM, 3, 128, 32)
  compare_step(tisp.metrics, ot, jisp.metrics, oj, tcls._work_dtype)
