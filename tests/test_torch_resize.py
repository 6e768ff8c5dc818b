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
