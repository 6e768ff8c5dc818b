"""I420 output: the port's two I420 conversions (``ops/hopper/yuv420.py``),
K4's I420 mode's twin (``ops/hopper/finish.py`` ``finish_yuv420``) and
``fused_isp_step``/``process`` with ``color_format="yuv420"``, against the
JAX package on the CPU.

Contracts:
  * ``_yuv420_w6``: bitwise.
  * the phase formulations (the bf16 dot and the f32 chains) and the
    planar conversion, on the same u8: within 1 count of JAX (XLA may sum
    the dot or the block mean in another order, or divide by 255 as a
    multiplication by its reciprocal: an f32 ulp that can cross a
    truncation boundary).
  * a numpy emulation of each kernel, thread by thread's arithmetic and
    addresses (the input phase each output parity reads, the store
    addresses under the 8 transforms, the summation orders, the table of
    k / 255): bitwise equal to the kernel's twin.
  * routes (three classes; the phase route, rotate_90, flip_vert,
    resize_width, stride 7, linear) and the front-fused chain (pre-pass, M,
    K7, K4's I420 mode) vs JAX's front-fused route: metrics within 1e-5, Y
    and VU each as tests/test_torch_resize.py's ``compare_step`` (within 1
    count on < 2% of bytes, a rare 2 in bf16, for the reason it states).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.ops import color as jcolor  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops.bayer import _TRANSFORM_SFF  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import finish as th_fin  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import yuv420 as th_yuv  # noqa: E402
from taichi_image_tpu_torch.ops.interpolate import ImageTransform  # noqa: E402
from test_torch_front_fused import (  # noqa: E402
    _open_jax_gate, front_fused_step)
from test_torch_resize import (  # noqa: E402
    CLASSES, JDT, _raws as _raws_64x256, _to_torch, compare_step)

TRANSFORMS = list(ImageTransform)
T_IDS = [t.value for t in TRANSFORMS]
N_CAM, H, WB = 2, 32, 192          # W = 128; phases 16 x 64
W = WB * 2 // 3
INV255 = np.arange(256, dtype=np.float32) / np.float32(255)


def _raws(seed, h=H, wb=WB):
  return np.random.default_rng(seed).integers(0, 256, size=(N_CAM, h, wb),
                                              dtype=np.uint8)


def _u8(seed, shape):
  return np.random.default_rng(seed).integers(0, 256, size=shape,
                                              dtype=np.uint8)


def _within_one(got, want):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
  d = np.abs(got.astype(np.int64) - want.astype(np.int64))
  assert d.max() <= 1, d.max()
  return d


# ------------------------------------------------------ the conversions

def test_w6_bitwise():
  np.testing.assert_array_equal(tci._yuv420_w6(), jci._yuv420_w6())


@pytest.mark.parametrize("mxu", [False, True], ids=["chains", "dot"])
def test_phase_formulations_match_jax(mxu):
  u8 = _u8(1, (2, 12, 10, 14))
  yt, vut = tci.yuv420_from_phases_u8(torch.from_numpy(u8), mxu=mxu)
  yj, vuj = jci.yuv420_from_phases_u8(jnp.asarray(u8), mxu=mxu)
  assert tuple(yt.shape) == (2, 20, 28) and tuple(vut.shape) == (2, 2, 10, 14)
  _within_one(yt.numpy(), yj)
  _within_one(vut.numpy(), vuj)
  if mxu:
    yd, vud = tci._yuv420_phases_dot_bf16(torch.from_numpy(u8))
    assert torch.equal(yd, yt) and torch.equal(vud, vut)
    yj, vuj = jci._yuv420_phases_dot_bf16(jnp.asarray(u8))
    _within_one(yd.numpy(), yj)
    _within_one(vud.numpy(), vuj)


def test_dot_within_one_count_of_the_chains():
  """JAX's own statement: the bf16 dot is <= 1 count from the f32
  chains; the port's two formulations keep it."""
  u8 = torch.from_numpy(_u8(2, (2, 12, 16, 16)))
  for a, b in zip(tci.yuv420_from_phases_u8(u8, mxu=True),
                  tci.yuv420_from_phases_u8(u8, mxu=False)):
    _within_one(a.numpy(), b.numpy())


@pytest.mark.parametrize("hw", [(20, 28), (6, 34)])
def test_planar_conversion_matches_jax(hw):
  rgb = _u8(3, (2, 3, *hw))
  yt, vut = tci.yuv420_from_planar_u8(torch.from_numpy(rgb))
  yj, vuj = jci.yuv420_from_planar_u8(jnp.asarray(rgb))
  _within_one(yt.numpy(), yj)
  _within_one(vut.numpy(), vuj)


def test_planar_matrix_before_the_mean():
  """The planar route takes the block mean of the converted chroma, the
  phase route converts the mean of the RGB: the two are each JAX's, and
  can differ by a count on the same pixels."""
  u8 = _u8(4, (2, 12, 8, 8))
  t = torch.from_numpy(u8)
  planar = tci.planar_from_phases_transformed(t, ImageTransform.none)
  _, vu_p = tci.yuv420_from_planar_u8(planar)
  _, vu_c = tci.yuv420_from_phases_u8(t, mxu=False)
  _within_one(vu_p.numpy(), vu_c.numpy())
  _, vuj = jci.yuv420_from_planar_u8(jnp.asarray(planar.numpy()))
  _within_one(vu_p.numpy(), vuj)


@pytest.mark.parametrize("hw", [(3, 4), (4, 6, 5)])
def test_planar_wrapper_refuses_bad_input(hw):
  if len(hw) == 2:
    with pytest.raises(ValueError, match="even output dims"):
      th_yuv.yuv420_planar(torch.zeros(1, 3, *hw, dtype=torch.uint8))
  else:
    with pytest.raises(ValueError, match=r"\(N, 3, H, W\)"):
      th_yuv.yuv420_planar(torch.zeros(1, *hw, dtype=torch.uint8))
  with pytest.raises(ValueError, match="uint8"):
    th_yuv.yuv420_planar(torch.zeros(1, 3, 4, 4))


def test_kernel_backend_on_cpu_raises():
  with pytest.raises(ValueError, match="CUDA"):
    th_yuv.yuv420_planar(torch.zeros(1, 3, 4, 4, dtype=torch.uint8),
                         backend="kernel")
  with pytest.raises(ValueError, match="CUDA"):
    th_fin.finish_yuv420(torch.zeros(1, 12, 2, 2), torch.ones(1, 1, 1, 1),
                         1.0, backend="kernel")


# ------------------------------------------- K4's I420 mode, its twin

def _x12(dtype, n=2, hh=5, wh=11, seed=0, hi=1.2):
  x = np.random.default_rng(seed).random((n, 12, hh, wh), np.float32) * hi
  x.ravel()[::17] = 0.0
  j = jnp.asarray(x, JDT[dtype])
  return j, _to_torch(j)


def _scal(mode, n=2):
  if mode == "reinhard":
    return np.asarray([1.13, 0.97, 1.05][:n], np.float32).reshape(n, 1, 1, 1)
  return np.asarray([0.1, 1.0 / 1.1], np.float32)


DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


@pytest.mark.parametrize("t", TRANSFORMS, ids=T_IDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_finish_yuv420_twin_matches_jax(dtype, t):
  """The twin against JAX's phase-route tail: reinhard_gamma_ca (or
  linear_apply_ca), _transform_phases, yuv420_from_phases_u8 with the
  dot for bf16."""
  wd = DTYPES[dtype]
  j, x = _x12(wd)
  jt = jtit.ImageTransform(t.value)
  metrics = np.zeros(9, np.float32)
  metrics[:2] = (0.1, 1.2)
  for mode in ("reinhard", "linear"):
    for gamma in (1.0, 2.2):
      if mode == "reinhard":
        scal = _scal(mode)
        u8 = jci.reinhard_gamma_ca(j, jnp.asarray(scal), gamma)
      else:
        scal = th_fin.linear_scal(torch.from_numpy(metrics)).numpy()
        u8 = jci.linear_apply_ca(j, jnp.asarray(metrics), gamma)
      yj, vuj = jci.yuv420_from_phases_u8(jci._transform_phases(u8, jt),
                                          mxu=wd == torch.bfloat16)
      yt, vut = th_fin.finish_yuv420(x, torch.from_numpy(scal), gamma, mode,
                                     t)
      _within_one(yt.numpy(), yj)
      _within_one(vut.numpy(), vuj)


def _u8_of(v):
  """trunc(clip(min(1, v) * 255, 0, 255)) in f32."""
  return np.clip(np.minimum(v, np.float32(1)) * np.float32(255),
                 np.float32(0), np.float32(255)).astype(np.uint8)


def _emulate_finish_yuv420(x12, scal, gamma, mode, t):
  """csrc/finish.cu's I420 mode in numpy: the u8 of K4's tone (held
  bitwise to K4 by tests/test_torch_finish.py), then, as each thread does
  it, the output phases pp in order with the input phase each reads, the
  rows of ``coefficients``, the sums in the kernel's order, and the
  kernel's store addresses."""
  u8 = th_fin._tone_u8(x12, scal, gamma, mode).numpy()
  n, _, hh, wh = u8.shape
  swap, fy, fx = _TRANSFORM_SFF[t]
  dot = x12.dtype == torch.bfloat16
  c = th_yuv.coefficients(dot)
  cy, cu, cv = c[0:3], c[3:6], c[6:9]
  oy, ou, ov = c[9], c[10], c[11]
  bh, bw = (wh, hh) if swap else (hh, wh)
  y_img = np.full((n, 2 * bh, 2 * bw), 7, np.uint8)
  vu_img = np.full((n, 2, bh, bw), 7, np.uint8)
  i = np.arange(hh)[:, None] + np.zeros((1, wh), int)
  j = np.arange(wh)[None, :] + np.zeros((hh, 1), int)
  ib = hh - 1 - i if fy else i
  jb = wh - 1 - j if fx else j
  io, jo = (jb, ib) if swap else (ib, jb)  # the output block of (i, j)
  acc = [None, None, None]
  for pp in range(4):
    opr, opc = pp & 1, pp >> 1
    ipr = (opc if swap else opr) ^ int(fy)
    ipc = (opr if swap else opc) ^ int(fx)
    q = [u8[:, ipc * 6 + ipr * 3 + k] for k in range(3)]
    if dot:
      r, g, b = (v.astype(np.float32) for v in q)
      s = (r * cy[0] + g * cy[1]) + b * cy[2]
      yv = s / np.float32(255) + oy
      for a, w in ((0, cv), (1, cu)):
        t0 = r * w[0]
        acc[a] = t0 if pp == 0 else acc[a] + t0
        acc[a] = acc[a] + g * w[1]
        acc[a] = acc[a] + b * w[2]
    else:
      xb, xg, xr = INV255[q[2]], INV255[q[1]], INV255[q[0]]
      yv = ((cy[0] * xb + cy[1] * xg) + cy[2] * xr) + oy
      for a, v in enumerate((xb, xg, xr)):
        acc[a] = v if pp == 0 else acc[a] + v
    y_img[:, 2 * io + opr, 2 * jo + opc] = _u8_of(yv)
  if dot:
    v = acc[0] / np.float32(255) + ov
    u = acc[1] / np.float32(255) + ou
  else:
    mb, mg, mr = (a * np.float32(0.25) for a in acc)
    v = ((cv[0] * mb + cv[1] * mg) + cv[2] * mr) + ov
    u = ((cu[0] * mb + cu[1] * mg) + cu[2] * mr) + ou
  vu_img[:, 0, io, jo] = _u8_of(v)
  vu_img[:, 1, io, jo] = _u8_of(u)
  return y_img, vu_img


@pytest.mark.parametrize("t", TRANSFORMS, ids=T_IDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_finish_yuv420_emulation_bitwise(dtype, t):
  wd = DTYPES[dtype]
  for hh, wh in ((5, 11), (4, 16)):
    _, x = _x12(wd, hh=hh, wh=wh, seed=hh, hi=1.6)
    for mode in ("reinhard", "linear"):
      scal = torch.from_numpy(_scal(mode))
      for gamma in (1.0, 2.2):
        ye, vue = _emulate_finish_yuv420(x, scal, gamma, mode, t)
        yt, vut = th_fin.finish_yuv420_plain(x, scal, gamma, mode, t)
        np.testing.assert_array_equal(yt.numpy(), ye)
        np.testing.assert_array_equal(vut.numpy(), vue)


def _emulate_planar(rgb):
  """csrc/yuv420.cu in numpy: x from the table of k / 255, each row of
  ``coefficients`` per pixel, the block sums ((tl + tr) + bl) + br."""
  c = th_yuv.coefficients(False)
  x = INV255[rgb]
  b, g, r = x[:, 2], x[:, 1], x[:, 0]

  def row(m, off):
    return ((m[0] * b + m[1] * g) + m[2] * r) + off

  def block(p):
    s = p[:, 0::2, 0::2] + p[:, 0::2, 1::2]
    s = s + p[:, 1::2, 0::2]
    return (s + p[:, 1::2, 1::2]) * np.float32(0.25)

  vu = np.stack([_u8_of(block(row(c[6:9], c[11]))),
                 _u8_of(block(row(c[3:6], c[10])))], axis=1)
  return _u8_of(row(c[0:3], c[9])), vu


@pytest.mark.parametrize("hw", [(6, 34), (20, 32), (2, 2)])
def test_planar_emulation_bitwise(hw):
  rgb = _u8(5, (2, 3, *hw))
  rgb.ravel()[::13] = 255
  rgb.ravel()[::11] = 0
  ye, vue = _emulate_planar(rgb)
  yt, vut = th_yuv.yuv420_planar_plain(torch.from_numpy(rgb))
  np.testing.assert_array_equal(yt.numpy(), ye)
  np.testing.assert_array_equal(vut.numpy(), vue)


# ---------------------------------- the planar I420 tonemap form's twin

def _planar(dtype, seed, h=12, w=22, hi=1.2):
  """Planar (2, 3, h, w) of ``dtype`` (JAX, torch) with zeros, and metrics
  of it (the port's metering, which the route tests hold to JAX's)."""
  x = np.random.default_rng(seed).random((2, 3, h, w), np.float32) * hi
  x.ravel()[::13] = 0.0
  j = jnp.asarray(x, JDT[dtype])
  t = _to_torch(j)
  m = tci.metering_update_ca(t, torch.zeros(9), 0.0)
  return j, t, m


@pytest.mark.parametrize("t", TRANSFORMS, ids=T_IDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_planar_tone_twin_matches_jax(dtype, t):
  """The tonemap form's twin (after the port's map for Reinhard) against
  JAX's resize-route tail: reinhard_apply_ca or linear_apply_ca,
  _transform_planar, yuv420_from_planar_u8."""
  wd = DTYPES[dtype]
  j, x, m = _planar(wd, 40)
  jt = jtit.ImageTransform(t.value)
  mj = jnp.asarray(m.numpy())
  for mode in ("reinhard", "linear"):
    for gamma in (1.0, 2.2):
      if mode == "reinhard":
        u8 = jci.reinhard_apply_ca(j, mj, gamma, 1.0, 1.0, 0.0, JDT[wd])
        src, scal = tci.reinhard_map_max_ca(x, m, 1.0, 1.0, 0.0, wd)
      else:
        u8 = jci.linear_apply_ca(j, mj, gamma)
        src, scal = x, th_fin.linear_scal(m)
      yj, vuj = jci.yuv420_from_planar_u8(jci._transform_planar(u8, jt))
      yt, vut = th_yuv.yuv420_planar_tone(src, scal, gamma, mode, t)
      _within_one(yt.numpy(), yj)
      _within_one(vut.numpy(), vuj)


def _emulate_planar_tone(x, scal, gamma, mode, t):
  """csrc/finish.cuh's kPlanar tile in numpy: K4's tone (held bitwise to
  K4 by tests/test_torch_finish.py) of the untransformed image; for each
  input 2x2 block, the output block (io, jo) the transform puts it on and,
  for each output pixel tl, tr, bl, br in that order, the input parity the
  kernel reads; per pixel the rows of ``coefficients`` on x from the table
  of k / 255, the block's U and V summed ((tl + tr) + bl) + br."""
  u8 = th_fin._tone_u8(x, scal, gamma, mode).numpy()
  n, _, h, w = u8.shape
  hh, wh = h // 2, w // 2
  swap, fy, fx = _TRANSFORM_SFF[t]
  c = th_yuv.coefficients(False)
  bh, bw = (wh, hh) if swap else (hh, wh)
  y_img = np.full((n, 2 * bh, 2 * bw), 7, np.uint8)
  vu_img = np.full((n, 2, bh, bw), 7, np.uint8)
  i = np.arange(hh)[:, None] + np.zeros((1, wh), int)
  j = np.arange(wh)[None, :] + np.zeros((hh, 1), int)
  ib = hh - 1 - i if fy else i
  jb = wh - 1 - j if fx else j
  io, jo = (jb, ib) if swap else (ib, jb)

  def row(m, off, xb, xg, xr):
    return ((m[0] * xb + m[1] * xg) + m[2] * xr) + off

  sv = su = None
  for pp in range(4):
    opr, opc = pp >> 1, pp & 1
    ipr = (opc if swap else opr) ^ int(fy)
    ipc = (opr if swap else opc) ^ int(fx)
    xr, xg, xb = (INV255[u8[:, k, 2 * i + ipr, 2 * j + ipc]]
                  for k in range(3))
    y_img[:, 2 * io + opr, 2 * jo + opc] = _u8_of(row(c[0:3], c[9], xb, xg,
                                                      xr))
    v = row(c[6:9], c[11], xb, xg, xr)
    u = row(c[3:6], c[10], xb, xg, xr)
    sv = v if pp == 0 else sv + v
    su = u if pp == 0 else su + u
  vu_img[:, 0, io, jo] = _u8_of(sv * np.float32(0.25))
  vu_img[:, 1, io, jo] = _u8_of(su * np.float32(0.25))
  return y_img, vu_img


@pytest.mark.parametrize("t", TRANSFORMS, ids=T_IDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_planar_tone_emulation_bitwise(dtype, t):
  wd = DTYPES[dtype]
  for h, w in ((10, 22), (8, 32)):  # odd and even block counts
    _, x, m = _planar(wd, h, h, w, hi=1.6)
    for mode, scal in (("reinhard", torch.from_numpy(_scal("reinhard"))),
                       ("linear", th_fin.linear_scal(m))):
      for gamma in (1.0, 2.2):
        ye, vue = _emulate_planar_tone(x, scal, gamma, mode, t)
        yt, vut = th_yuv.yuv420_planar_tone_plain(x, scal, gamma, mode, t)
        np.testing.assert_array_equal(yt.numpy(), ye)
        np.testing.assert_array_equal(vut.numpy(), vue)


def test_planar_tone_wrapper_refuses_bad_input():
  x = torch.zeros(1, 3, 4, 6)
  one = torch.ones(1, 1, 1, 1)
  with pytest.raises(ValueError, match=r"\(N, 3, h, w\)"):
    th_yuv.yuv420_planar_tone(torch.zeros(1, 12, 4, 6), one, 1.0)
  with pytest.raises(ValueError, match="even output dims"):
    th_yuv.yuv420_planar_tone(torch.zeros(1, 3, 4, 5), one, 1.0)
  with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
    th_yuv.yuv420_planar_tone(x.double(), one, 1.0)
  with pytest.raises(ValueError, match=r"\[m0, inv_range\]"):
    th_yuv.yuv420_planar_tone(x, one, 1.0, "linear")
  with pytest.raises(ValueError, match="CUDA"):
    th_yuv.yuv420_planar_tone(x, one, 1.0, backend="kernel")


def test_inv255_table_is_the_ieee_quotient():
  tab = th_yuv.inv255_table(torch.device("cpu"))
  assert tab.dtype == torch.float32 and tuple(tab.shape) == (256,)
  np.testing.assert_array_equal(tab.numpy().view(np.uint32),
                                INV255.view(np.uint32))
  assert th_yuv.inv255_table(torch.device("cpu")) is tab


def test_coefficients_are_the_matrices():
  chains = th_yuv.coefficients(False)
  np.testing.assert_array_equal(chains[:9].reshape(3, 3), jcolor._YUV_M)
  np.testing.assert_array_equal(chains[9:], jcolor._YUV_OFFSET)
  dot = th_yuv.coefficients(True)
  w6 = np.asarray(jnp.asarray(jci._yuv420_w6(), jnp.bfloat16)
                  .astype(jnp.float32))
  np.testing.assert_array_equal(dot[0:3], w6[0, 0:3])
  np.testing.assert_array_equal(dot[3:6], w6[5, 0:3])   # U
  np.testing.assert_array_equal(dot[6:9], w6[4, 0:3])   # V
  np.testing.assert_array_equal(dot[9:], chains[9:])


# ------------------------------------------------------------- routes

def yuv_route_vs_jax(cls, frames, plan=None, stride=8,
                     transform=ImageTransform.none, tonemap="reinhard",
                     pattern="GRBG", gamma=1.0):
  """The frames through the port's and JAX's ``fused_isp_step`` with
  ``color_format="yuv420"``, the EMA carried over; Y and VU each held to
  ``compare_step``."""
  wd = CLASSES[cls][1]._work_dtype
  args = (gamma, 1.0, 1.0, 0.0, "packed12", False)
  tail = (None, plan, stride)
  jstep = jax.jit(lambda r, prev, t: jci.fused_isp_step(
      r, prev, t, *args, JDT[wd], jtit.BayerPattern[pattern], *tail,
      jtit.ImageTransform(transform.value), tonemap,
      color_format="yuv420"))
  m_j, m_t = jnp.zeros(9, jnp.float32), torch.zeros(9)
  outs = []
  for f, raws in enumerate(frames):
    t = 0.0 if f == 0 else 0.9
    m_j, (y_j, vu_j) = jstep(jnp.asarray(raws), m_j, jnp.float32(t))
    m_t, (y_t, vu_t) = tci.fused_isp_step(
        torch.from_numpy(raws), m_t, t, *args, wd,
        ttit.BayerPattern[pattern], *tail, transform, tonemap,
        color_format="yuv420")
    compare_step(m_t, y_t, m_j, y_j, wd)
    compare_step(m_t, vu_t, m_j, vu_j, wd)
    outs.append((y_t, vu_t))
  return outs


ROUTES = {
    "phase": dict(),
    "rotate_90": dict(transform=ImageTransform.rotate_90),
    "flip_vert": dict(transform=ImageTransform.flip_vert, gamma=2.2),
    "resize_width": dict(plan=((64, 16), 0.5)),
    "stride7": dict(stride=7),
    "linear": dict(tonemap="linear", gamma=2.2),
    "resize_rotate_90": dict(plan=((64, 16), 0.5),
                             transform=ImageTransform.rotate_90),
    "resize_linear": dict(plan=((64, 16), 0.5), tonemap="linear", gamma=2.2),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("cls", CLASSES)
def test_yuv420_routes_match_jax(cls, route):
  kw = ROUTES[route]
  outs = yuv_route_vs_jax(cls, [_raws(400 + f) for f in range(2)], **kw)
  h, w = kw["plan"][0][::-1] if "plan" in kw else (H, W)
  if kw.get("transform") == ImageTransform.rotate_90:
    h, w = w, h
  y, vu = outs[0]
  assert tuple(y.shape) == (N_CAM, h, w)
  assert tuple(vu.shape) == (N_CAM, 2, h // 2, w // 2)


@pytest.mark.parametrize("tonemap", ["reinhard", "linear"])
@pytest.mark.parametrize("cls", CLASSES)
def test_resize_yuv420_route_runs_the_tone_form(cls, tonemap, monkeypatch):
  """The resize route's I420 output is one call of the tonemap form on
  K3's p (or the resized image): no gamma or linear u8, no transform copy
  and no u8 conversion before it."""
  calls = []
  real = th_yuv.yuv420_planar_tone
  monkeypatch.setattr(th_yuv, "yuv420_planar_tone",
                      lambda *a, **k: calls.append(a[3]) or real(*a, **k))
  for name in ("reinhard_apply_ca", "linear_apply_ca", "_transform_planar",
               "yuv420_from_planar_u8"):
    monkeypatch.setattr(tci, name, lambda *a, name=name, **k: pytest.fail(
        f"{name} ran on the resize I420 route"))
  isp = CLASSES[cls][1](ttit.BayerPattern.RGGB, resize_width=64,
                        transform=ImageTransform.rotate_270, device="cpu")
  y, vu = isp.process(_raws(440), tonemap=tonemap, color_format="yuv420")
  assert calls == [tonemap]
  assert tuple(y.shape) == (N_CAM, 64, 16)
  assert tuple(vu.shape) == (N_CAM, 2, 32, 8)


def test_yuv420_front_fused_route_matches_jax(monkeypatch):
  """The front-fused chain with K4's I420 mode against the JAX step's
  front-fused route (the Pallas K7's tiling needs at least 32 x 128
  phases)."""
  _open_jax_gate(monkeypatch)
  gamma, tr = 2.2, ImageTransform.rotate_270
  jstep = jax.jit(lambda r, prev, t: jci.fused_isp_step(
      r, prev, t, gamma, 1.0, 1.0, 0.0, "packed12", False, jnp.bfloat16,
      jtit.BayerPattern.RGGB, None, None, 8, jtit.ImageTransform(tr.value),
      "reinhard", color_format="yuv420"))
  m_j, m_t = jnp.zeros(9, jnp.float32), torch.zeros(9)
  for f in range(2):
    raws = _raws_64x256(410 + f)
    t = 0.0 if f == 0 else 0.9
    m_j, (y_j, vu_j) = jstep(jnp.asarray(raws), m_j, jnp.float32(t))
    m_t, (y_t, vu_t) = front_fused_step(
        torch.from_numpy(raws), m_t, t, gamma, ttit.BayerPattern.RGGB,
        transform=tr, color_format="yuv420")
    compare_step(m_t, y_t, m_j, y_j, torch.bfloat16)
    compare_step(m_t, vu_t, m_j, vu_j, torch.bfloat16)


@pytest.mark.parametrize("cls", CLASSES)
def test_process_returns_y_vu_and_ignores_layout(cls):
  tcls = CLASSES[cls][1]
  a = tcls(ttit.BayerPattern.RGGB, device="cpu")
  b = tcls(ttit.BayerPattern.RGGB, device="cpu")
  for f in range(2):
    raws = _raws(420 + f)
    ya, vua = a.process(raws, color_format="yuv420")
    yb, vub = b.process(raws, color_format="yuv420", layout="hwc")
    assert torch.is_tensor(yb) and torch.is_tensor(vub)
    assert torch.equal(ya, yb) and torch.equal(vua, vub)
    assert tuple(ya.shape) == (N_CAM, H, W)
    assert tuple(vua.shape) == (N_CAM, 2, H // 2, W // 2)
    assert torch.equal(a.metrics, b.metrics)


def test_odd_output_dims_raise_value_error():
  """scale 0.37 of 32 x 128 gives 12 x 47: JAX and the port refuse it with
  the same ValueError, before the port updates its state."""
  jisp = jtit.CameraBF16(jtit.BayerPattern.RGGB, scale=0.37)
  tisp = ttit.CameraBF16(ttit.BayerPattern.RGGB, scale=0.37, device="cpu")
  raws = _raws(430)
  with pytest.raises(ValueError, match="even output dims"):
    jisp.process(raws, color_format="yuv420")
  with pytest.raises(ValueError, match="even output dims"):
    tisp.process(raws, color_format="yuv420")
  assert tisp.metrics is None
  assert tuple(tisp.process(raws).shape) == (N_CAM, 3, 12, 47)


def test_unknown_color_format_raises():
  with pytest.raises(ValueError, match="color_format"):
    ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu").process(
        _raws(431), color_format="nv12")


def test_div255_without_division_is_ieee():
  """csrc/finish.cu's div255 (the dot's sums / 255 from a multiply and two
  FMAs) against the IEEE f32 division, on every 97th f32 in [2^-20, 1024)
  with both signs: the dot's sums lie there. The emulation's products and
  the residual are exact in f64; its last sum is rounded twice (f64, then
  f32), which can only differ from one rounding next to an f32 midpoint:
  the test also shows that no sum comes near one."""
  lo = np.float32(2.0 ** -20).view(np.uint32)
  hi = np.float32(1024.0).view(np.uint32)
  s = np.arange(lo, hi, 97, dtype=np.uint32).view(np.float32)
  s = np.concatenate([s, -s])
  y = np.float64(np.float32(1) / np.float32(255))
  q0 = (s.astype(np.float64) * y).astype(np.float32)
  r = (s.astype(np.float64) - 255.0 * q0.astype(np.float64)).astype(
      np.float32)  # fmaf
  t = q0.astype(np.float64) + r.astype(np.float64) * y
  q = t.astype(np.float32)  # fmaf
  frac = np.abs(t - q) / np.spacing(np.abs(q)).astype(np.float64)
  assert np.abs(frac - 0.5).min() > 1e-6
  np.testing.assert_array_equal(q.view(np.uint32),
                                (s / np.float32(255)).view(np.uint32))
