"""K4 tonemap finish (gamma, u8 truncation, 2x2 phase->planar
interleave): the port's plain twin against the JAX Pallas finish in
interpret mode and the XLA tail (``reinhard_gamma_ca`` +
``phases_to_planar``). Contract: bitwise at gamma 1. At gamma != 1 the
two sides evaluate log2/exp2 with different math libraries (PyTorch's
and XLA's CPU ones), which can differ by an f32 ulp; where that ulp
crosses a u8 truncation boundary the outputs differ by one count
(measured: 1 pixel in 98304). So gamma != 1 holds to <=1 count on
<0.01% of pixels. On the card the kernel and its twin use the same
CUDA log2f/exp2f and are held bitwise at every gamma."""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu.models.camera_isp import reinhard_gamma_ca  # noqa: E402
from taichi_image_tpu.ops.bayer import phases_to_planar  # noqa: E402
from taichi_image_tpu.ops.pallas import finish as pl_fin  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import finish as th_fin  # noqa: E402
from taichi_image_tpu_torch.ops.interpolate import ImageTransform  # noqa: E402


def _bits(x):
  return np.asarray(x).view(np.uint16)


def _x12(n=2, hh=16, wh=256, seed=0, lo=0.0, hi=1.2):
  x = np.random.default_rng(seed).random((n, 12, hh, wh), np.float32)
  j = jnp.asarray(lo + x * (hi - lo), jnp.bfloat16)
  t = torch.from_numpy(_bits(j).view(np.int16).copy()).view(torch.bfloat16)
  return j, t


def _assert_finish(got, want, gamma):
  if gamma == 1.0:
    np.testing.assert_array_equal(got, want)
    return
  d = np.abs(got.astype(np.int64) - want.astype(np.int64))
  assert d.max() <= 1 and (d != 0).mean() < 1e-4, (d.max(), (d != 0).sum())


MAX = np.asarray([1.13, 0.97], np.float32).reshape(2, 1, 1, 1)


@pytest.mark.parametrize("gamma", [1.0, 2.2])
def test_finish_matches_pallas_interpret(gamma):
  j, t = _x12()
  want = np.asarray(pl_fin.finish_planar_u8(j, jnp.asarray(MAX), "reinhard",
                                            gamma, interpret=True))
  got = th_fin.finish_planar_u8(t, torch.from_numpy(MAX), gamma)
  assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 3, 32, 512)
  _assert_finish(got.numpy(), want, gamma)


def test_finish_max_clamp_and_saturation():
  j, t = _x12(seed=3)
  mx = np.asarray([0.0, 0.4], np.float32).reshape(2, 1, 1, 1)
  want = np.asarray(pl_fin.finish_planar_u8(j, jnp.asarray(mx), "reinhard",
                                            1.0, interpret=True))
  got = th_fin.finish_planar_u8(t, torch.from_numpy(mx), 1.0).numpy()
  np.testing.assert_array_equal(got, want)
  assert got.max() == 255


@pytest.mark.parametrize("gamma", [1.0, 2.2])
@pytest.mark.parametrize("shape", [(2, 16, 256), (3, 19, 50)])
def test_finish_matches_xla_tail(shape, gamma):
  # negative p (pixels below the metering floor) included: at gamma != 1
  # their log2 is NaN, which the XLA convert and the port both send to 0
  n, hh, wh = shape
  j, t = _x12(n, hh, wh, seed=5, lo=-0.2)
  mx = np.linspace(0.8, 1.1, n, dtype=np.float32).reshape(n, 1, 1, 1)
  u8_12 = reinhard_gamma_ca(j, jnp.asarray(mx), gamma)
  want = np.asarray(phases_to_planar(u8_12))
  got = th_fin.finish_planar_u8(t, torch.from_numpy(mx), gamma)
  _assert_finish(got.numpy(), want, gamma)


@pytest.mark.parametrize("gamma", [1.0, 2.2])
def test_gamma_and_planar_helpers_match_xla(gamma):
  # the phase-layout gamma stage and the identity interleave on their own
  j, t = _x12(2, 8, 20, seed=9, lo=-0.1)
  mx = np.asarray([0.9, 1.05], np.float32).reshape(2, 1, 1, 1)
  want = np.asarray(reinhard_gamma_ca(j, jnp.asarray(mx), gamma))
  got = tci.reinhard_gamma_ca(t, torch.from_numpy(mx), gamma).numpy()
  _assert_finish(got, want, gamma)
  np.testing.assert_array_equal(
      tci.planar_from_phases_transformed(torch.from_numpy(got),
                                         ImageTransform.none).numpy(),
      np.asarray(phases_to_planar(jnp.asarray(got))))


def test_interleave_is_exact_movement():
  # channel pc*6 + pr*3 + c must land at planar (c, 2i + pr, 2j + pc)
  n, hh, wh = 1, 4, 6
  x = np.zeros((n, 12, hh, wh), np.float32)
  for ch in range(12):
    x[:, ch] = (ch + 1) / 16.0
  t = torch.from_numpy(x).to(torch.bfloat16)
  got = th_fin.finish_planar_u8(t, torch.ones(n, 1, 1, 1), 1.0).numpy()
  for c in range(3):
    for pr in range(2):
      for pc in range(2):
        want = np.uint8(255.0 * ((pc * 6 + pr * 3 + c) + 1) / 16.0)
        assert (got[0, c, pr::2, pc::2] == want).all(), (c, pr, pc)




def _tone_quotient(p, mx):
  """csrc/finish.cuh tone_u8's Reinhard quotient without the division
  (reinhard_quotient) in numpy: q0 = p RN(1/mx), r = fma(-q0, mx, p),
  o = fma(r, RN(1/mx), q0), or q0 itself where it is infinite or NaN.
  Returns (o, whether the claim of exactness covers it: 2^-64 <= |q0| <=
  FLT_MAX). The FMAs are emulated exactly: r's product and sum are exact in
  f64 there, and the last sum is rounded from a long double, or from its
  exact value where the long double lands on an f32 midpoint."""
  f32 = np.float32
  rmx = f32(1) / mx
  with np.errstate(all="ignore"):
    q0 = p * rmx
    exact = (np.abs(q0) >= f32(2.0 ** -64)) & (np.abs(q0)
                                              <= np.finfo(f32).max)
    r = (p.astype(np.float64) - q0.astype(np.float64) * np.float64(mx)).astype(
        f32)
    s = q0.astype(np.longdouble) + (r.astype(np.longdouble)
                                    * np.longdouble(rmx))
    o = s.astype(f32)
    for i in np.nonzero(exact)[0]:
      lo, hi = sorted((o[i], np.nextafter(o[i], f32(np.inf) if s[i] > o[i]
                                          else f32(-np.inf))))
      if s[i] == (np.longdouble(lo) + np.longdouble(hi)) / 2:
        ex = Fraction(float(q0[i])) + Fraction(float(r[i])) * Fraction(
            float(rmx))
        mid = (Fraction(float(lo)) + Fraction(float(hi))) / 2
        o[i] = lo if ex < mid or (ex == mid and not lo.view(
            np.uint32) & 1) else hi
    finite = np.abs(q0) <= np.finfo(f32).max
    return np.where(finite, o, q0), exact


def _u8(o, gamma=1.0):
  """The tone's byte of the quotient o: trunc(clip(255 o^(1/gamma), 0,
  255)), the pow as exp2(log2(o) f32(1/gamma)) (none at gamma 1), a NaN
  giving 0."""
  with np.errstate(all="ignore"):
    if gamma != 1.0:
      o = np.exp2(np.log2(o) * np.float32(1.0 / gamma))
    s = np.clip(np.float32(255) * o, 0, 255)
  return np.nan_to_num(s, nan=0.0).astype(np.uint8)


def _around(v, ulps):
  """v and the ``ulps`` f32 neighbours on each side of each of its
  values."""
  f32 = np.float32
  out = [v]
  for d in (np.inf, -np.inf):
    w = v
    for _ in range(ulps):
      w = np.nextafter(w, f32(d))
      out.append(w)
  return np.concatenate(out).astype(f32)


@pytest.mark.parametrize("gamma", [1.0, 0.45, 0.6, 0.9, 2.2, 6.9])
@pytest.mark.parametrize("mx", [1e-6, 0.37, 0.999, 1.0, 1.13, 3.0, 97.5])
def test_tone_quotient_is_the_division(mx, gamma):
  """The kernel's Reinhard tone takes no division at gamma 1 and, through
  the pow, below gamma 7 (the form tone_form picks there): its quotient is
  the IEEE one bit for bit wherever 2^-64 <= |q0|, and its byte is the
  division's everywhere, the pow taken by the same log2 and exp2 on both:
  p at random in [0, 1.3 mx) and over 10^-45 .. 10^38, on every truncation
  boundary k mx / 255 and mx (k / 255)^gamma and 16 ulps either side of it,
  zeros of both signs, subnormals, negatives, inf and NaN."""
  f32 = np.float32
  assert th_fin.tone_form(gamma, "reinhard") == (0 if gamma == 1.0 else 1)
  mx = f32(mx)
  rng = np.random.default_rng(7)
  rand = (rng.random(100_000) * 1.3 * mx).astype(f32)
  wide = (10.0 ** rng.uniform(-45, 38, 50_000)).astype(f32)
  edge = np.concatenate([
      (np.arange(256, dtype=f32) * mx / f32(255)).astype(f32),
      (np.float64(mx) * (np.arange(256) / 255.0) ** gamma).astype(f32)])
  special = np.array([0.0, -0.0, 1e-45, 1e-40, -1e-40, 1e-30, -0.5, -3.0,
                      1e30, 3e38, np.inf, -np.inf, np.nan], f32)
  p = np.concatenate([rand, wide, -wide[:1000], _around(edge, 16),
                      special]).astype(f32)
  got, exact = _tone_quotient(p, mx)
  with np.errstate(all="ignore"):
    want = p / mx
  np.testing.assert_array_equal(got[exact].view(np.uint32),
                                want[exact].view(np.uint32))
  assert exact[:rand.size].mean() > 0.99
  np.testing.assert_array_equal(_u8(got, gamma), _u8(want, gamma))


def test_trunc_small_is_the_truncation():
  """csrc/finish.cuh trunc_small, the bits of RZ(v + 2^23) less those of
  2^23, is trunc(v) for the tone's 0 <= v <= 255: on every byte boundary k
  and 64 ulps either side of it, and at 10^6 random v in [0, 255]. The sum
  is emulated in f64, where it is exact for v >= 2^-29 (below that it
  rounds to within 2^-29 of 2^23 + v < 2^23 + 1), and its f32 RZ is the
  floor, the f32 grid of [2^23, 2^24) being the integers."""
  f32 = np.float32
  rng = np.random.default_rng(11)
  v = np.concatenate([_around(np.arange(256, dtype=f32), 64),
                      (rng.random(1_000_000) * 255).astype(f32),
                      np.array([0.0, -0.0, 1e-45, 255.0], f32)])
  v = v[(v >= 0) & (v <= 255)]
  rz = np.floor(v.astype(np.float64) + 2.0 ** 23).astype(f32)
  got = rz.view(np.uint32) - np.uint32(0x4B000000)
  np.testing.assert_array_equal(got, np.trunc(v).astype(np.uint32))


# -- K4's table form ----------------------------------------------------------

def _every_pattern(dtype, n=6, seed=0):
  """(n, 12, 8, 683) of ``dtype``: each image holds every bit pattern (NaN,
  zeros of both signs, negatives and subnormals included) in an order of
  its own, the 32 values past 65,536 repeating patterns."""
  u = torch.arange(12 * 8 * 683) % th_fin.TABLE_BYTES
  bits = (u - (u >= 0x8000) * 0x10000).to(torch.int16)
  g = torch.Generator().manual_seed(seed)
  x = torch.stack([bits[torch.randperm(bits.numel(), generator=g)]
                   for _ in range(n)])
  return x.view(dtype).reshape(n, 12, 8, 683)


TABLE_MAX = torch.tensor([1e-6, 0.37, 0.999, 1.13, 3.0, 97.5]).reshape(
    6, 1, 1, 1)


@pytest.mark.parametrize("gamma", [0.6, 0.9, 2.2, 7.5])
@pytest.mark.parametrize("mode", ["reinhard", "linear"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_table_twin_is_the_tone(dtype, mode, gamma):
  """The table form's twin, each image's tone of all 65,536 patterns then a
  gather at each value's bits, is bitwise gamma_u8 / linear_u8 on every
  pattern, under six maxima (Reinhard; at 7.5 its pow_div form) or the
  linear vector, and its planar output bitwise K4's twin's under flips."""
  x = _every_pattern(dtype)
  sc = TABLE_MAX if mode == "reinhard" else torch.tensor([-0.05, 1 / 1.1])
  tone = th_fin.gamma_u8 if mode == "reinhard" else th_fin.linear_u8
  tables = th_fin.tone_tables_plain(dtype, sc, gamma, mode, 6)
  assert tables.shape == (6, th_fin.TABLE_BYTES)
  u = torch.arange(th_fin.TABLE_BYTES)
  patterns = (u - (u >= 0x8000) * 0x10000).to(torch.int16).view(dtype)
  for b in range(6):
    want = tone(patterns[None], sc[b:b + 1] if mode == "reinhard" else sc,
                gamma)[0]
    assert torch.equal(tables[b], want), b
  for t in (ImageTransform.none, ImageTransform.flip_horiz,
            ImageTransform.rotate_180):
    got = th_fin.finish_planar_u8_table_plain(x, sc, gamma, mode, t)
    assert torch.equal(got, th_fin.finish_planar_u8_plain(x, sc, gamma, mode,
                                                          t)), t


# (dtype, gamma, mode, transform, frame (hh, wh), table form): the form
# does not hang on the frame's size, down to one half-res pixel
FORM_CASES = {
    "f16 0.6": (torch.float16, 0.6, "reinhard", ImageTransform.none, (2, 3),
                True),
    "f16 0.6 one pixel": (torch.float16, 0.6, "reinhard", ImageTransform.none,
                          (1, 1), True),
    "bf16 0.9 flip_horiz": (torch.bfloat16, 0.9, "reinhard",
                            ImageTransform.flip_horiz, (2, 3), True),
    "bf16 7.5 rotate_180": (torch.bfloat16, 7.5, "reinhard",
                            ImageTransform.rotate_180, (2, 3), True),
    "f16 linear 2.2 flip_vert": (torch.float16, 2.2, "linear",
                                 ImageTransform.flip_vert, (2, 3), True),
    "bf16 linear 0.6 one pixel": (torch.bfloat16, 0.6, "linear",
                                  ImageTransform.none, (1, 1), True),
    "f32 0.6": (torch.float32, 0.6, "reinhard", ImageTransform.none, (2, 3),
                False),
    "f16 gamma 1": (torch.float16, 1.0, "reinhard", ImageTransform.none,
                    (2, 3), False),
    "bf16 linear gamma 1": (torch.bfloat16, 1.0, "linear",
                            ImageTransform.none, (2, 3), False),
    "f16 rotate_90": (torch.float16, 0.6, "reinhard",
                      ImageTransform.rotate_90, (2, 3), False),
    "bf16 transpose": (torch.bfloat16, 0.9, "reinhard",
                       ImageTransform.transpose, (2, 3), False),
}


def _stub_launch(monkeypatch, k):
  """The kernel route on CPU tensors through ``k``'s stubbed launcher: no
  device to enter, stream 0. Returns (the launcher's calls, the table
  scratch's sizes in images)."""
  from taichi_image_tpu_torch.ops import hopper
  monkeypatch.setattr(hopper, "use_kernel", lambda backend, x: True)
  monkeypatch.setattr(hopper, "enter_device", lambda device: None)
  monkeypatch.setattr(hopper, "leave_device", lambda prev: None)
  monkeypatch.setattr(hopper, "stream_of", lambda device: 0)
  sizes, seen = [], []
  monkeypatch.setattr(th_fin, "_tables", lambda device, n: sizes.append(n)
                      or torch.zeros(n * th_fin.TABLE_BYTES,
                                     dtype=torch.uint8))
  monkeypatch.setattr(k, "_fn", lambda *args: seen.append(args) or 0)
  monkeypatch.setattr(k, "launches", 0)
  return seen, sizes


@pytest.mark.parametrize("case", FORM_CASES)
def test_wrapper_takes_the_table_form(case, monkeypatch):
  """K4's wrapper passes the table scratch to its launcher for a 16-bit
  dtype at gamma != 1 without an axis swap, whatever the frame's size, and
  null otherwise; the scratch holds a table an image, and the call counts
  two launches (the table build and the rows kernel) where it passes it."""
  dtype, gamma, mode, t, (hh, wh), want = FORM_CASES[case]
  assert th_fin.table_form(dtype, gamma, mode, t) is want
  k = th_fin.KERNELS[dtype]
  seen, sizes = _stub_launch(monkeypatch, k)
  x12 = torch.zeros(2, 12, hh, wh, dtype=dtype)
  sc = torch.ones(2, 1, 1, 1) if mode == "reinhard" else torch.tensor(
      [0.0, 1.0])
  th_fin.finish_planar_u8(x12, sc, gamma, mode, t)
  (args,) = seen
  assert (args[12] is not None) is want
  assert sizes == ([2] if want else [])
  assert args[6:8] == th_fin.tone_args(gamma, mode)[:2]
  assert k.launches == (2 if want else 1)


def test_table_scratch_is_kept_per_stream(monkeypatch):
  """One scratch a (device, stream), replaced only by a larger one when
  the images grow in number: nothing is allocated a launch."""
  from taichi_image_tpu_torch.ops import hopper
  stream = [7]
  monkeypatch.setattr(hopper, "stream_of", lambda device: stream[0])
  monkeypatch.setattr(th_fin, "_TABLES", {})
  cpu = torch.device("cpu")
  a = th_fin._tables(cpu, 6)
  assert a.numel() == 6 * th_fin.TABLE_BYTES and a.dtype == torch.uint8
  assert th_fin._tables(cpu, 6) is a and th_fin._tables(cpu, 2) is a
  b = th_fin._tables(cpu, 8)
  assert b.numel() == 8 * th_fin.TABLE_BYTES and th_fin._tables(cpu, 6) is b
  stream[0] = 9
  c = th_fin._tables(cpu, 1)
  assert c is not b and c.numel() == th_fin.TABLE_BYTES


# -- the table form of K4's I420 mode -----------------------------------------

# the transforms that swap no axes: the rows kernels' table forms take them
ROW_TRANSFORMS = (ImageTransform.none, ImageTransform.flip_horiz,
                  ImageTransform.flip_vert, ImageTransform.rotate_180)


@pytest.mark.parametrize("gamma", [0.6, 0.9, 2.2, 7.5])
@pytest.mark.parametrize("mode", ["reinhard", "linear"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_i420_table_twin_is_the_i420_twin(dtype, mode, gamma):
  """The twin of the I420 mode's table form (each image's tables, a gather
  at each value's bits, the phase transform, then the conversion) is
  bitwise the I420 mode's twin on every bit pattern, under six maxima
  (Reinhard; at 7.5 its pow_div form) or the linear vector, with each
  transform that swaps no axes: Y and VU alike."""
  x = _every_pattern(dtype)
  sc = TABLE_MAX if mode == "reinhard" else torch.tensor([-0.05, 1 / 1.1])
  for t in ROW_TRANSFORMS:
    assert th_fin.table_form(dtype, gamma, mode, t)
    y, vu = th_fin.finish_yuv420_table_plain(x, sc, gamma, mode, t)
    want_y, want_vu = th_fin.finish_yuv420_plain(x, sc, gamma, mode, t)
    assert y.shape == (6, 16, 1366) and vu.shape == (6, 2, 8, 683)
    assert torch.equal(y, want_y) and torch.equal(vu, want_vu), t


@pytest.mark.parametrize("case", FORM_CASES)
def test_i420_wrapper_takes_the_table_form(case, monkeypatch):
  """K4's I420 wrapper passes the table scratch to its launcher exactly
  where :func:`table_form` holds (f32, gamma 1 and an axis swap pass
  null), whatever the frame's size; the scratch holds a table an image,
  and the call counts two launches (the table build and the I420 kernel)
  where it passes it."""
  dtype, gamma, mode, t, (hh, wh), want = FORM_CASES[case]
  assert th_fin.table_form(dtype, gamma, mode, t) is want
  k = th_fin.YUV420_KERNELS[dtype]
  seen, sizes = _stub_launch(monkeypatch, k)
  x12 = torch.zeros(2, 12, hh, wh, dtype=dtype)
  sc = torch.ones(2, 1, 1, 1) if mode == "reinhard" else torch.tensor(
      [0.0, 1.0])
  th_fin.finish_yuv420(x12, sc, gamma, mode, t)
  (args,) = seen
  assert (args[15] is not None) is want
  assert sizes == ([2] if want else [])
  assert args[7:9] == th_fin.tone_args(gamma, mode)[:2]
  assert k.launches == (2 if want else 1)


# -- P's table form -----------------------------------------------------------

@pytest.mark.parametrize("gamma", [0.6, 0.9, 2.2, 7.5])
@pytest.mark.parametrize("mode", ["reinhard", "linear"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_planar_table_twin_is_the_tone(dtype, mode, gamma):
  """P's table twin, each image's tables then a gather at each value's
  bits then the transform, is bitwise P's twin on planar images that each
  hold every bit pattern, under six maxima (Reinhard; at 7.5 its pow_div
  form) or the linear vector, with no transform, flip_horiz and
  rotate_180."""
  x = _every_pattern(dtype).reshape(6, 3, 32, 683)
  sc = TABLE_MAX if mode == "reinhard" else torch.tensor([-0.05, 1 / 1.1])
  for t in (ImageTransform.none, ImageTransform.flip_horiz,
            ImageTransform.rotate_180):
    got = th_fin.finish_planar_tone_table_plain(x, sc, gamma, mode, t)
    want = th_fin.finish_planar_tone_plain(x, sc, gamma, mode, t)
    assert got.dtype == torch.uint8 and torch.equal(got, want), t


# (dtype, gamma, mode, transform, image (h, w), table form): K4's rule, and
# each image at least 65,536 values (3 h w); (1, m) is the tone on any
# layout's (n, 3, 1, m) view
PLANAR_FORM_CASES = {
    "f16 0.6 1080p": (torch.float16, 0.6, "reinhard", ImageTransform.none,
                      (1080, 1920), True),
    "f16 0.6 at the floor": (torch.float16, 0.6, "reinhard",
                             ImageTransform.none, (2, 10923), True),
    "f16 0.6 under the floor": (torch.float16, 0.6, "reinhard",
                                ImageTransform.none, (5, 4369), False),
    "bf16 0.6 view at the floor": (torch.bfloat16, 0.6, "reinhard",
                                   ImageTransform.none, (1, 21846), True),
    "bf16 0.6 view under the floor": (torch.bfloat16, 0.6, "reinhard",
                                      ImageTransform.none, (1, 21845),
                                      False),
    "bf16 0.9 flip_horiz": (torch.bfloat16, 0.9, "reinhard",
                            ImageTransform.flip_horiz, (120, 200), True),
    "f16 7.5 rotate_180": (torch.float16, 7.5, "reinhard",
                           ImageTransform.rotate_180, (120, 200), True),
    "f16 linear 2.2 flip_vert": (torch.float16, 2.2, "linear",
                                 ImageTransform.flip_vert, (120, 200), True),
    "bf16 linear 0.6 view": (torch.bfloat16, 0.6, "linear",
                             ImageTransform.none, (1, 30000), True),
    "f32 0.6": (torch.float32, 0.6, "reinhard", ImageTransform.none,
                (120, 200), False),
    "f16 gamma 1": (torch.float16, 1.0, "reinhard", ImageTransform.none,
                    (120, 200), False),
    "bf16 linear gamma 1": (torch.bfloat16, 1.0, "linear",
                            ImageTransform.none, (120, 200), False),
    "f16 rotate_90": (torch.float16, 0.6, "reinhard",
                      ImageTransform.rotate_90, (120, 200), False),
    "bf16 transpose": (torch.bfloat16, 0.9, "reinhard",
                       ImageTransform.transpose, (120, 200), False),
}


@pytest.mark.parametrize("case", PLANAR_FORM_CASES)
def test_planar_wrapper_takes_the_table_form(case, monkeypatch):
  """P's wrapper passes the table scratch to its launcher exactly where
  :func:`planar_table_form` holds (K4's rule, and each image at least
  65,536 values) and null otherwise; the scratch holds a table an image,
  and the call counts two launches (the table build and the rows kernel)
  where it passes it."""
  dtype, gamma, mode, t, (h, w), want = PLANAR_FORM_CASES[case]
  assert th_fin.planar_table_form(dtype, gamma, mode, t, h, w) is want
  assert th_fin.table_form(dtype, gamma, mode, t) is (
      want or 3 * h * w < th_fin.TABLE_BYTES)
  k = th_fin.PLANAR_TONE_KERNELS[dtype]
  seen, sizes = _stub_launch(monkeypatch, k)
  x = torch.zeros(2, 3, h, w, dtype=dtype)
  sc = torch.ones(2, 1, 1, 1) if mode == "reinhard" else torch.tensor(
      [0.0, 1.0])
  th_fin.finish_planar_tone(x, sc, gamma, mode, t)
  (args,) = seen
  assert len(args) == 14  # the 13 arguments and the stream
  assert (args[12] is not None) is want
  assert sizes == ([2] if want else [])
  assert args[6:8] == th_fin.tone_args(gamma, mode)[:2]
  assert k.launches == (2 if want else 1)


@pytest.mark.parametrize("shape, mode, want", [
    ((2, 6, 10923), "reinhard", True),      # 65,538 values an image
    ((2, 3, 21845), "reinhard", False),     # 65,535
    ((4, 3, 8, 16), "reinhard", False),
    ((2, 3, 21845), "linear", True),        # one image of 131,070
    ((1, 3, 7, 3121), "linear", True),
], ids=["at the floor", "under the floor", "small", "linear whole",
        "linear odd"])
def test_tone_any_takes_the_table_form_by_image_size(shape, mode, want,
                                                     monkeypatch):
  """The tone on any layout runs P on (n, 3, 1, m) views of its images
  (the linear tone's whole tensor one image): the table form where an
  image holds at least 65,536 values, the direct form for smaller ones."""
  k = th_fin.PLANAR_TONE_KERNELS[torch.float16]
  seen, sizes = _stub_launch(monkeypatch, k)
  x = torch.zeros(shape, dtype=torch.float16)
  sc = torch.ones(shape[0]) if mode == "reinhard" else torch.tensor(
      [0.0, 1.0])
  tci._tone_any(x, sc, 0.6, mode)
  (args,) = seen
  n = shape[0] if mode == "reinhard" else 1
  assert args[3:6] == (n, 1, x.numel() // (3 * n))
  assert (args[12] is not None) is want
  assert sizes == ([n] if want else [])
  assert k.launches == (2 if want else 1)
