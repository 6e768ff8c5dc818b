"""The reference's per-image ISP API on the port (``PlanarImage``, the
loaders, ``update_metering``, ``tonemap_*``, ``resize_image``,
``auto_white_balance``, ``process_stream``, the module tonemaps and the
debug mode), against the JAX classes on the CPU, on the same inputs.

Mirrors tests/test_lazy.py (all 7 tests) and the loader, AWB and stream
tests of tests/test_isp.py. Contracts:
  * the lazy list path (``load_*`` of every camera, then one
    ``tonemap_*``) is bitwise ``process`` on a fresh ISP, u8 and metrics:
    it is the same step on the concatenated raws;
  * in the port the staged path (forced handles) is bitwise the lazy path
    too: its phase-form batches meter the stencil's own sample and run
    the step's K3 and K4 (the JAX package holds them within 1 count);
  * each path against its JAX counterpart: test_torch_resize's
    ``compare_step`` (metrics within 1e-5, u8 within 1 count, a rare 2 in
    bf16); images from the loaders within the f32 demosaic contract of
    tests/test_torch_raw_formats.py (XLA's convolution sums in its own
    order; 2^-21), bitwise in bf16 and f16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import taichi_image_tpu as jtit  # noqa: E402
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu import types as jtypes  # noqa: E402
from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.ops import packed as jpk  # noqa: E402
from taichi_image_tpu.utils import debug as jdebug  # noqa: E402
from taichi_image_tpu_torch import types as ttypes  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.utils import bounds as tbounds  # noqa: E402
from taichi_image_tpu_torch.utils import debug as tdebug  # noqa: E402
from conftest import make_test_rgb, psnr  # noqa: E402
from oracle import rgb_to_bayer_oracle  # noqa: E402
from test_isp import _casted_raws, load_test_image  # noqa: E402
from test_torch_resize import CLASSES, compare_step  # noqa: E402

RGGB_J, RGGB_T = jtit.BayerPattern.RGGB, ttit.BayerPattern.RGGB


def _maxdiff(a, b):
  return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max()


def _pair(cls="Camera32", **kw):
  """The JAX ISP and the port's (on the CPU), one configuration."""
  jcls, tcls = CLASSES[cls]
  tkw = dict(kw)
  if "transform" in kw:
    tkw["transform"] = ttit.ImageTransform(kw["transform"].value)
  return jcls(RGGB_J, **kw), tcls(RGGB_T, device="cpu", **tkw)


def _stack(handles) -> torch.Tensor:
  return torch.stack([h.planar for h in handles])


def _compare_lists(tisp, touts, jisp, jouts):
  compare_step(tisp.metrics, _stack(touts), jisp.metrics,
               np.stack([np.moveaxis(np.asarray(o), -1, 0) for o in jouts]),
               tisp._work_dtype)


def _assert_image_contract(got, want, dtype):
  """A loader's image against JAX's: bitwise in bf16 and f16, within
  2^-21 in f32 (the demosaic's summation order)."""
  got, want = np.asarray(got), np.asarray(want).astype(got.dtype)
  assert got.shape == want.shape
  if dtype == torch.float32:
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -21)
  else:
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ tests/test_lazy.py

def test_lazy_handle_defers_and_matches_eager():
  raw, _ = load_test_image(64, 96)
  jisp, isp = _pair()
  img = isp.load_packed12(raw)
  assert img._lazy is not None and img._phases is None
  assert img.shape == (64, 96, 3)
  assert "lazy" in repr(img)
  assert img._lazy is not None  # still unforced after metadata access
  eager = np.asarray(img)  # forces a one-image decode
  assert img._lazy is None and img._phases is not None
  _assert_image_contract(eager, jisp.load_packed12(raw), torch.float32)

  isp2 = ttit.Camera32(RGGB_T, device="cpu")
  imgs = [isp2.load_packed12(raw) for _ in range(3)]
  isp2.update_metering(imgs)
  assert all(im._lazy is None for im in imgs)  # decoded as one batch
  assert imgs[1]._batch is not None
  np.testing.assert_array_equal(eager, np.asarray(imgs[1]))
  assert imgs[1]._batch is None  # forcing sliced it out


def test_shared_batch_reused_across_calls():
  raw, _ = load_test_image(64, 96)
  isp = ttit.Camera32(RGGB_T, device="cpu")
  imgs = [isp.load_packed12(raw) for _ in range(2)]
  isp.update_metering(imgs)
  parent = imgs[0]._batch[1]
  isp.update_metering(imgs)  # the second call reuses the batch tensor
  assert imgs[0]._batch is not None and imgs[0]._batch[1] is parent


def test_fused_fast_path_matches_staged():
  """tonemap_reinhard over unforced lazy handles runs the fused step;
  forcing the handles first runs the staged path: bitwise in the port,
  and each within the contract of the JAX package's."""
  raw, _ = load_test_image(64, 96)
  kw = dict(gamma=0.8, intensity=2.0)
  isps = {}
  for path in ("staged", "fused"):
    jisp, tisp = _pair(moving_alpha=0.2)
    ji = [jisp.load_packed12(raw) for _ in range(2)]
    ti = [tisp.load_packed12(raw) for _ in range(2)]
    if path == "staged":
      for im in ti + ji:
        im._force()
    outs = [(tisp.tonemap_reinhard(ti, **kw), jisp.tonemap_reinhard(ji, **kw))
            for _ in range(2)]  # two EMA rounds
    if path == "fused":
      assert all(im._lazy is not None for im in ti)  # inputs stay lazy
    for to, jo in outs:
      _compare_lists(tisp, to, jisp, jo)
    isps[path] = (tisp, outs)
  (ts, so), (tf, fo) = isps["staged"], isps["fused"]
  assert torch.equal(ts.metrics, tf.metrics)
  for (a, _), (b, _) in zip(so, fo):
    assert torch.equal(_stack(a), _stack(b))


@pytest.mark.parametrize("cls", ["Camera32", "CameraBF16"])
def test_fused_fast_path_linear_and_bf16(cls):
  raw, _ = load_test_image(64, 96)
  res = []
  for force in (True, False):
    jisp, tisp = _pair(cls)
    ti = [tisp.load_packed12(raw) for _ in range(2)]
    ji = [jisp.load_packed12(raw) for _ in range(2)]
    if force:
      for im in ti + ji:
        im._force()
    to, jo = tisp.tonemap_linear(ti, gamma=0.9), jisp.tonemap_linear(ji,
                                                                     gamma=0.9)
    _compare_lists(tisp, to, jisp, jo)
    res.append((tisp.metrics, _stack(to)))
  assert torch.equal(res[0][0], res[1][0])
  assert torch.equal(res[0][1], res[1][1])


def test_lazy_captures_loader_config():
  """set() between load and tonemap does not change an image already
  loaded: the lazy handle captured the load-time configuration."""
  raw, _ = load_test_image(64, 96)
  outs = []
  for force in (False, True):
    jisp, tisp = _pair(correct_colors=True)
    ti, ji = tisp.load_packed12(raw), jisp.load_packed12(raw)
    if force:
      np.asarray(ti), np.asarray(ji)  # forced with the original WB
    tisp.set(white_balance=[1.0, 1.0, 1.0])
    jisp.set(white_balance=[1.0, 1.0, 1.0])
    to, jo = tisp.tonemap_reinhard([ti]), jisp.tonemap_reinhard([ji])
    _compare_lists(tisp, to, jisp, jo)
    outs.append(np.asarray(to[0]))
  np.testing.assert_array_equal(outs[0], outs[1])


def test_mixed_batch_falls_back_to_staged():
  raw, _ = load_test_image(64, 96)
  jisp, tisp = _pair()
  ta, tb = tisp.load_packed12(raw), tisp.load_packed12(raw)
  ja, jb = jisp.load_packed12(raw), jisp.load_packed12(raw)
  np.asarray(ta), np.asarray(ja)  # one forced: a mixed list, staged
  to, jo = tisp.tonemap_reinhard([ta, tb]), jisp.tonemap_reinhard([ja, jb])
  assert len(to) == 2
  np.testing.assert_array_equal(np.asarray(to[0]), np.asarray(to[1]))
  _compare_lists(tisp, to, jisp, jo)


def test_lazy_resize_width_shape_and_values():
  raw, _ = load_test_image(64, 96)
  jisp, tisp = _pair(resize_width=48)
  ti, ji = tisp.load_packed12(raw), jisp.load_packed12(raw)
  assert ti.shape == (32, 48, 3)  # from the plan, no forcing
  assert ti._lazy is not None
  to, jo = tisp.tonemap_reinhard([ti]), jisp.tonemap_reinhard([ji])
  assert np.asarray(to[0]).shape == (32, 48, 3)
  _compare_lists(tisp, to, jisp, jo)
  eager = ttit.Camera32(RGGB_T, resize_width=48, device="cpu")
  ei = eager.load_packed12(raw)
  np.asarray(ei)
  assert _maxdiff(to[0], eager.tonemap_reinhard([ei])[0]) <= 1


# ------------------------------------------------ the lazy list path

@pytest.mark.parametrize("cls", CLASSES)
def test_lazy_list_is_process_bitwise(cls):
  """load_packed12 of each camera, then tonemap_reinhard: bitwise
  ``process`` on a fresh ISP over the stacked raws, two EMA rounds; and
  the lazy linear path likewise."""
  tcls = CLASSES[cls][1]
  rng = np.random.default_rng(7)
  for tonemap in ("reinhard", "linear"):
    lazy = tcls(RGGB_T, device="cpu", moving_alpha=0.3)
    fresh = tcls(RGGB_T, device="cpu", moving_alpha=0.3)
    for _ in range(2):
      raws = rng.integers(0, 256, (3, 16, 96), dtype=np.uint8)
      imgs = [lazy.load_packed12(r) for r in raws]
      outs = getattr(lazy, f"tonemap_{tonemap}")(imgs, gamma=0.8)
      want = fresh.process(raws, gamma=0.8, tonemap=tonemap)
      assert torch.equal(_stack(outs), want)
      assert torch.equal(lazy.metrics, fresh.metrics)


@pytest.mark.parametrize("fmt", ["packed16", "u16", "f16", "f32"])
def test_lazy_list_formats_match_jax(fmt):
  """Each loader's lazy list path against the JAX one's, and against
  ``process`` on the port bitwise."""
  img = make_test_rgb(32, 48)
  cfa = rgb_to_bayer_oracle(img, "RGGB")
  raw = {"packed16": np.asarray(jpk.encode16((cfa * 65535)
                                             .astype(np.uint16))),
         "u16": (cfa * 65535).astype(np.uint16),
         "f16": cfa.astype(np.float16), "f32": cfa}[fmt]
  loader = {"packed16": "load_packed16", "u16": "load_16u",
            "f16": "load_16f", "f32": "load_32f"}[fmt]
  jisp, tisp = _pair("Camera16")
  to = tisp.tonemap_reinhard([getattr(tisp, loader)(raw)] * 2)
  jo = jisp.tonemap_reinhard([getattr(jisp, loader)(raw)] * 2)
  _compare_lists(tisp, to, jisp, jo)
  fresh = ttit.Camera16(RGGB_T, device="cpu")
  assert torch.equal(fresh.process(np.stack([raw] * 2), fmt=fmt),
                     _stack(to))


def test_staged_mixed_u16_list_matches_jax():
  """load_16u, one handle forced, update_metering then tonemap_linear
  (two EMA updates, as in JAX)."""
  rng = np.random.default_rng(8)
  raws = [rng.integers(0, 65536, (16, 64), dtype=np.uint16)
          for _ in range(3)]
  for cls in CLASSES:
    jisp, tisp = _pair(cls)
    ti = [tisp.load_16u(r) for r in raws]
    ji = [jisp.load_16u(r) for r in raws]
    ti[1]._force(), ji[1]._force()
    tisp.update_metering(ti)
    jisp.update_metering(ji)
    np.testing.assert_allclose(tisp.metrics.numpy(), np.asarray(jisp.metrics),
                               rtol=0, atol=1e-5)
    _compare_lists(tisp, tisp.tonemap_linear(ti, gamma=1.2), jisp,
                   jisp.tonemap_linear(ji, gamma=1.2))


# ------------------------------------------------ tests/test_isp.py

@pytest.mark.parametrize("cls", ["Camera32", "Camera16", "CameraBF16"])
def test_load_packed12_shapes(cls):
  raw, img = load_test_image()
  jisp, tisp = _pair(cls)
  rgb = np.asarray(tisp.load_packed12(raw))
  assert rgb.shape == (64, 96, 3)
  assert rgb.dtype == (np.float16 if cls == "Camera16" else np.float32)
  assert psnr(rgb.astype(np.float32), img) > 30
  _assert_image_contract(rgb, jisp.load_packed12(raw),
                         tisp._work_dtype)


def test_load_packed16():
  img = make_test_rgb(32, 48)
  cfa16 = (rgb_to_bayer_oracle(img, "RGGB") * 65535).astype(np.uint16)
  raw = np.asarray(jpk.encode16(cfa16))
  jisp, tisp = _pair()
  rgb = np.asarray(tisp.load_packed16(raw))
  assert rgb.shape == (32, 48, 3)
  assert psnr(rgb, img) > 30
  _assert_image_contract(rgb, jisp.load_packed16(raw), torch.float32)


def test_load_16u():
  img = make_test_rgb(32, 48)
  cfa16 = (rgb_to_bayer_oracle(img, "RGGB") * 65535).astype(np.uint16)
  jisp, tisp = _pair()
  rgb = np.asarray(tisp.load_16u(cfa16))
  assert psnr(rgb, img) > 30
  _assert_image_contract(rgb, jisp.load_16u(cfa16), torch.float32)


@pytest.mark.parametrize("loader,dtype", [("load_32f", np.float32),
                                          ("load_16f", np.float16)])
def test_load_float(loader, dtype):
  img = make_test_rgb(32, 48)
  cfa = rgb_to_bayer_oracle(img, "RGGB").astype(dtype)
  jisp, tisp = _pair()
  rgb = np.asarray(getattr(tisp, loader)(cfa))
  assert psnr(rgb, img) > 30
  _assert_image_contract(rgb, getattr(jisp, loader)(cfa), torch.float32)


def test_loaders_validate_raws():
  isp = ttit.Camera32(RGGB_T, device="cpu")
  with pytest.raises(ValueError, match="multiple of 3"):
    isp.load_packed12(np.zeros((4, 10), np.uint8))
  with pytest.raises(ValueError, match="even"):
    isp.load_packed16(np.zeros((4, 6), np.uint8))
  with pytest.raises(ValueError, match="2-D"):
    isp.load_16u(np.zeros((1, 4, 6), np.uint16))


def test_tonemap_six_cameras_transform_and_only():
  raw, _ = load_test_image()
  jisp, tisp = _pair(moving_alpha=1.0,
                     transform=jtit.ImageTransform.rotate_90)
  to = tisp.tonemap_reinhard([tisp.load_packed12(raw) for _ in range(6)],
                             gamma=0.6)
  jo = jisp.tonemap_reinhard([jisp.load_packed12(raw) for _ in range(6)],
                             gamma=0.6)
  assert len(to) == 6 and np.asarray(to[0]).shape == (96, 64, 3)
  np.testing.assert_array_equal(np.asarray(to[0]), np.asarray(to[5]))
  _compare_lists(tisp, to, jisp, jo)
  ti, ji = tisp.load_packed12(raw), jisp.load_packed12(raw)
  a = np.asarray(tisp.tonemap_only(ti, tisp.metrics, 1.0, 1.0, 1.0, 0.0))
  b = np.asarray(jisp.tonemap_only(ji, jisp.metrics, 1.0, 1.0, 1.0, 0.0))
  assert a.dtype == np.uint8 and a.shape == (96, 64, 3)
  assert _maxdiff(a, b) <= 1
  # an HWC array takes the planar path
  hwc = make_test_rgb(64, 96)
  a = np.asarray(tisp.tonemap_only(hwc, tisp.metrics, 0.9, 1.5, 0.8, 0.3))
  b = np.asarray(jisp.tonemap_only(hwc, jisp.metrics, 0.9, 1.5, 0.8, 0.3))
  assert _maxdiff(a, b) <= 1


def test_resize_image_and_metering_images():
  img = make_test_rgb(64, 96)
  jisp, tisp = _pair(resize_width=48)
  a, b = np.asarray(tisp.resize_image(img)), np.asarray(jisp.resize_image(img))
  assert a.shape == (32, 48, 3)
  np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -21)
  raw, _ = load_test_image()
  a = np.asarray(tisp.resize_image(tisp.load_packed12(raw)))
  b = np.asarray(jisp.resize_image(jisp.load_packed12(raw)))
  np.testing.assert_allclose(a, b, rtol=0, atol=2.0 ** -21)
  plain = ttit.Camera32(RGGB_T, device="cpu")
  np.testing.assert_array_equal(np.asarray(plain.resize_image(img)), img)

  imgs = [make_test_rgb(32, 32, seed=s) for s in range(2)]
  prev = torch.zeros(9)
  for stride in (8, 7):
    tisp.metering_stride = jisp.metering_stride = stride
    m = tisp.metering_images(imgs, 0.5, prev, stride)
    mj = jisp.metering_images(imgs, 0.5, np.zeros(9, np.float32), stride)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=0, atol=1e-5)
  assert tisp.metrics is None  # functional: the EMA state is untouched
  assert float(prev.sum()) == 0.0  # and prev is not consumed


def test_metering_ema_seeding_and_state():
  raw, _ = load_test_image()
  jisp, tisp = _pair(moving_alpha=0.1)
  ti = [tisp.load_packed12(raw) for _ in range(2)]
  ji = [jisp.load_packed12(raw) for _ in range(2)]
  for _ in range(2):
    tisp.update_metering(ti)
    jisp.update_metering(ji)
    np.testing.assert_allclose(tisp.metrics.numpy(), np.asarray(jisp.metrics),
                               rtol=0, atol=1e-5)
  state = tisp.state_dict()
  isp2 = ttit.Camera32(RGGB_T, device="cpu")
  isp2.load_state(state)
  assert torch.equal(isp2.metrics, tisp.metrics)


def test_auto_white_balance_converges_like_jax():
  """The AWB loop on a blue-heavy cast, the port beside JAX: the gains
  (quantized to 1/256) equal JAX's after every round, and the post-WB
  means equalize."""
  raws = _casted_raws(cast=(0.5, 1.0, 1.6))
  kw = dict(white_balance=[1.0, 1.0, 1.0], correct_colors=True,
            color_correction=np.eye(3, dtype=np.float64), moving_alpha=1.0)
  jisp, tisp = _pair(**kw)
  spreads = []
  for _ in range(6):
    tisp.process(raws)
    jisp.process(raws)
    means = tisp.metrics.numpy()[6:9]
    spreads.append(float(means.max() / means.min()))
    np.testing.assert_array_equal(tisp.auto_white_balance(),
                                  jisp.auto_white_balance())
  wb = tisp.white_balance
  assert wb[1] == 1.0
  assert wb[0] > 1.5 and wb[2] < 0.8, wb
  assert spreads[-1] < 1.05 < spreads[0], spreads


def test_auto_white_balance_guards_and_state():
  isp = ttit.Camera32(RGGB_T, device="cpu", correct_colors=True,
                      color_correction=np.eye(3))
  with pytest.raises(ValueError, match="metering state"):
    isp.auto_white_balance()
  isp.process(_casted_raws(cast=(0.6, 1.0, 1.4)))
  wb = isp.auto_white_balance(max_gain=2.0)
  assert (wb <= 2.0).all() and (wb >= 0.5).all()
  assert np.all(wb * 256 == np.round(wb * 256))
  state = isp.state_dict()
  isp2 = ttit.Camera32(RGGB_T, device="cpu")
  isp2.load_state(state)
  np.testing.assert_array_equal(isp2.white_balance, wb)
  isp2.load_state({"metrics": state["metrics"]})  # a checkpoint without WB
  np.testing.assert_array_equal(isp2.white_balance, wb)
  # a JAX ISP's state carries its white balance over
  jisp = jtit.Camera32(RGGB_J, correct_colors=True,
                       color_correction=np.eye(3))
  jisp.process(_casted_raws(cast=(0.6, 1.0, 1.4)))
  jwb = jisp.auto_white_balance()
  isp2.load_state(ttit.state_from_jax(jisp.state_dict()))
  np.testing.assert_array_equal(isp2.white_balance, jwb)
  np.testing.assert_array_equal(isp2.metrics.numpy(), np.asarray(jisp.metrics))


def test_process_stream():
  raw, _ = load_test_image(64, 96)
  jisp, tisp = _pair(moving_alpha=0.3)

  def frames():
    for s in range(5):
      yield np.stack([raw, raw ^ s])

  outs = list(tisp.process_stream(frames(), gamma=0.8))
  jouts = list(jisp.process_stream(frames(), gamma=0.8))
  assert len(outs) == 5
  ref = ttit.Camera32(RGGB_T, device="cpu", moving_alpha=0.3)
  for o, jo, raws in zip(outs, jouts, frames()):
    assert torch.equal(o, ref.process(raws, gamma=0.8))
    d = np.abs(o.numpy().astype(int) - np.asarray(jo).astype(int))
    assert d.max() <= 1
  hwc = list(ttit.Camera32(RGGB_T, device="cpu", moving_alpha=0.3)
             .process_stream(frames(), prefetch=1, layout="hwc", gamma=0.8))
  for o, h in zip(outs, hwc):
    np.testing.assert_array_equal(np.moveaxis(o.numpy(), 1, -1), h)


# ------------------------------------------------ module functions

def test_module_tonemaps_match_jax():
  imgs = np.stack([make_test_rgb(24, 32, seed=s) for s in range(2)])
  prev = np.zeros(9, np.float32)
  m = tci.metering_update(torch.from_numpy(imgs), torch.from_numpy(prev),
                          0.0)
  mj = jci.metering_update(jnp.asarray(imgs), jnp.asarray(prev), 0.0)
  np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=0, atol=1e-5)
  m2 = tci.metering_update(torch.from_numpy(imgs * 0.5), m, 0.9)
  mj2 = jci.metering_update(jnp.asarray(imgs * 0.5), mj, 0.9)
  np.testing.assert_allclose(m2.numpy(), np.asarray(mj2), rtol=0, atol=1e-5)
  for args in ((1.0, 1.0, 1.0, 0.0), (0.9, 2.0, 0.8, 0.2)):
    a = tci.reinhard_apply(torch.from_numpy(imgs[0]), m, *args,
                           ttypes.f32)
    b = jci.reinhard_apply(jnp.asarray(imgs[0]), mj, *args, jtypes.f32)
    assert a.dtype == torch.uint8 and _maxdiff(a.numpy(), b) <= 1
    assert torch.equal(a, ttit.Camera32.reinhard_kernel(
        torch.from_numpy(imgs[0]), m, *args, ttypes.f32))
  for gamma in (1.0, 0.8):
    a = tci.linear_apply(torch.from_numpy(imgs), m, gamma)
    b = jci.linear_apply(jnp.asarray(imgs), mj, gamma)
    assert _maxdiff(a.numpy(), b) <= 1
    assert torch.equal(a, ttit.Camera16.linear_kernel(
        torch.from_numpy(imgs), m, gamma))
  assert tci.moving_average(None, 5.0, 0.1) == 5.0
  assert tci.moving_average(0.0, 10.0, 0.1) == pytest.approx(1.0)


def test_types_bounds_and_cache_match_jax():
  a = np.zeros((4, 5), np.uint16)
  b = ttypes.empty_like(a)
  assert b.shape == (4, 5) and b.dtype == np.uint16
  c = ttypes.zeros_like(a, shape=(2, 2), dtype=np.float32)
  assert c.shape == (2, 2) and c.dtype == np.float32 and c.sum() == 0
  for dt in ("float16", "bfloat16", "float32", "uint8", "uint16"):
    assert ttypes.is_float_dtype(dt) == jtypes.is_float_dtype(dt)
  bs = [tbounds.Bounds(0.2, 0.5), tbounds.Bounds(-1.0, 0.3)]
  u = tbounds.union_bounds(bs)
  assert (u.min, u.max) == (-1.0, 0.5)
  assert tbounds.union_bounds([]).min == np.inf
  np.testing.assert_array_equal(tbounds.bounds_to_np(u), [-1.0, 0.5])
  assert tbounds.bounds_from_np(np.array([1, 2])) == tbounds.Bounds(1.0, 2.0)
  img = make_test_rgb(8, 8)
  np.testing.assert_array_equal(
      tbounds.image_bounds(torch.from_numpy(img)).numpy(),
      np.asarray(jtit.utils.image_bounds(jnp.asarray(img))))
  from taichi_image_tpu_torch.utils.cache import cache
  calls = []

  @cache
  def f(x):
    calls.append(x)
    return x * 2

  assert f(2) == f(2) == 4 and calls == [2]


# ------------------------------------------------ debug mode

@pytest.mark.parametrize("nbytes,width,fmt", [
    (96 * 4 * 3 // 2, 96, "packed12"), (100, 96, "packed12"),
    (96 * 2 * 3, 96, "packed12"), (64 * 2 * 4, 64, "packed16"),
    (10, 5, "packed12"), (10, 5, "u16")])
def test_validate_raw_file_matches_jax(nbytes, width, fmt):
  try:
    want = jdebug.validate_raw_file(nbytes, width, fmt)
  except ValueError as e:
    with pytest.raises(ValueError) as got:
      tdebug.validate_raw_file(nbytes, width, fmt)
    assert str(got.value) == str(e)
  else:
    assert tdebug.validate_raw_file(nbytes, width, fmt) == want


def test_debug_mode(monkeypatch):
  raws = np.random.default_rng(9).integers(0, 256, (2, 16, 24),
                                           dtype=np.uint8)
  monkeypatch.delenv("TAICHI_IMAGE_TPU_DEBUG", raising=False)
  assert not tdebug.debug_enabled()
  b = ttit.Camera32(RGGB_T, device="cpu").process(raws)
  monkeypatch.setenv("TAICHI_IMAGE_TPU_DEBUG", "0")
  assert not tdebug.debug_enabled()
  monkeypatch.setenv("TAICHI_IMAGE_TPU_DEBUG", "1")
  assert tdebug.debug_enabled() == jdebug.debug_enabled()
  isp = ttit.Camera32(RGGB_T, device="cpu")
  assert torch.equal(isp.process(raws), b)  # clean input passes unchanged
  lazy = isp.tonemap_reinhard([isp.load_packed12(r) for r in raws])
  assert len(lazy) == 2
  with pytest.raises(tdebug.DebugCheckError, match="non-finite"):
    isp.process(np.full((2, 16, 24), np.nan, np.float32), fmt="f32")
  with pytest.raises(tdebug.DebugCheckError, match="escape"):
    tdebug.check_decoded(torch.tensor([0.5, 1.5]))
