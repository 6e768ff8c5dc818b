"""The large-frame API (``process_large`` / ``models/large.process_banded``):
the port against the JAX package's on the CPU, and every driver of the
port against the port's own ``process``.

Contracts:
  * the band plans (``band_plan``, ``band_plan_rows``, ``scan_band_size``,
    ``_fit_bands``) are the JAX package's, band for band;
  * against the JAX package's ``process_large`` on the same numpy raws
    (its band loop, tests/test_large.py's cases and sizes): metrics
    within 1e-5, u8 and I420 within 1 count on at most 5% of bytes (the
    bf16 class within 2: PyTorch's and XLA's CPU log2/exp2 differ by an
    f32 ulp, which a per-image max below 1 stretches past one count);
  * every driver ("auto", "flat", "loop", "scan") bitwise equal to the
    port's ``process``, metrics and output: the band starts lie on the
    metering grid, so the joined samples are the frame's sample and the
    max of the band maxima the frame's max;
  * the refusals the port keeps (an unknown driver, tonemap or
    color_format, an odd stride, "scan" or "flat" with a resize plan,
    "scan" without an equal-band plan) and the JAX package's TPU-only
    ones it drops ("flat" runs f16 and raw widths that are not a
    multiple of 384).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import taichi_image_tpu as jtit  # noqa: E402
import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu import types as jtypes  # noqa: E402
from taichi_image_tpu.models import large as jlarge  # noqa: E402
from taichi_image_tpu.models.camera_isp import camera_isp as jcamera_isp  # noqa: E402
from taichi_image_tpu.ops.interpolate import (  # noqa: E402
    ImageTransform as JTransform)
from taichi_image_tpu_torch.models import large  # noqa: E402
from taichi_image_tpu_torch.models.camera_isp import camera_isp  # noqa: E402
from taichi_image_tpu_torch.ops.interpolate import ImageTransform  # noqa: E402

CLASSES = {"Camera16": (jtit.Camera16, ttit.Camera16),
           "Camera32": (jtit.Camera32, ttit.Camera32),
           "CameraBF16": (jtit.CameraBF16, ttit.CameraBF16)}
DRIVERS = ("auto", "flat", "loop", "scan")


def _raws(n=2, h=64, w=96, seed=0):
  rng = np.random.default_rng(seed)
  return rng.integers(0, 256, size=(n, h, w * 3 // 2), dtype=np.uint8)


def _isps(cls_name, pattern="RGGB", **kw):
  """The JAX and the port's ISP of one class and configuration."""
  jcls, tcls = CLASSES[cls_name]
  jkw = dict(kw)
  if "transform" in kw:
    jkw["transform"] = JTransform[kw["transform"].name]
  return (jcls(jtit.BayerPattern[pattern], **jkw),
          tcls(ttit.BayerPattern[pattern], device="cpu", **kw))


def _outs(out):
  return out if isinstance(out, tuple) else (out,)


def _assert_close(got, want, max_count=1, share=0.05):
  """u8 within ``max_count`` on at most ``share`` of the bytes."""
  for g, w in zip(_outs(got), _outs(want), strict=True):
    a = np.asarray(g).astype(np.int64)
    b = np.asarray(w).astype(np.int64)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert d.max() <= max_count, d.max()
    assert (d != 0).mean() <= share, (d != 0).mean()


def _assert_same(got, want):
  for g, w in zip(_outs(got), _outs(want), strict=True):
    assert g.dtype == w.dtype and g.shape == w.shape
    assert torch.equal(g, w)


def _run_vs_jax(cls_name, isp_kw, proc_kw, n_frames=2, n_bands=2,
                driver="loop", raws_kw=None):
  """``process_large`` of the JAX package and of the port over the
  frames, the EMA carried over: the port held to the JAX package, and to
  its own ``process`` bitwise."""
  jisp, tisp = _isps(cls_name, moving_alpha=0.2, **isp_kw)
  ref = _isps(cls_name, moving_alpha=0.2, **isp_kw)[1]
  max_count = 2 if cls_name == "CameraBF16" else 1
  for seed in range(n_frames):
    raws = _raws(seed=seed, **(raws_kw or {}))
    want = jisp.process_large(raws, n_bands=n_bands, **proc_kw)
    got = tisp.process_large(raws, n_bands=n_bands, driver=driver,
                             **proc_kw)
    _assert_close(got, want, max_count)
    np.testing.assert_allclose(tisp.metrics.numpy(),
                               np.asarray(jisp.metrics), rtol=0, atol=1e-5)
    _assert_same(got, ref.process(raws, **proc_kw))
    assert torch.equal(tisp.metrics, ref.metrics)
  return got


# ------------------------------------------------------------- the plans

@pytest.mark.parametrize("hh,n_bands,stride", [
    (32, 4, 8), (2160, 8, 8), (36, 4, 8), (4, 16, 8), (2160, 4, 8),
    (1080, 8, 2), (519, 3, 6), (7, 2, 8), (96, 3, 14), (4320, 16, 16)])
def test_band_plan_is_jax(hh, n_bands, stride):
  assert large.band_plan(hh, n_bands, stride) == jlarge.band_plan(
      hh, n_bands, stride)


@pytest.mark.parametrize("n_rows,n_bands,q,q_fallback", [
    (1080, 3, 16, 8), (48, 3, 16, 8), (10, 4, 16, 4), (3, 2, 16, 4),
    (1081, 5, 32, None), (540, 7, 24, 12)])
def test_band_plan_rows_is_jax(n_rows, n_bands, q, q_fallback):
  assert large.band_plan_rows(n_rows, n_bands, q, q_fallback) == (
      jlarge.band_plan_rows(n_rows, n_bands, q, q_fallback))


@pytest.mark.parametrize("n_rows,n_bands,q", [
    (2160, 8, 16), (1080, 8, 16), (8, 4, 16), (32, 16, 16), (10080, 4, 16),
    (112, 2, 16), (4320, 16, 32), (960, 3, 48)])
def test_scan_band_size_is_jax(n_rows, n_bands, q):
  assert large.scan_band_size(n_rows, n_bands, q) == jlarge.scan_band_size(
      n_rows, n_bands, q)


def _fit(mod, hh, n_bands, stride=8):
  cap = mod._BAND_ROWS_MAX
  q = int(np.lcm(max(stride // 2, 1), 16))
  if hh < q:
    q = max(stride // 2, 1)
  return mod._fit_bands(-(-hh // cap), n_bands,
                        lambda n: mod.band_plan(hh, n, stride),
                        lambda plan: max(r1 - r0 for r0, r1 in plan),
                        n_max=max(1, hh // q))


@pytest.mark.parametrize("hh,n_bands,stride", [
    (2160, 4, 8), (2760, 4, 8), (600, 1, 600), (10080, 4, 8), (4320, 2, 8),
    (32, 4, 8)])
def test_fit_bands_is_jax(hh, n_bands, stride):
  assert _fit(large, hh, n_bands, stride) == _fit(jlarge, hh, n_bands,
                                                  stride)


def test_n_bands_clamped_to_the_band_bound():
  """tests/test_large.py's clamp cases on the port's plans: 8K at the
  default n_bands=4 runs 8 bands of <= _BAND_ROWS_MAX rows, the
  q-rounding overshoot and plateau are stepped over."""
  cap = large._BAND_ROWS_MAX
  n, plan = _fit(large, 2160, 4)
  assert n == 8 and all(r1 - r0 <= cap for r0, r1 in plan)
  assert large.scan_band_size(2160, n, 16) == 240
  n2, plan2 = _fit(large, 2760, 4)
  assert n2 > 10 and all(r1 - r0 <= cap for r0, r1 in plan2)
  n4, plan4 = _fit(large, 10080, 4)
  assert n4 == 38 and all(r1 - r0 <= cap for r0, r1 in plan4)


@pytest.mark.parametrize("resize", [False, True])
def test_band_rows_max_clamps_the_loop(monkeypatch, resize):
  """With the port's _BAND_ROWS_MAX cut to 16 phase rows, the loop runs
  more bands than asked (n_bands is a minimum), none over the bound, and
  still gives ``process``'s bits; the JAX package's loop, cut the same
  way, stays within its contract."""
  monkeypatch.setattr(large, "_BAND_ROWS_MAX", 16)
  monkeypatch.setattr(jlarge, "_BAND_ROWS_MAX", 16)
  spans = []
  band_x12 = large._band_x12

  def spy(raws, p0, p1, *a, **k):
    spans.append(p1 - p0)
    return band_x12(raws, p0, p1, *a, **k)

  monkeypatch.setattr(large, "_band_x12", spy)
  kw = dict(scale=0.5) if resize else {}
  got = _run_vs_jax("Camera32", kw, dict(gamma=0.8), n_frames=1, n_bands=1,
                    raws_kw=dict(h=96, w=96))
  assert len(spans) >= (2 if resize else 3) and max(spans) <= 16, spans
  assert got.shape == ((2, 3, 48, 48) if resize else (2, 3, 96, 96))


# ------------------------------------------- the port against the JAX package

@pytest.mark.parametrize("n_bands", [2, 3])
@pytest.mark.parametrize("cls_name", ["Camera32", "Camera16"])
def test_banded_matches_jax(cls_name, n_bands):
  _run_vs_jax(cls_name, {}, dict(gamma=0.8, intensity=0.9),
              n_bands=n_bands)


@pytest.mark.parametrize("driver", DRIVERS)
def test_bf16_drivers_match_jax(driver):
  _run_vs_jax("CameraBF16", {}, dict(gamma=0.8, intensity=0.9),
              n_bands=3, driver=driver)


def test_banded_with_ccm_and_pattern_matches_jax():
  _run_vs_jax("Camera32", dict(pattern="BGGR", correct_colors=True), {},
              n_frames=1, n_bands=4)


def test_banded_linear_tonemap_matches_jax():
  _run_vs_jax("Camera32", {}, dict(tonemap="linear", gamma=0.7),
              n_frames=1)


@pytest.mark.parametrize("cls_name", ["Camera32", "CameraBF16"])
def test_banded_yuv420_matches_jax(cls_name):
  _run_vs_jax(cls_name, {}, dict(color_format="yuv420"), n_frames=1)


@pytest.mark.parametrize("resize_kw", [dict(scale=0.5),
                                       dict(resize_width=60)],
                         ids=["scale", "width"])
def test_banded_resize_matches_jax(resize_kw):
  _run_vs_jax("Camera32", resize_kw, dict(gamma=0.8, intensity=0.9),
              n_bands=3, raws_kw=dict(h=96, w=96))


@pytest.mark.parametrize("transform", ["rotate_90", "flip_vert",
                                       "transverse"])
def test_banded_transform_matches_jax(transform):
  _run_vs_jax("Camera32", dict(transform=ImageTransform[transform]),
              dict(gamma=0.8), n_frames=1)


def test_banded_resize_transform_yuv_matches_jax():
  """tests/test_large.py's production composition: 96 rows -> x0.5 ->
  rotate_90 -> I420."""
  _run_vs_jax("Camera32", dict(scale=0.5,
                               transform=ImageTransform.rotate_90),
              dict(color_format="yuv420"), n_frames=1,
              raws_kw=dict(h=96, w=96))


def test_banded_resize_linear_matches_jax():
  _run_vs_jax("Camera32", dict(scale=0.5), dict(tonemap="linear",
                                                gamma=0.7),
              n_frames=1, raws_kw=dict(h=96, w=96))


@pytest.mark.parametrize("driver", ["auto", "loop"])
def test_banded_hwc_layout(driver):
  raws = _raws()
  isp = ttit.Camera32(ttit.BayerPattern.RGGB, device="cpu")
  out = isp.process_large(raws, n_bands=2, layout="hwc", driver=driver)
  assert isinstance(out, np.ndarray)
  assert out.shape == (2, 64, 96, 3) and out.dtype == np.uint8
  want = jtit.Camera32(jtit.BayerPattern.RGGB).process_large(
      raws, n_bands=2, layout="hwc")
  _assert_close(out, want)


def _fuzz_case(trial):
  """tests/test_large.py's fuzz draws, trial by trial (seed 7)."""
  rng = np.random.default_rng(7)
  patterns = list(jtit.BayerPattern)
  swap = ("rotate_90", "rotate_270", "transpose", "transverse")
  names = [t.name for t in JTransform]
  for i in range(trial + 1):
    n = int(rng.integers(1, 3))
    h = 16 * int(rng.integers(3, 8))
    w = 2 * int(rng.integers(24, 60))
    n_bands = int(rng.integers(2, 5))
    pat = patterns[int(rng.integers(0, 4))].name
    t = ("none" if rng.random() < 0.5 else names[int(rng.integers(0, 8))])
    resize_kw = {}
    eh, ew = h, w
    if rng.random() < 0.5:
      eh, ew = h // 2, w // 2
      resize_kw = dict(scale=0.5)
    cfmt = ("yuv420" if (rng.random() < 0.3 and eh % 2 == 0
                         and ew % 2 == 0) else "rgb")
    if t in swap:
      eh, ew = ew, eh
    if cfmt == "yuv420" and (eh % 2 or ew % 2):
      cfmt = "rgb"
  return n, h, w, n_bands, pat, t, resize_kw, cfmt, (eh, ew)


@pytest.mark.parametrize("trial", range(8))
def test_banded_shape_fuzz_matches_jax(trial):
  """The fuzz of tests/test_large.py (dtype x pattern x bands x resize x
  transform x color_format): the port's loop of the JAX class's dtype
  against the JAX package's process_large, and bitwise its own
  process."""
  n, h, w, n_bands, pat, t, resize_kw, cfmt, (eh, ew) = _fuzz_case(trial)
  jwd = [jtypes.f32, jtypes.f16, jtypes.bf16][trial % 3]
  twd = [torch.float32, torch.float16, torch.bfloat16][trial % 3]
  jisp = jcamera_isp(f"Fuzz{trial}", jwd)(
      jtit.BayerPattern[pat], transform=JTransform[t], **resize_kw)
  tcls = camera_isp(f"Fuzz{trial}", twd)
  tisp = tcls(ttit.BayerPattern[pat], transform=ImageTransform[t],
              device="cpu", **resize_kw)
  ref = tcls(ttit.BayerPattern[pat], transform=ImageTransform[t],
             device="cpu", **resize_kw)
  raws = _raws(n, h=h, w=w, seed=trial)
  want = jisp.process_large(raws, n_bands=n_bands, gamma=0.8,
                            color_format=cfmt)
  got = tisp.process_large(raws, n_bands=n_bands, gamma=0.8,
                           color_format=cfmt, driver="loop")
  if cfmt == "rgb":
    assert tuple(got.shape) == (n, 3, eh, ew)
  _assert_close(got, want, 2 if twd == torch.bfloat16 else 1)
  np.testing.assert_allclose(tisp.metrics.numpy(), np.asarray(jisp.metrics),
                             rtol=0, atol=1e-5)
  _assert_same(got, ref.process(raws, gamma=0.8, color_format=cfmt))


# ----------------------------------------- every driver is the port's process

_CONFIGS = {
    "main": ({}, {}),
    "ccm-gbrg": (dict(pattern="GBRG", correct_colors=True),
                 dict(gamma=2.2, intensity=1.3)),
    "color_adapt": ({}, dict(color_adapt=0.5, light_adapt=0.6)),
    "linear": ({}, dict(tonemap="linear", gamma=0.7)),
    "yuv420": ({}, dict(color_format="yuv420")),
    "stride-4": (dict(metering_stride=4), {}),
    "ids": ({}, dict(ids_format=True)),
}


@pytest.mark.parametrize("driver", DRIVERS)
@pytest.mark.parametrize("config", _CONFIGS)
@pytest.mark.parametrize("cls_name", CLASSES)
def test_every_driver_is_process(cls_name, config, driver):
  """Two frames with the EMA carried over, 6 bands asked (n_bands is a
  minimum; the plan gives what the rows allow)."""
  isp_kw, proc_kw = _CONFIGS[config]
  tcls = CLASSES[cls_name][1]
  pattern = ttit.BayerPattern[isp_kw.pop("pattern", "RGGB")]
  a = tcls(pattern, device="cpu", moving_alpha=0.3, **isp_kw)
  b = tcls(pattern, device="cpu", moving_alpha=0.3, **isp_kw)
  for seed in (3, 4):
    raws = _raws(2, h=160, w=100, seed=seed)
    _assert_same(b.process_large(raws, n_bands=6, driver=driver, **proc_kw),
                 a.process(raws, **proc_kw))
    assert torch.equal(a.metrics, b.metrics)


@pytest.mark.parametrize("transform", list(ImageTransform),
                         ids=lambda t: t.name)
@pytest.mark.parametrize("color_format", ["rgb", "yuv420"])
@pytest.mark.parametrize("resize", [False, True])
def test_loop_under_every_transform_is_process(resize, color_format,
                                               transform):
  """The bands joined where the transform puts them: along the rows or
  the columns, reversed where it flips the input's rows."""
  kw = dict(scale=0.5) if resize else {}
  a = ttit.CameraBF16(ttit.BayerPattern.RGGB, transform=transform,
                      device="cpu", **kw)
  b = ttit.CameraBF16(ttit.BayerPattern.RGGB, transform=transform,
                      device="cpu", **kw)
  raws = _raws(2, h=128, w=72, seed=9)
  _assert_same(b.process_large(raws, n_bands=3, driver="loop",
                               color_format=color_format),
               a.process(raws, color_format=color_format))


@pytest.mark.parametrize("fmt", ["packed16", "u16", "f16", "f32"])
def test_loop_every_raw_format_is_process(fmt):
  """Each raw format's band rows (zero halo rows at the image edges,
  uint16 moved through its int16 bits) decode to the frame's phases."""
  rng = np.random.default_rng(5)
  cfa = rng.integers(0, 65536, size=(2, 96, 80), dtype=np.uint16)
  raws = {"packed16": cfa.view(np.uint8), "u16": cfa,
          "f16": (cfa / 65535.0).astype(np.float16),
          "f32": (cfa / 65535.0).astype(np.float32)}[fmt]
  a = ttit.Camera16(ttit.BayerPattern.BGGR, device="cpu")
  b = ttit.Camera16(ttit.BayerPattern.BGGR, device="cpu")
  for _ in range(2):
    _assert_same(b.process_large(raws, n_bands=3, fmt=fmt, driver="loop"),
                 a.process(raws, fmt=fmt))
    assert torch.equal(a.metrics, b.metrics)


@pytest.mark.parametrize("given", ["numpy", "cpu-tensor"])
def test_process_banded_functional_form(given):
  """``process_banded`` called as the JAX package's is (numpy raws and
  prev, moved to ``device``), or with raws already a tensor (taken on its
  own device whatever ``device`` says): the port's ``fused_isp_step``'s
  bits for every driver."""
  from taichi_image_tpu_torch.models.camera_isp import fused_isp_step
  raws = _raws(2, h=128, w=96, seed=11)
  prev = np.linspace(0.1, 0.9, 9).astype(np.float32)
  kw = dict(n_bands=2, work_dtype=torch.bfloat16,
            pattern=ttit.BayerPattern.GRBG, gamma=0.9, intensity=1.5)
  if given == "numpy":
    kw["device"] = "cpu"
  want_m, want = fused_isp_step(
      torch.from_numpy(raws), torch.from_numpy(prev), 0.7, 0.9, 1.5, 1.0,
      0.0, "packed12", False, torch.bfloat16, ttit.BayerPattern.GRBG, None,
      None, 8, ImageTransform.none, "reinhard")
  src = raws if given == "numpy" else torch.from_numpy(raws)
  for driver in DRIVERS:
    m, out = large.process_banded(src, prev, 0.7, driver=driver, **kw)
    assert out.device.type == "cpu", driver
    assert torch.equal(m, want_m) and torch.equal(out, want), driver


def test_process_banded_moves_arrays_to_the_card():
  """Host arrays go to the card unless the caller asks for the CPU, as
  the port's other entry points do."""
  import inspect
  assert inspect.signature(large.process_banded).parameters[
      "device"].default == "cuda"


# ----------------------------------------------------------- the refusals

def _banded(driver="auto", raws=None, **kw):
  args = dict(n_bands=2, work_dtype=torch.bfloat16,
              pattern=ttit.BayerPattern.RGGB)
  args.update(kw)
  return large.process_banded(_raws(2, h=64, w=96) if raws is None else raws,
                              np.zeros(9, np.float32), 0.0, driver=driver,
                              device="cpu", **args)


@pytest.mark.parametrize("kw,match", [
    (dict(driver="warp"), "driver"),
    (dict(tonemap="aces"), "unknown tonemap"),
    (dict(color_format="nv12"), "unknown color_format"),
    (dict(stride=7), "even metering stride"),
    (dict(driver="scan", resize_plan=((48, 32), None)), "scan driver"),
    (dict(driver="flat", resize_plan=((48, 32), None)), "flat driver"),
    (dict(driver="scan", raws=_raws(1, h=224, w=96), n_bands=1,
          stride=2 * 41), "scan driver"),
    (dict(driver="loop", raws=_raws(1, h=2, w=96)), "at least 4x4"),
], ids=["driver", "tonemap", "color_format", "odd-stride", "scan-resize",
        "flat-resize", "scan-no-plan", "loop-tiny"])
def test_misuse_raises(kw, match):
  with pytest.raises(ValueError, match=match):
    _banded(**kw)


def test_jax_refuses_what_the_port_refuses():
  """The port keeps the JAX package's refusals that are not about the
  TPU's kernels: the same inputs raise there too."""
  prev = np.zeros(9, np.float32)
  kw = dict(n_bands=2, work_dtype=jtypes.bf16, pattern=jtit.BayerPattern.RGGB)
  for extra, match in ((dict(driver="warp"), "driver"),
                       (dict(driver="scan", resize_plan=((48, 32), None)),
                        "scan driver"),
                       (dict(driver="flat", resize_plan=((48, 32), None)),
                        "flat driver"),
                       (dict(stride=7), "even metering stride")):
    with pytest.raises(ValueError, match=match):
      jlarge.process_banded(_raws(2, h=64, w=96), prev, 0.0, **kw, **extra)


@pytest.mark.parametrize("case", ["f16", "width-96"])
def test_flat_runs_what_the_jax_package_refuses(case):
  """The JAX package refuses "flat" for an f16 working dtype and for raw
  widths its kernels cannot tile (not a multiple of 384 bytes), reasons
  of the TPU's kernels; the port's flat driver is its whole-frame step,
  which runs both, with ``process``'s bits."""
  jwd, twd, w = ((jtypes.f16, torch.float16, 256) if case == "f16"
                 else (jtypes.bf16, torch.bfloat16, 96))
  raws = _raws(2, h=64, w=w, seed=2)
  with pytest.raises(ValueError, match="flat driver"):
    jlarge.process_banded(raws, np.zeros(9, np.float32), 0.0, n_bands=2,
                          work_dtype=jwd, pattern=jtit.BayerPattern.RGGB,
                          driver="flat")
  cls = camera_isp(f"Flat{case}", twd)
  a = cls(ttit.BayerPattern.RGGB, device="cpu")
  b = cls(ttit.BayerPattern.RGGB, device="cpu")
  _assert_same(b.process_large(raws, driver="flat"), a.process(raws))
