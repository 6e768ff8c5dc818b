"""M, the metering kernel's plain twin (``ops/hopper/meter.py``), against
the JAX package on the CPU, and its wrapper's launches.

Contracts:
  * the twin against JAX's ``metering_update_ca`` + ``reinhard_scal`` /
    ``reinhard_scal_ca`` + the linear ``[m0, 1 / (m1 - m0)]``, for each
    working dtype, four sample sources (the stencil's contiguous sample,
    the resize route's strided view, ``x12[:, 0:3]``'s strided view, the
    odd stride's gather), t in {0, 0.9} and color_adapt in {0, 0.5}:
    vec9 within 1e-5, the vectors within 1e-5 relative (PyTorch's and
    XLA's CPU sums run in other orders); a strided view bitwise its
    contiguous copy; the stride-7 bf16 step against JAX's under
    tests/test_torch_resize.py's ``compare_step``;
  * the group twin on 2 gloo ranks against JAX's ``axis_name`` path (a
    ``vmap`` over the two shards): the same contract, every rank the same
    bits;
  * the wrapper: its argument checks, ``backend="kernel"`` on the CPU
    raising before any launch, and (with the launcher recorded) the
    launches and collectives it makes: one launch without a group, three
    and the three all_reduce calls with one; without a group, on a device
    whose SMs (stubbed) cannot hold the plan's grid at BLOCKS_PER_SM
    each, the split form's three launches and no collective; the SM count
    asked once a device index; its launch block made once a layout;
  * the launch plan: a function of the shape and dtype alone, within the
    grid's cap, at the chip_smoke shapes; and a Python emulation of the
    kernel's division-free walk visiting each run of the sample once, at
    its own offset, for contiguous samples and strided views.
"""

import ctypes
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu.models import camera_isp as jci  # noqa: E402
from taichi_image_tpu.ops.pallas import reinhard as pl_rh  # noqa: E402
from taichi_image_tpu_torch import parallel  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops import bayer as tbayer  # noqa: E402
from taichi_image_tpu_torch.ops import hopper  # noqa: E402
from taichi_image_tpu_torch.ops.hopper import meter as th_meter  # noqa: E402
from taichi_image_tpu_torch.parallel import dryrun  # noqa: E402
from test_torch_resize import route_vs_jax  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
SOURCES = ("stencil", "resize_view", "x12_view", "gather")
INTENSITY, LIGHT_ADAPT = 1.3, 0.7


def _raws(seed, n=2, h=64, wb=1152):
  return np.random.default_rng(seed).integers(0, 256, size=(n, h, wb),
                                              dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _sample(dtype_name, source, seed=0):
  """A metering sample of the port's CPU route, as the step makes it:
  the stencil's (stride 8), the x0.5 resize's strided view, x12's strided
  view, or the stride-7 gather."""
  wd = DTYPES[dtype_name]
  phases = tci.load_raw_phases(torch.from_numpy(_raws(seed)), "packed12", wd)
  x12, samp = tci.demosaic_phases(phases, tbayer.BayerPattern.RGGB,
                                  out_dtype=wd, sample_step=4)
  if source == "stencil":
    return samp
  if source == "resize_view":
    rgb = tci._resize_x12(x12, (384, 32), 0.5, wd)
    return tbayer.subsample_hw(rgb, 8, 8)
  if source == "x12_view":
    return tbayer.subsample_hw(x12[:, 0:3], 4, 4)
  return tbayer.planar_subsample(x12, 7)


def _prev(t):
  """The previous vec9: zeros for t = 0, else a metering of another
  frame (as the EMA carries it)."""
  if t == 0.0:
    return np.zeros(9, np.float32)
  return np.array(jci.metering_update_ca(
      jnp.asarray(_sample("f32", "stencil", seed=9).float().numpy()),
      jnp.zeros(9, jnp.float32), 0.0))


def _jax_vectors(m, ca):
  scal = (pl_rh.reinhard_scal_ca(m, INTENSITY, LIGHT_ADAPT, ca) if ca
          else pl_rh.reinhard_scal(m, INTENSITY, LIGHT_ADAPT))
  return np.asarray(scal), np.asarray(jnp.stack([m[0], 1.0 / (m[1] - m[0])]))


def _check(got, m_jax, ca):
  """``got`` (a Metering, numpy or torch) against JAX's vec9 ``m_jax`` and
  its vectors."""
  metrics, scal, lin = (np.asarray(v) for v in got)
  np.testing.assert_allclose(metrics, np.asarray(m_jax), rtol=0, atol=1e-5)
  scal_j, lin_j = _jax_vectors(m_jax, ca)
  assert scal.shape == scal_j.shape == ((10,) if ca else (6,))
  np.testing.assert_allclose(scal, scal_j, rtol=1e-5, atol=0)
  np.testing.assert_allclose(lin, lin_j, rtol=1e-5, atol=0)


@pytest.mark.parametrize("ca", [0.0, 0.5], ids=["ca0", "ca0.5"])
@pytest.mark.parametrize("t", [0.0, 0.9], ids=["t0", "t0.9"])
@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_meter_twin_matches_jax(dtype, source, t, ca):
  x = _sample(dtype, source)
  prev = _prev(t)
  got = th_meter.meter(x, torch.from_numpy(prev), t, INTENSITY, LIGHT_ADAPT,
                       ca)
  m_jax = jci.metering_update_ca(jnp.asarray(x.float().numpy()),
                                 jnp.asarray(prev), t)
  _check(got, m_jax, ca)
  # the strided views read as they lie: the same bits as a copy
  same = th_meter.meter(x.contiguous(), torch.from_numpy(prev), t,
                        INTENSITY, LIGHT_ADAPT, ca)
  for a, b in zip(got, same):
    assert torch.equal(a, b)


@pytest.mark.parametrize("ca", [0.0, 0.5], ids=["ca0", "ca0.5"])
def test_stride7_bf16_route_matches_jax(ca):
  """The stride-7 bf16 route, whose map's bf16 rounding is the most
  sensitive to the metering's last bits: the port's step, with the sums
  in f64, against JAX's step, with its f32 sums, under compare_step's
  contract, at these tests' largest raws and three frames of EMA."""
  route_vs_jax("CameraBF16", [_raws(300 + f) for f in range(3)], stride=7,
               color_adapt=ca)


def test_meter_returns_metering_update_ca():
  x = _sample("bf16", "stencil")
  got = th_meter.meter(x, torch.zeros(9), 0.0)
  assert torch.equal(got.metrics, tci.metering_update_ca(x, torch.zeros(9),
                                                         0.0))
  assert torch.equal(got.scal, th_meter.reinhard_scal(got.metrics, 1.0, 1.0))
  assert torch.equal(got.lin, th_meter.linear_scal(got.metrics))


def test_vectors_twin_matches_jax():
  m = np.array(jci.metering_update_ca(
      jnp.asarray(_sample("f32", "gather").numpy()), jnp.zeros(9), 0.0))
  for ca in (0.0, 0.5):
    scal, lin = th_meter.vectors(torch.from_numpy(m), INTENSITY, LIGHT_ADAPT,
                                 ca)
    scal_j, lin_j = _jax_vectors(jnp.asarray(m), ca)
    np.testing.assert_allclose(scal.numpy(), scal_j, rtol=1e-5, atol=0)
    np.testing.assert_allclose(lin.numpy(), lin_j, rtol=1e-5, atol=0)


# ------------------------------------------------------------ the group

GROUP_CASES = [(d, t, ca) for d in DTYPES for t in (0.0, 0.9)
               for ca in (0.0, 0.5)]


def _case_name(d, t, ca):
  return f"{d} t={t} ca={ca}"


@pytest.fixture(scope="module")
def group_results():
  """Every case's metering on 2 gloo ranks (one spawn), each rank metering
  its camera of the stencil's sample."""
  variants = [dict(name=_case_name(d, t, ca), kind="meter",
                   sample=_sample(d, "stencil").float().numpy(),
                   dtype=str(DTYPES[d]).removeprefix("torch."),
                   prev=_prev(t), t=t, intensity=INTENSITY,
                   light_adapt=LIGHT_ADAPT, color_adapt=ca)
              for d, t, ca in GROUP_CASES]
  return parallel.run_ranks(dryrun.run_variants, 2, variants)


@pytest.mark.parametrize("case", GROUP_CASES,
                         ids=[_case_name(*c) for c in GROUP_CASES])
def test_meter_group_twin_matches_jax_axis_name(group_results, case):
  d, t, ca = case
  x = _sample(d, "stencil").float().numpy()
  prev = _prev(t)
  n_total = x.shape[0] * x.shape[2] * x.shape[3]
  shards = jnp.asarray(x.reshape(2, 1, *x.shape[1:]))
  m_jax = jax.vmap(lambda s: jci.metering_update_ca(
      s, jnp.asarray(prev), t, axis_name="ranks", n_total=n_total),
                   axis_name="ranks")(shards)
  np.testing.assert_array_equal(m_jax[0], m_jax[1])
  r0, r1 = (next(r for r in rank if r["name"] == _case_name(*case))
            for rank in group_results)
  for f in th_meter.Metering._fields:
    np.testing.assert_array_equal(r0[f], r1[f])
  _check([r0[f] for f in th_meter.Metering._fields], m_jax[0], ca)
  # and the ungrouped twin on the whole sample, within its rounding
  whole = th_meter.meter(torch.from_numpy(x).to(DTYPES[d]),
                         torch.from_numpy(prev), t, INTENSITY, LIGHT_ADAPT,
                         ca)
  np.testing.assert_allclose(r0["metrics"], whole.metrics.numpy(), rtol=0,
                             atol=1e-6)


# ------------------------------------------------------------ the wrapper

def test_meter_refuses_bad_arguments():
  x = torch.zeros(2, 3, 4, 5)
  with pytest.raises(ValueError, match=r"\(N, C >= 3, hs, ws\)"):
    th_meter.meter(torch.zeros(3, 4, 5), torch.zeros(9), 0.0)
  with pytest.raises(ValueError, match=r"\(N, C >= 3, hs, ws\)"):
    th_meter.meter(torch.zeros(2, 2, 4, 5), torch.zeros(9), 0.0)
  with pytest.raises(ValueError, match="empty"):
    th_meter.meter(torch.zeros(2, 3, 0, 5), torch.zeros(9), 0.0)
  with pytest.raises(ValueError, match=r"prev must be \(9,\)"):
    th_meter.meter(x, torch.zeros(8), 0.0)
  with pytest.raises(ValueError, match="n_total"):
    th_meter.meter(x, torch.zeros(9), 0.0, n_total=0)
  with pytest.raises(ValueError, match="t must be a scalar"):
    th_meter.meter(x, torch.zeros(9), torch.zeros(2), backend="plain")
  with pytest.raises(ValueError, match=r"\(9,\) tensor"):
    th_meter.vectors(torch.zeros(8))


@pytest.mark.parametrize("dtype", DTYPES)
def test_meter_kernel_backend_on_cpu_raises(dtype):
  before = hopper.launch_counts()
  x = torch.zeros(2, 3, 4, 5, dtype=DTYPES[dtype])
  with pytest.raises(ValueError, match="needs CUDA tensors"):
    th_meter.meter(x, torch.zeros(9), 0.0, backend="kernel")
  with pytest.raises(ValueError, match="needs CUDA tensors"):
    th_meter.vectors(torch.zeros(9), backend="kernel")
  assert hopper.launch_counts() == before


class _Recorder:
  """Stands in for the launchers and all_reduce on the CPU: records each
  call's arguments, in order. The device has ``sms`` SMs (a whole H100's
  by default); with ``sms=None`` the wrapper asks torch for them."""

  def __init__(self, monkeypatch, sms=132):
    self.calls = []
    monkeypatch.setattr(hopper, "use_kernel", lambda backend, x: True)
    if sms is not None:
      monkeypatch.setattr(th_meter, "_sms", lambda device: sms)
    monkeypatch.setattr(th_meter, "_scratch",
                        lambda device: torch.zeros(th_meter.SCRATCH_BYTES,
                                                   dtype=torch.uint8))
    for name, k in [*th_meter.KERNELS.items(), ("vectors", th_meter.VECTORS)]:
      monkeypatch.setattr(k, "launch", functools.partial(self.launch, name))
    monkeypatch.setattr(th_meter.dist, "all_reduce", self.all_reduce)

  def launch(self, name, device, *args):
    self.calls.append(("launch", name, args))

  def all_reduce(self, t, op, group):
    self.calls.append(("all_reduce", op, t.data_ptr(), t.numel()))


def _ptr(v):
  return None if v is None else int(v)


@pytest.mark.parametrize("grouped", [False, True], ids=["no group", "group"])
def test_meter_launches(monkeypatch, grouped):
  rec = _Recorder(monkeypatch)
  base = torch.zeros(2, 3, 40, 56, dtype=torch.float16)
  x = base[:, :, ::4, ::8]  # a strided view: (2, 3, 10, 7)
  got = th_meter.meter(x, torch.zeros(9), 0.9, INTENSITY, LIGHT_ADAPT, 0.5,
                       group="the group" if grouped else None,
                       n_total=280 if grouped else None)
  out = got.metrics
  assert got.scal.shape == (10,) and got.lin.shape == (2,)
  assert got.scal.data_ptr() == out.data_ptr() + 9 * 4
  assert got.lin.data_ptr() == out.data_ptr() + 19 * 4
  launches = [c for c in rec.calls if c[0] == "launch"]
  assert [c[1] for c in launches] == [torch.float16] * (3 if grouped else 1)
  phases = [c[2][-1] for c in launches]
  assert phases == ([th_meter._BOUNDS, th_meter._STATS, th_meter._FINALIZE]
                    if grouped else [th_meter._FUSED])
  p = th_meter.plan((2, 3, 10, 7), torch.float16)
  for _, _, a in launches:
    assert a[0] == base.data_ptr()
    # the launch block: the shape, the strides and the plan
    block = np.ctypeslib.as_array(
        ctypes.cast(a[1], ctypes.POINTER(ctypes.c_int64)), (11,))
    assert block.tolist() == [2, 3, 10, 7, 6720, 2240, 224, 8, p.per_block,
                              p.grid, int(p.cached)]
    assert _ptr(a[3]) is None and a[4] == pytest.approx(0.9)  # host t
    assert _ptr(a[9]) == out.data_ptr()
    assert a[10] == (280.0 if grouped else 140.0)
    assert a[11:15] == (pytest.approx(INTENSITY), pytest.approx(LIGHT_ADAPT),
                        0.5, 1)
  if not grouped:
    # one launch, no exchange buffers, no collective
    assert all(_ptr(v) is None for v in launches[0][2][6:9])
    assert len(rec.calls) == 1
    return
  kinds = [c[0] if c[0] == "launch" else c[1] for c in rec.calls]
  assert kinds == ["launch", th_meter.dist.ReduceOp.MAX, "launch",
                   th_meter.dist.ReduceOp.MAX, th_meter.dist.ReduceOp.SUM,
                   "launch"]
  mm, lb, sums = (_ptr(launches[0][2][i]) for i in (6, 7, 8))
  assert [c[2:] for c in rec.calls if c[0] == "all_reduce"] == [
      (mm, 2), (lb, 2), (sums, 5)]
  for _, _, a in launches:  # the same exchange buffers in every phase
    assert [_ptr(v) for v in a[6:9]] == [mm, lb, sums]


# Samples whose form depends on the device's SMs: (N, C, hs, ws) and
# plan()'s grid in bf16, f16 and f32 (the main path's stride-8 sample at
# 6x4K, the 6x8K whole frame's, the stride-8 sample at 6x1080p)
FORM_SAMPLES = {"6x4K stride 8": ((6, 3, 270, 480), (380, 380, 456)),
                "6x8K whole frame": ((6, 3, 540, 1440), (456, 456, 456)),
                "6x1080p stride 8": ((6, 3, 135, 240), (95, 95, 190))}
SM_COUNTS = (16, 24, 94, 95, 113, 114, 132)


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sample", FORM_SAMPLES)
def test_meter_form_follows_the_device(monkeypatch, sample, dtype, sms):
  """Without a group the wrapper takes the one cooperative launch exactly
  where the plan's grid fits BLOCKS_PER_SM blocks on each of the device's
  SMs, and otherwise the split form: bounds, stats and finalize on the
  same exchange buffers, with no all_reduce, the sample's own pixel count
  as n_total, and the same launch block as the cooperative launch."""
  rec = _Recorder(monkeypatch, sms=sms)
  wd = DTYPES[dtype]
  shape, grids = FORM_SAMPLES[sample]
  grid = grids[list(DTYPES).index(dtype)]
  assert th_meter.plan(shape, wd).grid == grid
  x = torch.zeros((), dtype=wd).expand(shape)  # the plan reads the shape
  th_meter.meter(x, torch.zeros(9), 0.9, INTENSITY, LIGHT_ADAPT, 0.5)
  assert all(c[0] == "launch" and c[1] == wd for c in rec.calls)
  phases = [c[2][-1] for c in rec.calls]
  if grid <= th_meter.BLOCKS_PER_SM * sms:
    assert phases == [th_meter._FUSED]
    assert all(_ptr(v) is None for v in rec.calls[0][2][6:9])
  else:
    assert phases == [th_meter._BOUNDS, th_meter._STATS, th_meter._FINALIZE]
    exchange = [[_ptr(v) for v in c[2][6:9]] for c in rec.calls]
    assert None not in exchange[0] and len(set(exchange[0])) == 3
    assert exchange == [exchange[0]] * 3
  n, _, hs, ws = shape
  for _, _, a in rec.calls:
    assert a[10] == float(n * hs * ws)
    block = np.ctypeslib.as_array(
        ctypes.cast(a[1], ctypes.POINTER(ctypes.c_int64)), (11,))
    assert block[9] == grid


def test_meter_sms_are_asked_once_a_device(monkeypatch):
  """The SM count is cached per device index: two devices of different
  counts (stubbed) give the 6x4K bf16 sample (380 blocks) different
  forms, each device's count asked of torch once."""
  rec = _Recorder(monkeypatch, sms=None)
  sms = {0: 132, 1: 16}
  asked, current = [], [0]

  def properties(index):
    asked.append(index)
    return types.SimpleNamespace(multi_processor_count=sms[index])
  monkeypatch.setattr(th_meter, "_SMS", {})
  monkeypatch.setattr(th_meter.torch.cuda, "get_device_properties",
                      properties)
  monkeypatch.setattr(th_meter.torch.cuda, "current_device",
                      lambda: current[0])
  x = torch.zeros((), dtype=torch.bfloat16).expand(6, 3, 270, 480)
  forms = []
  for index in (0, 1, 0, 1):
    current[0] = index
    rec.calls.clear()
    th_meter.meter(x, torch.zeros(9), 0.0)
    forms.append([c[2][-1] for c in rec.calls])
  fused, split = [th_meter._FUSED], [th_meter._BOUNDS, th_meter._STATS,
                                     th_meter._FINALIZE]
  assert forms == [fused, split, fused, split]
  assert asked == [0, 1]
  assert th_meter._sms(torch.device("cuda", 1)) == 16
  assert th_meter._sms(torch.device("cuda", 0)) == 132
  assert asked == [0, 1] and th_meter._SMS == sms


def test_meter_launches_other_dtypes_as_f32(monkeypatch):
  rec = _Recorder(monkeypatch)
  th_meter.meter(torch.zeros(1, 3, 4, 4, dtype=torch.uint8), torch.zeros(9),
                 torch.tensor(0.5))
  assert [c[1] for c in rec.calls] == [torch.float32]
  assert rec.calls[0][2][4] == 0.5  # a CPU tensor's t is a host number


def test_meter_launch_block_is_cached(monkeypatch):
  """The launcher's shape-dependent argument is made once a layout
  (shape, strides, dtype): a second tensor of the same layout, wherever
  its data lie, passes the same block; another layout its own."""
  rec = _Recorder(monkeypatch)
  base = torch.zeros(2, 3, 20, 33)
  for x in (base, base.clone(), base[..., 1:], base[..., :32],
            base[..., ::2]):
    th_meter.meter(x, torch.zeros(9), 0.0)
  blocks = [c[2][1].value for c in rec.calls]
  assert blocks[0] == blocks[1] and blocks[2] == blocks[3]
  assert len(set(blocks)) == 3


# ------------------------------------------------------------ the plan

# (N, C, hs, ws) samples: the main path's stride-8 sample at 6x4K, the x0.5
# resize's strided view there, the 6x8K whole frame's, chunks that end
# mid-row, ws not a multiple of any run, one pixel, one column, one row
PLAN_SHAPES = [(6, 3, 270, 480), (6, 3, 135, 240), (6, 3, 540, 1440),
               (3, 3, 301, 1000), (4, 3, 37, 1001), (1, 3, 1, 1),
               (5, 3, 700, 1), (2, 4, 1, 3000), (2, 3, 129, 251)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_plan_depends_on_the_shape_alone(shape, dtype):
  """The partition is a function of the shape and the dtype: the same for
  a view, its copy and the band loop's joined samples; it never exceeds
  the grid's cap, gives every block at least THREADS runs (or all of them)
  and every block some, and caches a block's runs only where they fit."""
  wd = DTYPES[dtype]
  p = th_meter.plan(shape, wd)
  n, c, hs, ws = shape
  assert p.run == 16 // wd.itemsize
  assert p.runs == n * hs * -(-ws // p.run)
  assert 1 <= p.grid <= th_meter.MAX_GRID
  assert p.per_block >= min(th_meter.THREADS, p.runs)
  assert (p.grid - 1) * p.per_block < p.runs <= p.grid * p.per_block
  assert p.cached == (3 * p.per_block * 16 <= th_meter.CACHE_BYTES)
  assert th_meter.MAX_GRID == th_meter.BLOCKS_PER_SM * 114
  assert th_meter.SCRATCH_BYTES == 64 + th_meter.MAX_GRID * 48
  big = torch.zeros(n, c + 2, hs + 1, 2 * ws + 3, dtype=wd)
  view = big[:, 1:c + 1, 1:, 3::2]
  assert view.shape == shape
  bands = torch.cat([view[:, :, :hs // 2], view[:, :, hs // 2:]], dim=2)
  for other in (view, view.contiguous(), bands):
    assert th_meter.plan(other.shape, other.dtype) == p
    ptr, grid = th_meter._launch_block(other)
    assert grid == p.grid
    blk = np.ctypeslib.as_array(ctypes.cast(
        ptr, ctypes.POINTER(ctypes.c_int64)), (11,))
    assert blk.tolist() == [*shape, *other.stride(), p.per_block, p.grid,
                            int(p.cached)]


def test_plan_at_the_main_shapes():
  """The plan each chip_smoke shape takes: at 6x4K the stride-8 sample
  gives each thread at most one run (bf16/f16) or two (f32) and keeps
  them in shared memory; the 6x8K whole frame's sample fills the grid
  and takes the second pass from device memory."""
  main = (6, 3, 270, 480)
  assert th_meter.plan(main, torch.bfloat16) == (8, 97200, 256, 380, True)
  assert th_meter.plan(main, torch.float16) == (8, 97200, 256, 380, True)
  assert th_meter.plan(main, torch.float32) == (4, 194400, 427, 456, True)
  big = (6, 3, 540, 1440)
  assert th_meter.plan(big, torch.bfloat16) == (8, 583200, 1279, 456, False)
  assert th_meter.plan(big, torch.float32) == (4, 1166400, 2558, 456, False)
  assert th_meter.plan((1, 3, 1, 1), torch.float32) == (4, 1, 256, 1, True)


def _walk(shape, strides, dtype):
  """csrc/meter.cu's walk in Python (geometry, cursor_at, advance,
  run_len): {run index: (block, thread, the thread's step, offset of the
  run's first value of channel 0, pixels)} of every run the threads
  visit, each thread starting at its first run and advancing THREADS runs
  a step by the launcher's constants, with no division."""
  n, _, hs, ws = shape
  s0, _, s2, s3 = strides
  p = th_meter.plan(shape, dtype)
  nt, run = th_meter.THREADS, p.run
  rpr = -(-ws // run)
  last = ws - (rpr - 1) * run
  rows = nt // rpr
  dx, dy, dn = nt % rpr, rows % hs, rows // hs
  x_step, x_wrap = dx * run * s3, s2 - rpr * run * s3
  y_step, y_wrap = dy * s2 + dn * s0, s0 - hs * s2
  seen = {}
  for b in range(p.grid):
    r0 = b * p.per_block
    r1 = min(p.runs, r0 + p.per_block)
    for t in range(min(nt, r1 - r0)):
      count = (r1 - r0 - t + nt - 1) // nt
      r = r0 + t
      row = r // rpr
      im = row // hs
      x, y = r - row * rpr, row - im * hs
      off = im * s0 + y * s2 + x * run * s3
      for i in range(count):
        assert r0 + t + i * nt not in seen
        seen[r0 + t + i * nt] = (b, t, i, off, last if x == rpr - 1 else run)
        x += dx
        off += x_step
        if x >= rpr:
          x -= rpr
          off += x_wrap
          y += 1
        y += dy
        off += y_step
        if y >= hs:
          y -= hs
          off += y_wrap
  return p, seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", PLAN_SHAPES[3:],
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES[3:]])
def test_walk_visits_each_run_once_in_order(shape, dtype):
  """Every run of the sample is visited once, by the block that owns it,
  and the walk's offset and length are the run's own (computed here with
  divisions), for a contiguous sample and a strided view: so the kernel's
  two passes take every pixel once, a thread in run order."""
  wd = DTYPES[dtype]
  n, c, hs, ws = shape
  big = torch.zeros(n, c + 1, hs + 2, 3 * ws, dtype=wd)
  for x in (big[:, :c, :hs, :ws].contiguous(), big[:, 1:, 2:, ::3]):
    p, seen = _walk(shape, x.stride(), wd)
    assert sorted(seen) == list(range(p.runs))
    rpr = -(-ws // p.run)
    s0, _, s2, s3 = x.stride()
    for r, (b, t, i, off, length) in seen.items():
      row, xr = divmod(r, rpr)
      im, y = divmod(row, hs)
      assert b == r // p.per_block and r == b * p.per_block + t + i * 256
      assert off == im * s0 + y * s2 + xr * p.run * s3
      assert length == min(p.run, ws - xr * p.run)


def test_vectors_launch(monkeypatch):
  rec = _Recorder(monkeypatch)
  m = torch.arange(9, dtype=torch.float32)
  scal, lin = th_meter.vectors(m, INTENSITY, LIGHT_ADAPT, 0.0)
  assert scal.shape == (6,) and lin.shape == (2,)
  (kind, name, args), = rec.calls
  assert name == "vectors" and args[0] == m.data_ptr()
  assert args[1:5] == (pytest.approx(INTENSITY), pytest.approx(LIGHT_ADAPT),
                       0.0, 0)
  assert args[5] == scal.data_ptr() == lin.data_ptr() - 40
