"""The port's parallel runtime and what the multi-device steps changed in
the single-device path, on the CPU.

  * the dispatch queue (``NullExecutor``, ``DispatchQueue`` threaded and
    inline, the ``run_sync`` deadlock error, futures as arguments,
    ``dispatch_queue``, ``queued``): the cases of tests/test_sharding.py
    and tests/test_api_surface.py;
  * ``devices``/``device_count`` and ``make_camera_mesh`` in a 2-rank run
    (``parallel.run_ranks``);
  * ``metering_update_ca`` without a group bitwise its form before the
    group existed (a frozen copy below), and with a one-rank gloo group
    bitwise the same; ``fused_isp_step`` without a group bitwise its
    stages composed by hand, and with a one-rank group bitwise without;
  * the kernels launch on any CUDA device: no refusal of a device index,
    and ``Kernel.launch`` runs its C launcher under the tensor's device
    with that device's stream (checked with the launcher and the device
    context replaced, since this host has no card).
"""

import threading
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu_torch import parallel  # noqa: E402
from taichi_image_tpu_torch.models import camera_isp as tci  # noqa: E402
from taichi_image_tpu_torch.ops import hopper  # noqa: E402
from taichi_image_tpu_torch.ops.bayer import (  # noqa: E402
    BayerPattern, demosaic_phases)
from taichi_image_tpu_torch.ops.hopper import finish as th_fin  # noqa: E402
from taichi_image_tpu_torch.parallel import dryrun  # noqa: E402
from taichi_image_tpu_torch.parallel import (  # noqa: E402
    DispatchQueue, NullExecutor, dispatch_queue, queued)
from taichi_image_tpu_torch.utils.bounds import lerp  # noqa: E402


# --------------------------------------------------------------------------
# The dispatch queue.
# --------------------------------------------------------------------------

@pytest.fixture
def stopped_queue():
  yield
  DispatchQueue.stop()


def test_null_executor():
  ran = []
  ex = NullExecutor(initializer=lambda: ran.append("init"))
  fut = ex.submit(lambda a, b: a + b, 2, 3)
  assert fut.result() == 5
  assert ran == ["init"]
  ex.shutdown()


def test_dispatch_queue_threaded(stopped_queue):
  ran = []
  with dispatch_queue(lambda: ran.append(threading.get_ident()),
                      threaded=True):
    f = queued(lambda a, b: a + b)
    assert f(2, 3) == 5
    fut = DispatchQueue.run_async(threading.get_ident)
    # the worker ran the initializer and runs every call
    assert fut.result() == ran[0] == DispatchQueue.thread_id()
    assert ran[0] != threading.get_ident()
  assert DispatchQueue.executor is None  # the context manager stopped it


def test_dispatch_queue_inline(stopped_queue):
  DispatchQueue.init()
  assert isinstance(DispatchQueue.queue(), NullExecutor)
  assert DispatchQueue.thread_id() is None
  assert DispatchQueue.run_sync(lambda x: x * 2, 21) == 42


def test_run_sync_from_the_worker_raises(stopped_queue):
  DispatchQueue.init(threaded=True)
  with pytest.raises(RuntimeError, match="deadlock"):
    DispatchQueue.run_async(DispatchQueue.run_sync, lambda: 1).result()


def test_futures_are_resolved_before_the_call(stopped_queue):
  DispatchQueue.init(threaded=True)
  a = DispatchQueue.run_async(lambda: 20)
  b = Future()
  b.set_result(22)
  assert DispatchQueue.run_sync(lambda x, y: x + y, a, b) == 42


def test_dispatch_queue_init_twice_and_uninitialized(stopped_queue):
  with pytest.raises(RuntimeError, match="not initialized"):
    DispatchQueue.run_sync(lambda: 1)
  DispatchQueue.init()
  with pytest.raises(RuntimeError, match="already initialized"):
    DispatchQueue.init()


# --------------------------------------------------------------------------
# Devices and meshes.
# --------------------------------------------------------------------------

def test_devices_and_device_count():
  assert parallel.devices("cpu") == [torch.device("cpu")]
  assert parallel.device_count("cpu") == 1
  cuda = parallel.devices()
  assert all(d.type == "cuda" for d in cuda)
  assert parallel.device_count() == torch.cuda.device_count() == len(cuda)
  with pytest.raises(ValueError, match="unknown backend"):
    parallel.devices("tpu")


def test_make_camera_mesh_needs_a_process_group():
  assert not dist.is_initialized()
  with pytest.raises(RuntimeError, match="process group"):
    parallel.make_camera_mesh()


def test_make_camera_mesh_in_a_two_rank_run():
  got = parallel.run_ranks(dryrun.run_variants, 2,
                           [dict(name="mesh", kind="mesh")], "cpu")
  for rank, (r,) in enumerate(got):
    assert r["all"] == dict(shape=(2,), names=("cam",), coordinate=[rank],
                            device="cpu")
    # the first rank alone: the other has no coordinate in it
    assert r["first"]["shape"] == (1,)
    assert r["first"]["coordinate"] == ([0] if rank == 0 else None)


def test_run_ranks_reports_a_failing_rank():
  """A rank that raises fails the run with its traceback (a variant
  without its raws)."""
  with pytest.raises(RuntimeError, match="KeyError: 'raws'"):
    parallel.run_ranks(dryrun.run_variants, 1,
                       [dict(name="bad", kind="rows", cls="Camera32")],
                       "cpu", timeout=120)


# --------------------------------------------------------------------------
# The metering and the step without a group keep their group-free form.
# --------------------------------------------------------------------------

def metering_before_groups(x, prev, t):
  """``metering_update_ca`` as it was before it took a group: the five
  sums in f32, divided by the pixel count as a Python number."""
  x = x.to(torch.float32)
  b = lerp(t, torch.stack([x.amin(), x.amax()]), prev[:2])
  scaled = (x - b[0]) / (b[1] - b[0] + 1e-6)
  r, g, bch = scaled[:, 0], scaled[:, 1], scaled[:, 2]
  gray = 0.299 * r + 0.587 * g + 0.114 * bch
  log_gray = torch.log(torch.clamp_min(gray, 1e-4))
  sums = torch.stack([log_gray.sum(), gray.sum(), r.sum(), g.sum(),
                      bch.sum()])
  n_total = x.shape[0] * x.shape[2] * x.shape[3]
  stats = torch.cat([b, torch.stack([log_gray.amin(), log_gray.amax()]),
                     sums / n_total])
  return lerp(t, stats, prev)


def metering_without_a_group(x, prev, t):
  """The same group-free formula in the arithmetic that the metering
  kernel and its twin share: the five sums in f64 rounded once to f32,
  the division by the count in IEEE f32."""
  x = x.to(torch.float32)
  b = lerp(t, torch.stack([x.amin(), x.amax()]), prev[:2])
  scaled = (x - b[0]) / (b[1] - b[0] + 1e-6)
  r, g, bch = scaled[:, 0], scaled[:, 1], scaled[:, 2]
  gray = 0.299 * r + 0.587 * g + 0.114 * bch
  log_gray = torch.log(torch.clamp_min(gray, 1e-4))
  sums = torch.stack([v.double().sum() for v in
                      (log_gray, gray, r, g, bch)]).float()
  n_total = x.shape[0] * x.shape[2] * x.shape[3]
  stats = torch.cat([b, torch.stack([log_gray.amin(), log_gray.amax()]),
                     sums / torch.tensor(float(n_total))])
  return lerp(t, stats, prev)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
  """A one-rank gloo group in this process."""
  assert not dist.is_initialized()
  path = tmp_path_factory.mktemp("world1") / "rendezvous"
  dist.init_process_group("gloo", init_method=f"file://{path}",
                          world_size=1, rank=0)
  yield dist.group.WORLD
  dist.destroy_process_group()


def test_make_camera_mesh_defaults_to_the_card(world1, monkeypatch):
  """Without ``device_type`` the mesh is a CUDA mesh: with no CUDA device
  visible it raises instead of building a CPU mesh; ``device_type="cpu"``
  asks for the CPU."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device is visible"):
    parallel.make_camera_mesh()
  mesh = parallel.make_camera_mesh(device_type="cpu")
  assert mesh.device_type == "cpu" and tuple(mesh.shape) == (1,)


def _samples():
  rng = np.random.default_rng(3)
  for shape, dtype in [((2, 3, 27, 48), torch.float32),
                       ((6, 3, 5, 7), torch.bfloat16),
                       ((1, 3, 1, 1), torch.float16)]:
    x = torch.from_numpy(rng.random(shape, np.float32)).to(dtype)
    prev = torch.from_numpy(rng.random(9, np.float32))
    for t in (0.0, 0.9):
      yield x, prev, t


def test_metering_without_a_group_is_bitwise_its_old_form():
  """Bitwise the group-free formula in the kernel's arithmetic, and within
  1e-6 relative of the f32 sums it took before the metering kernel (the
  bounds and log bounds bitwise: only the sums' rounding moved)."""
  for x, prev, t in _samples():
    got = tci.metering_update_ca(x, prev, t)
    assert torch.equal(got, metering_without_a_group(x, prev, t))
    old = metering_before_groups(x, prev, t)
    assert torch.equal(got[:4], old[:4])
    np.testing.assert_allclose(got.numpy(), old.numpy(), rtol=1e-6, atol=0)


def test_metering_with_a_one_rank_group_is_bitwise_without(world1):
  for x, prev, t in _samples():
    n = x.shape[0] * x.shape[2] * x.shape[3]
    assert torch.equal(
        tci.metering_update_ca(x, prev, t, group=world1, n_total=n),
        tci.metering_update_ca(x, prev, t))


def test_metering_divides_by_n_total(world1):
  x, prev, _ = next(_samples())
  n = x.shape[0] * x.shape[2] * x.shape[3]
  half = tci.metering_update_ca(x, prev, 0.0, group=world1, n_total=2 * n)
  full = tci.metering_update_ca(x, prev, 0.0)
  assert torch.equal(half[:4], full[:4])
  np.testing.assert_allclose(half[4:].numpy(), full[4:].numpy() / 2,
                             rtol=1e-6)


def _raws(seed=0, n=2, h=32, wb=144):
  return torch.from_numpy(np.random.default_rng(seed).integers(
      0, 256, size=(n, h, wb), dtype=np.uint8))


_ARGS = (0.8, 2.0, 1.0, 0.0, "packed12", False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tonemap", ["reinhard", "linear"])
def test_step_without_a_group_is_bitwise_its_stages(dtype, tonemap):
  """The phase route of ``fused_isp_step``, composed by hand from its
  stages with the metering's group-free form."""
  raws, prev = _raws(), torch.rand(9)
  m, out = tci.fused_isp_step(raws, prev, 0.9, *_ARGS, dtype,
                              BayerPattern.RGGB, None, None, 8,
                              ttit.ImageTransform.none, tonemap)
  phases = tci.load_raw_phases(raws, "packed12", dtype)
  x12, sample = demosaic_phases(phases, BayerPattern.RGGB, out_dtype=dtype,
                                sample_step=4)
  want_m = metering_without_a_group(sample, prev, 0.9)
  if tonemap == "reinhard":
    p, mx = tci.reinhard_map_max_ca(x12, want_m, 2.0, 1.0, 0.0, dtype)
    want = th_fin.finish_planar_u8(p, mx, 0.8)
  else:
    want = th_fin.finish_planar_u8(x12, th_fin.linear_scal(want_m), 0.8,
                                   "linear")
  assert torch.equal(m, want_m)
  assert torch.equal(out, want)


@pytest.mark.parametrize("route", ["phase", "resize", "stride7", "i420",
                                   "resize-i420"])
def test_step_with_a_one_rank_group_is_bitwise_without(world1, route):
  plan = ((48, 16), 0.5) if route.startswith("resize") else None
  stride = 7 if route == "stride7" else 8
  cf = "yuv420" if route.endswith("i420") else "rgb"
  raws, prev = _raws(1), torch.rand(9)
  args = (*_ARGS, torch.bfloat16, BayerPattern.GRBG, None, plan, stride,
          ttit.ImageTransform.rotate_90, "reinhard")
  want_m, want = tci.fused_isp_step(raws, prev, 0.9, *args, color_format=cf)
  n_total = 2 * -(-(16 if plan else 32) // stride) * -(-(48 if plan else 96)
                                                        // stride)
  m, out = tci.fused_isp_step(raws, prev, 0.9, *args, color_format=cf,
                              group=world1, n_total=n_total)
  assert torch.equal(m, want_m)
  for a, b in zip(out if cf == "yuv420" else (out,),
                  want if cf == "yuv420" else (want,), strict=True):
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The kernels on any CUDA device.
# --------------------------------------------------------------------------

def test_auto_on_a_cpu_tensor_is_still_the_plain_route():
  x = torch.zeros(2)
  assert hopper.use_kernel("auto", x) is False
  assert hopper.use_kernel("plain", x) is False
  with pytest.raises(ValueError, match="needs CUDA tensors"):
    hopper.use_kernel("kernel", x)


class _CudaLike:
  """A stand-in for a CUDA tensor on a device other than 0."""
  is_cuda = True
  device = torch.device("cuda", 3)


def test_no_device_index_is_refused(monkeypatch):
  monkeypatch.setattr(hopper, "_capability", lambda device: (9, 0))
  assert hopper.use_kernel("auto", _CudaLike()) is True
  assert hopper.use_kernel("kernel", _CudaLike()) is True
  monkeypatch.setattr(hopper, "_capability", lambda device: (8, 0))
  with pytest.raises(RuntimeError, match="sm_90a"):
    hopper.use_kernel("auto", _CudaLike())


def test_launch_runs_under_the_tensors_device(monkeypatch):
  entered, calls = [], []

  def enter(device):
    entered.append(device)
    return "the device before"

  def launcher(*args):
    calls.append((args, list(entered)))
    return 0

  monkeypatch.setattr(hopper, "enter_device", enter)
  monkeypatch.setattr(hopper, "leave_device",
                      lambda prev: entered.append(("exit", prev)))
  monkeypatch.setattr(hopper, "stream_of", lambda device: 1000 + device.index)
  k = hopper.Kernel("probe", "decode.cu", "tit_probe", [], "here:1")
  k._fn = launcher
  dev = torch.device("cuda", 2)
  k.launch(dev, 7, 8)
  # the launcher ran with the device current, with its stream last, and
  # the device that was current came back after it
  assert calls == [((7, 8, 1002), [dev])]
  assert entered == [dev, ("exit", "the device before")]
  assert k.launches == 1
  k._fn = lambda *args: 700
  with pytest.raises(RuntimeError, match="cudaError_t 700"):
    k.launch(dev, 7, 8)
  assert entered[-1] == ("exit", "the device before")
  assert k.launches == 1
