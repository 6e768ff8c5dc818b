"""The port's ``utils`` (image metrics, the benchmark harness, profiling),
``types``' DLPack interop and the package exports, against the JAX
package's on the CPU.

Contracts: ``psnr`` and ``mse`` within 1e-12 relative of JAX's (both
compute in float64 on the host), ``inf`` on equal inputs; DLPack shares
memory with its producer; the ``__all__`` of ``models``, ``utils`` and
``bench`` equal JAX's.
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import taichi_image_tpu_torch as ttit  # noqa: E402
from taichi_image_tpu import types as jtypes  # noqa: E402
from taichi_image_tpu.utils import image as jimage  # noqa: E402
from taichi_image_tpu_torch import types as ttypes  # noqa: E402
from taichi_image_tpu_torch.utils import image as timage  # noqa: E402
from taichi_image_tpu_torch.utils import profiling  # noqa: E402

# the module (``utils.benchmark`` is the function, as in the JAX package)
tbench = importlib.import_module("taichi_image_tpu_torch.utils.benchmark")


def _pair(dtype, seed=0, shape=(24, 36, 3)):
  rng = np.random.default_rng(seed)
  if dtype == np.float32:
    a = rng.random(shape, np.float32)
    return a, np.clip(a + rng.normal(0, 0.01, shape).astype(np.float32), 0, 1)
  top = np.iinfo(dtype).max
  a = rng.integers(0, top + 1, shape, dtype=dtype)
  noise = rng.integers(-3, 4, shape)
  return a, np.clip(a.astype(np.int64) + noise, 0, top).astype(dtype)


_DTYPES = [np.uint8, np.uint16, np.float32]
_IDS = ["u8", "u16", "f32"]


@pytest.mark.parametrize("dtype", _DTYPES, ids=_IDS)
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_psnr_and_mse_are_jax(dtype, as_tensor):
  a, b = _pair(dtype)
  ta, tb = ((ttypes.as_tensor(a), ttypes.as_tensor(b)) if as_tensor
            else (a, b))
  for peak in (None, 1.0):
    ours, theirs = timage.psnr(ta, tb, peak=peak), jimage.psnr(a, b, peak=peak)
    assert ours == pytest.approx(theirs, rel=1e-12, abs=0)
  assert timage.mse(ta, tb) == pytest.approx(jimage.mse(a, b), rel=1e-12,
                                             abs=0)
  assert timage.mse(ta, tb) > 0


@pytest.mark.parametrize("dtype", _DTYPES, ids=_IDS)
def test_psnr_of_equal_inputs_is_inf(dtype):
  a, _ = _pair(dtype, seed=1)
  assert timage.psnr(a, a.copy()) == float("inf") == jimage.psnr(a, a.copy())
  t = ttypes.as_tensor(a)
  assert timage.psnr(t, t.clone()) == float("inf")
  assert timage.mse(t, t) == 0.0


def test_psnr_peak_is_the_dtype_full_scale():
  a, b = _pair(np.uint8, seed=2)
  m = jimage.mse(a, b)
  assert timage.psnr(a, b) == pytest.approx(10 * np.log10(255.0 ** 2 / m),
                                            rel=1e-12)
  with pytest.raises(ValueError, match="Unsupported dtype"):
    timage.psnr(a.astype(np.float64), b)  # as jimage: no float64 scale


def test_psnr_of_a_bf16_tensor():
  a, b = _pair(np.float32, seed=3)
  ta = torch.from_numpy(a).to(torch.bfloat16)
  ref = jimage.psnr(ta.float().numpy(), b, peak=1.0)
  assert timage.psnr(ta, b) == pytest.approx(ref, rel=1e-12)


# -- DLPack interop ----------------------------------------------------------

_DL_DTYPES = [jnp.float32, jnp.uint8, jnp.uint16, jnp.float16, jnp.bfloat16]
_DL_IDS = ["f32", "u8", "u16", "f16", "bf16"]


@pytest.mark.parametrize("dtype", _DL_DTYPES, ids=_DL_IDS)
def test_from_dlpack_of_a_jax_array(dtype):
  x = (jnp.arange(48, dtype=jnp.float32).reshape(6, 8) * 3).astype(dtype)
  t = ttypes.from_dlpack(x)
  assert isinstance(t, torch.Tensor) and t.shape == (6, 8)
  assert t.dtype == ttypes.canonical_dtype(np.dtype(x.dtype))
  assert t.data_ptr() == x.unsafe_buffer_pointer()  # shared, not copied
  np.testing.assert_array_equal(ttypes.to_float(t).numpy(),
                                np.asarray(jtypes.to_float(x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.int16,
                                   torch.float16],
                         ids=["f32", "u8", "i16", "f16"])
def test_jax_from_dlpack_of_to_dlpack_round_trips(dtype):
  t = (torch.arange(48).reshape(6, 8) * 5).to(dtype)
  x = jnp.from_dlpack(ttypes.to_dlpack(t))
  np.testing.assert_array_equal(np.asarray(x), t.numpy())
  back = ttypes.from_dlpack(x)
  assert torch.equal(back, t)


def test_dlpack_numpy_and_capsule_share_memory():
  a = np.arange(12, dtype=np.float32).reshape(3, 4)
  t = ttypes.from_dlpack(a)
  t[0, 0] = 42.0
  assert a[0, 0] == 42.0
  src = torch.arange(6)
  cap = torch.utils.dlpack.to_dlpack(src)
  got = ttypes.from_dlpack(cap)
  assert got.data_ptr() == src.data_ptr()
  np.testing.assert_array_equal(np.from_dlpack(ttypes.to_dlpack(a)), a)


def test_to_torch_and_from_torch():
  t = torch.arange(6, dtype=torch.float32)
  assert ttypes.to_torch(t) is t
  assert ttypes.from_torch(t) is t
  x = jnp.arange(6, dtype=jnp.float32)
  assert torch.equal(ttypes.to_torch(x), t)
  with pytest.raises(TypeError, match="torch.Tensor"):
    ttypes.from_torch(np.arange(3))


def test_dlpack_feeds_the_isp():
  """A JAX-held packed12 buffer feeds the port's ISP through DLPack, as a
  torch-held one feeds the JAX ISP (tests/test_types.py)."""
  raw_np = np.random.default_rng(0).integers(0, 256, size=(2, 16, 36),
                                             dtype=np.uint8)
  isp1 = ttit.Camera32(ttit.BayerPattern.RGGB, device="cpu")
  isp2 = ttit.Camera32(ttit.BayerPattern.RGGB, device="cpu")
  out1 = isp1.process(ttypes.from_dlpack(jnp.asarray(raw_np)))
  out2 = isp2.process(raw_np)
  assert torch.equal(out1, out2)


# -- exports -----------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["models", "utils", "bench"])
def test_package_all_is_jax(pkg):
  ours = importlib.import_module(f"taichi_image_tpu_torch.{pkg}")
  theirs = importlib.import_module(f"taichi_image_tpu.{pkg}")
  assert ours.__all__ == theirs.__all__
  for name in ours.__all__:
    assert hasattr(ours, name), name


def test_models_exports_are_the_port_objects():
  from taichi_image_tpu_torch import models
  from taichi_image_tpu_torch.models import camera_isp as tci
  assert models.camera_isp is tci
  assert models.Camera16 is ttit.Camera16 is tci.Camera16
  assert models.CameraBF16._work_dtype == torch.bfloat16
  assert models.moving_average(None, 3.0, 0.5) == 3.0
  np.testing.assert_array_equal(models.default_cc, tci.default_cc)


def test_utils_exports_are_the_port_objects():
  from taichi_image_tpu_torch import utils
  assert utils.psnr is timage.psnr and utils.mse is timage.mse
  assert utils.Benchmark is tbench.Benchmark
  assert utils.profiling is profiling


# -- benchmark harness -------------------------------------------------------

def test_benchmark_reports_elapsed(capsys):
  with tbench.Benchmark("sum", iterations=3) as b:
    torch.ones(100).sum()
  assert b.elapsed > 0
  out = capsys.readouterr().out
  assert out.startswith("sum: ") and "it/s" in out
  with tbench.Benchmark("once") as b1:
    pass
  assert b1.elapsed > 0
  out = capsys.readouterr().out
  assert out.startswith("once: ") and "it/s" not in out


def test_benchmark_driver_returns_its_per_second(capsys):
  calls = []

  def f(x, scale=1):
    calls.append(x)
    return (torch.full((4,), float(x) * scale), {"k": [torch.zeros(2)]})

  its = tbench.benchmark("fill", f, args=[2], kwargs={"scale": 3},
                         iterations=5, warmup=2)
  assert its > 0 and len(calls) == 7
  out = capsys.readouterr().out
  assert out.startswith("fill: ") and "it/s" in out


def test_sync_ignores_cpu_tensors(monkeypatch):
  def boom(*a, **k):
    raise AssertionError("no CUDA fence for CPU results")
  monkeypatch.setattr(torch.cuda, "synchronize", boom)
  tbench._sync((torch.zeros(2), [torch.ones(1)], {"a": torch.ones(1)}))
  if not torch.cuda.is_available():
    tbench._sync()


def test_sync_fences_each_cuda_device_of_the_result(monkeypatch):
  """The fence synchronises every CUDA device that holds a tensor of the
  result, once each (meta tensors stand in for CUDA ones here)."""
  seen = []
  monkeypatch.setattr(torch.cuda, "synchronize", seen.append)

  class Fake:
    def __init__(self, dev):
      self.device, self.is_cuda = torch.device(dev), True

  monkeypatch.setattr(tbench, "_leaves", lambda x: iter(x))
  tbench._sync([Fake("cuda:0"), Fake("cuda:1"), Fake("cuda:0")])
  assert sorted(str(d) for d in seen) == ["cuda:0", "cuda:1"]


def test_leaves_walks_nested_results():
  a, b, c = torch.zeros(1), torch.ones(1), torch.ones(2)
  got = list(tbench._leaves({"x": (a, [b, 3]), "y": c, "z": None}))
  assert got[0] is a and got[1] is b and got[2] is c and len(got) == 3


# -- profiling ---------------------------------------------------------------

def test_trace_writes_a_file(tmp_path):
  with profiling.trace(str(tmp_path), create_perfetto_link=True):
    with profiling.annotate("isp step"):
      isp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cpu")
      isp.process(np.zeros((1, 8, 24), np.uint8))
  files = list(tmp_path.glob("*.pt.trace.json"))
  assert len(files) == 1
  events = json.loads(files[0].read_text())["traceEvents"]
  assert any(e.get("name") == "isp step" for e in events)


def test_stage_timer_accumulates():
  stats = {}
  for _ in range(2):
    with profiling.stage_timer(stats, "x"):
      pass
  with profiling.stage_timer(stats, "y"):
    torch.ones(10).sum()
  assert set(stats) == {"x", "y"} and stats["x"] >= 0 and stats["y"] >= 0
  before = stats["x"]
  with pytest.raises(KeyError):
    with profiling.stage_timer(stats, "x"):
      raise KeyError("stage failed")
  assert stats["x"] >= before  # the failed stage still counts
