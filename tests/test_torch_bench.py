"""The port's ``bench`` package on the CPU: each benchmark at 32x48 with 2
iterations prints the JAX package's lines (the shootout with its plain
sides only: the kernels need a CUDA device), and the shootout's input
perturbation matches JAX's bit for bit."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from taichi_image_tpu.bench import shootout as jshoot  # noqa: E402
from taichi_image_tpu_torch.bench import shootout  # noqa: E402

SMALL = ["--size", "32", "48"]
CPU = ["--device", "cpu"]
_ARGS = {
    "bayer": SMALL + ["--iterations", "2", "--warmup", "1"],
    "camera_isp": SMALL + ["--iterations", "2", "--warmup", "1"],
    "interpolate": SMALL + ["--iterations", "2", "--warmup", "1"],
}


def _labels(out: str):
  """Each printed line's label: the text before its first ': '."""
  return [line.split(": ")[0] for line in out.splitlines() if ": " in line]


@pytest.mark.parametrize("name", list(_ARGS))
def test_bench_prints_the_jax_labels(name, capsys):
  ours = importlib.import_module(f"taichi_image_tpu_torch.bench.{name}")
  theirs = importlib.import_module(f"taichi_image_tpu.bench.{name}")
  ours.main(_ARGS[name] + CPU)
  got = capsys.readouterr().out
  theirs.main(_ARGS[name])
  want = capsys.readouterr().out
  assert _labels(got) == _labels(want) and len(_labels(got)) == 2
  assert got.splitlines()[-1].split()[-1] == want.splitlines()[-1].split()[-1]


def test_bench_camera_isp_other_configs(capsys):
  from taichi_image_tpu_torch.bench import camera_isp
  camera_isp.main(SMALL + ["--iterations", "2", "--warmup", "0",
                           "--cameras", "2", "--dtype", "bf16", "--resize",
                           "24", "--transform", "rotate_90"] + CPU)
  out = capsys.readouterr().out
  assert "camera_isp 6x4K:" in out and "frames/s" in out


def test_bench_shootout_smoke(capsys):
  """Cross-implementation race harness runs end-to-end (reference
  analogue: bench/interpolate.py taichi-vs-torch.compile race)."""
  shootout.main(["--size", "32", "48", "--k", "2", "--reps", "1"] + CPU)
  out = capsys.readouterr().out
  assert "demosaic[plain]" in out
  assert "decode12[plain]" in out
  assert "resize+rot90[port" in out


def test_bench_shootout_runs_only_plain_sides_on_the_cpu(capsys):
  shootout.main(["--size", "32", "48", "--k", "2", "--reps", "1",
                 "--races", "demosaic,decode12"] + CPU)
  lines = capsys.readouterr().out.splitlines()
  assert lines == [
      "demosaic[kernel]: not available on this device (cpu)",
      lines[1], "decode12[kernel]: not available on this device (cpu)",
      lines[3]]
  assert lines[1].startswith("demosaic[plain]: ") and lines[1].endswith("it/s")
  assert lines[3].startswith("decode12[plain]:  ") and lines[3].endswith("it/s")


def test_bench_shootout_resize_race_labels(capsys):
  shootout.main(["--size", "32", "48", "--k", "2", "--reps", "1",
                 "--races", "resize"] + CPU)
  lines = capsys.readouterr().out.splitlines()
  assert lines[0].startswith("resize+rot90[port/cpu]: ")
  assert lines[1].startswith(("resize+rot90[torch.compile/cpu]: ",
                              "resize+rot90[torch eager/cpu]: "))
  assert "same device" in lines[1]


@pytest.mark.parametrize("dtype", [np.uint8, np.float16, np.float32, "bf16"],
                         ids=["u8", "f16", "f32", "bf16"])
def test_perturb_is_jax(dtype):
  rng = np.random.default_rng(0)
  base = rng.random((5, 7)).astype(np.float32)
  if dtype == np.uint8:
    x = (base * 255).astype(np.uint8)
    t, j = torch.from_numpy(x), jnp.asarray(x)
  elif dtype == "bf16":
    t = torch.from_numpy(base).to(torch.bfloat16)
    j = jnp.asarray(base).astype(jnp.bfloat16)
  else:
    x = base.astype(dtype)
    t, j = torch.from_numpy(x), jnp.asarray(x)
  ibits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
  nbits = {1: np.uint8, 2: np.uint16, 4: np.uint32}[t.element_size()]
  outs = set()
  for i in range(10):
    p = shootout._perturb(t, i)
    assert p.dtype == t.dtype and p.shape == t.shape
    ours = p.view(ibits).numpy().view(nbits)
    theirs = np.asarray(jshoot._perturb(j, i)).view(nbits)
    np.testing.assert_array_equal(ours, theirs)
    if t.dtype.is_floating_point:
      assert torch.isfinite(p.float()).all()
    outs.add(ours.tobytes())
  assert len(outs) == 10  # every iteration's input differs bitwise


def test_chain_sums_every_output_once_per_iteration():
  seen = []

  def fn(x):
    seen.append(x.clone())
    return x

  x = torch.arange(6, dtype=torch.uint8)
  its = shootout._chain(fn, x, k=3, reps=2)
  assert its > 0
  assert len(seen) == 3 * 3  # the warm-up and two reps of k = 3
  for i, s in enumerate(seen[:3]):
    assert torch.equal(s, x ^ i)


@pytest.mark.parametrize("name", ["bayer", "camera_isp", "interpolate",
                                  "shootout"])
def test_bench_defaults_to_the_card(name):
  """Without --device a benchmark places its inputs on the CUDA device;
  on a host without one it raises instead of timing the CPU."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default runs there")
  mod = importlib.import_module(f"taichi_image_tpu_torch.bench.{name}")
  argv = (["--size", "32", "48", "--k", "1", "--reps", "1"]
          if name == "shootout" else _ARGS[name])
  with pytest.raises((RuntimeError, AssertionError),
                     match="CUDA|accelerator"):
    mod.main(argv)
