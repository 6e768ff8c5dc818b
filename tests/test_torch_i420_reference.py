"""The f16 rig's I420 route held to the benchmark's plain reference on the
CPU: ``Camera16`` with ``color_format="yuv420"`` over a chain of steps on
random packed12 raws, its Y and VU at every step against
``isp_bench/reference/isp.py``'s (plain float32 PyTorch, nothing of the
port) and its final metering state against the reference's, read as the
benchmark's comparison reads them (``isp_bench/compare.py``). Each reading
is under the limits of the I420 cell, and no u8 value is off by more than
one; ``CameraBF16``, one precision down, in the program's place is not."""

import pytest

torch = pytest.importorskip("torch")

import taichi_image_tpu_torch as ttit  # noqa: E402
from isp_bench import compare, inputs, manifest  # noqa: E402
from isp_bench.reference import isp as ref  # noqa: E402

M = manifest.load()
CELL = "rig6x4k_f16.device_i420"
CFG = manifest.config(M, manifest.workload(M, CELL)["config"])
LIMITS = manifest.limits(CELL)
CPU = torch.device("cpu")
SIZES = {"2x64x96": (64, 96), "2x256x384": (256, 384)}
SEEDS = [2 ** 31 + 11, 2 ** 31 + 12, 7, 2 ** 33 + 5]
POOL, STEPS = 3, 5   # steps cycle the pool, so a set comes back later


def _readings(isp_class, size, seed):
  """The comparison's readings of ``isp_class`` on the cell's settings at
  2 cameras of ``size``, every step's output kept."""
  h, w = SIZES[size]
  cfg = dict(CFG, cameras=2, height=h, width=w)
  pool = inputs.raw_pool(cfg, POOL, seed, CPU)
  isp = getattr(ttit, isp_class)(
      ttit.BayerPattern[cfg["bayer_pattern"]],
      moving_alpha=float(cfg["moving_alpha"]),
      metering_stride=int(cfg["metering_stride"]), device="cpu")
  chain = [i % POOL for i in range(STEPS)]
  outputs = {pos: isp.process(
      pool[i], fmt=cfg["raw_format"], gamma=float(cfg["gamma"]),
      intensity=float(cfg["intensity"]),
      light_adapt=float(cfg["light_adapt"]),
      color_adapt=float(cfg["color_adapt"]), color_format="yuv420")
      for pos, i in enumerate(chain)}
  pipe = ref.Pipeline(cfg, pool, compare.work_dtype(cfg))
  return compare.readings(pipe, chain, outputs, isp.metrics, "yuv420")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", SIZES)
def test_camera16_i420_holds_to_the_reference(size, seed):
  values = _readings("Camera16", size, seed)
  assert values["u8_off_max"] <= 1, values
  assert compare.judge(values, LIMITS), (values, LIMITS)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", SIZES)
def test_camerabf16_in_its_place_is_not_correct(size, seed):
  values = _readings("CameraBF16", size, seed)
  assert not compare.judge(values, LIMITS), (values, LIMITS)
