"""The plain reference's parts against the port's plain path, at small
sizes on the CPU (the test may import the program; the reference may
not). The whole of each cell's run against the reference is in
test_isp_bench_faults.py."""

import numpy as np
import pytest
import torch

from isp_bench.reference import isp as ref


def test_decode_against_the_port():
  from taichi_image_tpu_torch.ops.hopper import decode
  g = torch.Generator().manual_seed(3)
  raws = torch.randint(0, 256, (2, 6, 12), generator=g, dtype=torch.uint8)
  codes = ref.decode_packed12(raws)
  phases = decode.decode12_phases_plain(raws, False, torch.float32)
  want = torch.stack([codes[:, 0::2, 0::2], codes[:, 0::2, 1::2],
                      codes[:, 1::2, 0::2], codes[:, 1::2, 1::2]], dim=1)
  assert torch.equal((want.float() * ref.DECODE_SCALE), phases)


@pytest.mark.parametrize("shape", [(2, 8, 12), (1, 16, 10)])
def test_demosaic_against_the_port(shape):
  from taichi_image_tpu_torch.ops.bayer import (BayerPattern,
                                                demosaic_phases,
                                                phases_to_planar)
  g = torch.Generator().manual_seed(5)
  cfa = torch.rand(shape, generator=g)
  phases = torch.stack([cfa[:, 0::2, 0::2], cfa[:, 0::2, 1::2],
                        cfa[:, 1::2, 0::2], cfa[:, 1::2, 1::2]], dim=1)
  port = phases_to_planar(demosaic_phases(phases, BayerPattern.RGGB))
  assert torch.allclose(ref.demosaic(cfa), port, rtol=0, atol=2e-6)


def _meter(sample, prev, t):
  """The metering update as the upstream states it, pixel by pixel."""
  x = sample.double()
  lo, hi = x.amin(), x.amax()
  b0, b1 = lo + t * (prev[0] - lo), hi + t * (prev[1] - hi)
  s = (x - b0) / (b1 - b0 + 1e-6)
  gray = 0.299 * s[:, 0] + 0.587 * s[:, 1] + 0.114 * s[:, 2]
  lg = torch.log(gray.clamp_min(1e-4))
  stats = torch.stack([b0, b1, lg.amin(), lg.amax(), lg.mean(), gray.mean(),
                       s[:, 0].mean(), s[:, 1].mean(), s[:, 2].mean()])
  return stats + t * (prev - stats)


def test_meter_step_is_the_metering_update():
  g = torch.Generator().manual_seed(7)
  samples = [torch.rand((2, 3, 5, 7), generator=g) * 1.2 - 0.1
             for _ in range(3)]
  prev = torch.zeros(9, dtype=torch.float64)
  state, t = [0.0] * 9, 0.0
  for i in [0, 1, 2, 1, 0, 2]:
    prev = _meter(samples[i], prev, t)
    state = ref.meter_step(ref.SampleSums(samples[i]), state, t)
    t = 0.9
    np.testing.assert_allclose(state, prev.numpy(), rtol=1e-5, atol=1e-6)


def test_i420_against_the_port():
  from taichi_image_tpu_torch.ops.hopper import yuv420
  g = torch.Generator().manual_seed(11)
  rgb = torch.randint(0, 256, (2, 3, 8, 12), generator=g, dtype=torch.uint8)
  for got, want in zip(ref.i420(rgb), yuv420.yuv420_planar_plain(rgb),
                       strict=True):
    assert got.shape == want.shape
    # the reference takes the block's mean colour, the port the mean of
    # the pixels' rows: equal up to rounding
    assert (got.to(torch.int16) - want.to(torch.int16)).abs().max() <= 1


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("resize_width", [50, 37, 75])   # x0.5, x0.37, x0.75
def test_resize_against_the_port(resize_width, dtype):
  from taichi_image_tpu_torch.models import camera_isp
  from taichi_image_tpu_torch.ops.bayer import planar_to_phases
  g = torch.Generator().manual_seed(13)
  rgb = torch.rand((2, 3, 64, 100), generator=g).to(dtype)
  h_out, w_out, scale = ref.resize_plan(64, 100, resize_width)
  got = ref.resize(rgb, h_out, w_out, scale, dtype)
  want = camera_isp._resize_from_phases(planar_to_phases(rgb),
                                        (w_out, h_out), scale, dtype)
  assert got.shape == (2, 3, round(64 * resize_width / 100), resize_width)
  # both mix the rows first in float32 and round once
  assert torch.equal(got, want)
