"""Full 6-camera ISP throughput benchmark (counterpart of
``taichi_image_tpu/bench/camera_isp.py``; reference bench/camera_isp.py:
10k iters, packed12 -> reinhard, f16). The f16 default is Camera16: K1-K4
in f16 on CUDA."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from taichi_image_tpu_torch import types
from taichi_image_tpu_torch.models.camera_isp import camera_isp
from taichi_image_tpu_torch.ops.bayer import BayerPattern
from taichi_image_tpu_torch.ops.interpolate import ImageTransform
from taichi_image_tpu_torch.utils.benchmark import Benchmark


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--size", type=int, nargs=2, default=(2160, 3840))
  parser.add_argument("--cameras", type=int, default=6)
  parser.add_argument("--iterations", type=int, default=1000)
  parser.add_argument("--warmup", type=int, default=20)
  parser.add_argument("--resize", type=int, default=0)
  parser.add_argument("--transform", default="none")
  parser.add_argument("--dtype", choices=["f16", "f32", "bf16"],
                      default="f16")
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)

  h, w = args.size
  rng = np.random.default_rng(0)
  raws = torch.from_numpy(rng.integers(
      0, 256, (args.cameras, h, w * 3 // 2), dtype=np.uint8)).to(args.device)

  dtype = {"f16": types.f16, "f32": types.f32, "bf16": types.bf16}[args.dtype]
  isp = camera_isp("Bench", dtype)(
      BayerPattern.RGGB, moving_alpha=0.1, resize_width=args.resize,
      transform=ImageTransform[args.transform], device=args.device)

  out = isp.process(raws, gamma=0.6)
  for _ in range(args.warmup):
    out = isp.process(raws, gamma=0.6)
  _ = out.cpu()

  with Benchmark("camera_isp 6x4K", args.iterations) as b:
    for _ in range(args.iterations):
      out = isp.process(raws, gamma=0.6)
    # fetch real bytes: each step consumed the previous EMA metrics, so
    # reading the last output fences the whole chain
    _ = out.cpu()

  fps = args.iterations * args.cameras / b.elapsed
  print(f"full ISP: {fps:.1f} frames/s "
        f"({fps * h * w / 1e9:.2f} GPix/s)")


if __name__ == "__main__":
  main()
