"""Demosaic kernel microbenchmark (counterpart of
``taichi_image_tpu/bench/bayer.py``; reference bench/bayer.py: 10k iters,
1k warmup, u8 RGGB). On CUDA ``bayer_to_rgb`` runs the K2 stencil in
f32."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from taichi_image_tpu_torch.ops import bayer
from taichi_image_tpu_torch.utils.benchmark import benchmark


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--size", type=int, nargs=2, default=(2160, 3840),
                      help="H W of the CFA image")
  parser.add_argument("--iterations", type=int, default=10000)
  parser.add_argument("--warmup", type=int, default=1000)
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)

  h, w = args.size
  rng = np.random.default_rng(0)
  cfa = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(
      args.device)

  f = lambda: bayer.bayer_to_rgb(cfa, bayer.BayerPattern.RGGB)
  its = benchmark("bayer_to_rgb", f, iterations=args.iterations,
                  warmup=args.warmup)
  mpixps = its * h * w / 1e6
  print(f"bayer_to_rgb: {mpixps:.1f} MPix/s")


if __name__ == "__main__":
  main()
