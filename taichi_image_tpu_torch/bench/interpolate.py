"""Resize + rotate benchmark (counterpart of
``taichi_image_tpu/bench/interpolate.py``; reference bench/interpolate.py:
resize x0.8 + rot90, f16). The HWC resize and transform are plain torch,
as they are plain XLA in the JAX package (no Pallas kernel)."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from taichi_image_tpu_torch.ops import interpolate
from taichi_image_tpu_torch.utils.benchmark import benchmark


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--size", type=int, nargs=2, default=(2160, 3840))
  parser.add_argument("--iterations", type=int, default=10000)
  parser.add_argument("--warmup", type=int, default=100)
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)

  h, w = args.size
  rng = np.random.default_rng(0)
  img = torch.from_numpy(
      rng.uniform(0, 1, (h, w, 3)).astype(np.float16)).to(args.device)

  def resize_rot(x):
    y = interpolate._resize_bilinear(
        x, (int(w * 0.8), int(h * 0.8)), (0.8, 0.8),
        torch.float16, torch.float16)
    return interpolate.transform(y, interpolate.ImageTransform.rotate_90)

  its = benchmark("resize(x0.8)+rot90", lambda: resize_rot(img),
                  iterations=args.iterations, warmup=args.warmup)
  print(f"resize+rot90: {its:.1f} it/s")


if __name__ == "__main__":
  main()
