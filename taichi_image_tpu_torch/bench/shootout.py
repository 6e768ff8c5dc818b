"""Cross-implementation benchmark races (counterpart of
``taichi_image_tpu/bench/shootout.py``; reference analogue:
bench/interpolate.py:49-55 races taichi vs torch.compile).

Three races, each printing it/s per implementation, on ``--device``
(default ``cuda``):

  demosaic   the K2 stencil kernel vs its plain PyTorch twin
             (``ops/bayer.demosaic_phases(..., backend=...)``, f32; same
             inputs, same outputs up to the stencil's contract).
  decode12   the K1 decode kernel vs its plain twin (bf16,
             ``models/camera_isp.load_raw_phases(..., backend=...)``).
  resize     the port's HWC bilinear + rot90 (plain torch, as the JAX
             package's is plain XLA) vs ``torch.compile`` of
             F.interpolate + rot90 on the same device (eager where
             compile is unavailable).

On the CPU only the plain sides run: the kernels need a CUDA device.

Timing: K chained iterations, a bitwise-distinct input each, every output
summed into one f32 accumulator on the device, read on the host once per
rep (the fence); the best of ``--reps``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from taichi_image_tpu_torch.ops import bayer
from taichi_image_tpu_torch.ops.bayer import BayerPattern

_INT_VIEW = {torch.float32: torch.int32, torch.float16: torch.int16,
             torch.bfloat16: torch.int16}


def _perturb(x: torch.Tensor, i: int) -> torch.Tensor:
  """Bitwise-distinct input for iteration ``i``: integer inputs XOR the
  iteration index; float inputs XOR it into the low mantissa bits through
  a same-width integer view. An additive ``i * 1e-6`` is NOT enough — for
  f16 values >= 1/16 it is below half an ulp and rounds away. XOR of
  i < 16 touches only mantissa LSBs: never sign/exponent, so no NaN/inf,
  and each iteration's input differs bitwise."""
  if not x.dtype.is_floating_point:
    return x ^ i
  return (x.view(_INT_VIEW[x.dtype]) ^ i).view(x.dtype)


def _chain(fn, x, k, reps, cast=torch.float32):
  def steps(x):
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(k):
      acc = acc + fn(_perturb(x, i)).to(cast).sum(dtype=torch.float32)
    return acc
  _ = float(steps(x))
  best = None
  for _ in range(reps):
    t0 = time.perf_counter()
    _ = float(steps(x))
    el = time.perf_counter() - t0
    best = el if best is None else min(best, el)
  return k / best  # it/s


def _backends(x: torch.Tensor, name: str):
  """The sides of a race on ``x``'s device: the kernel and its twin on
  CUDA, the twin alone on the CPU."""
  if x.is_cuda:
    return ["kernel", "plain"]
  print(f"{name}[kernel]: not available on this device ({x.device.type})",
        flush=True)
  return ["plain"]


def race_demosaic(h, w, k, reps, device):
  rng = np.random.default_rng(0)
  phases = torch.from_numpy(
      rng.random((1, 4, h // 2, w // 2)).astype(np.float32)).to(device)
  out = {}
  for backend in _backends(phases, "demosaic"):
    its = _chain(lambda p, b=backend: bayer.demosaic_phases(
        p, BayerPattern.RGGB, backend=b, out_dtype=torch.float32),
        phases, k, reps)
    out[backend] = its
    print(f"demosaic[{backend}]: {its:8.1f} it/s", flush=True)
  if len(out) == 2:
    print(f"demosaic: kernel/plain speedup x{out['kernel'] / out['plain']:.2f}",
          flush=True)


def race_decode(h, w, k, reps, device):
  rng = np.random.default_rng(0)
  raws = torch.from_numpy(rng.integers(0, 256, size=(1, h, w * 3 // 2),
                                       dtype=np.uint8)).to(device)
  from taichi_image_tpu_torch.models.camera_isp import load_raw_phases
  out = {}
  for backend in _backends(raws, "decode12"):
    its = _chain(lambda r, b=backend: load_raw_phases(
        r, "packed12", torch.bfloat16, backend=b), raws, k, reps)
    out[backend] = its
    print(f"decode12[{backend}]:{' ' * (7 - len(backend))}{its:8.1f} it/s",
          flush=True)
  if len(out) == 2:
    print(f"decode12: kernel/plain speedup x{out['kernel'] / out['plain']:.2f}",
          flush=True)


def race_resize_torch(h, w, k, reps, device):
  # both sides run float32 on the same device
  from taichi_image_tpu_torch.ops import interpolate
  rng = np.random.default_rng(0)
  img = torch.from_numpy(rng.random((h, w, 3)).astype(np.float32)).to(device)

  def ours(x):
    y = interpolate._resize_bilinear(
        x, (int(w * 0.8), int(h * 0.8)), (0.8, 0.8),
        torch.float32, torch.float32)
    return interpolate.transform(y, interpolate.ImageTransform.rotate_90)

  its = _chain(ours, img, k, reps)
  print(f"resize+rot90[port/{img.device.type}]: {its:8.1f} it/s", flush=True)

  t = torch.from_numpy(rng.random((1, 3, h, w)).astype(np.float32)).to(device)

  def tfn(x):
    y = F.interpolate(x, scale_factor=0.8, mode="bilinear",
                      align_corners=False)
    return torch.rot90(y, k=-1, dims=(2, 3))

  try:
    tc = torch.compile(tfn)
    _ = tc(t)
    how = "torch.compile"
  except Exception:
    tc, how = tfn, "torch eager"  # compile unavailable: eager
  its = _chain(tc, t, k, reps)
  print(f"resize+rot90[{how}/{t.device.type}]: {its:8.1f} it/s "
        "(same dtype f32, same device)", flush=True)


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--size", type=int, nargs=2, default=(2160, 3840))
  parser.add_argument("--k", type=int, default=10)
  parser.add_argument("--reps", type=int, default=3)
  parser.add_argument("--races", default="demosaic,decode12,resize")
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)
  h, w = args.size
  device = torch.device(args.device)
  races = args.races.split(",")
  if "demosaic" in races:
    race_demosaic(h, w, args.k, args.reps, device)
  if "decode12" in races:
    race_decode(h, w, args.k, args.reps, device)
  if "resize" in races:
    race_resize_torch(h, w, args.k, args.reps, device)


if __name__ == "__main__":
  main()
