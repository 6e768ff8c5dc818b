#!/usr/bin/env python3
"""The host time of one K2 launch (``ops/hopper/demosaic.demosaic_stencil``)
with its launch-argument cache and without it, at the 6x4K main step's
shape (6 x 4 x 1080 x 1920 phases, RGGB MHC, no CCM, stride-8 sample),
for each working dtype, on one Hopper card.

    python3 tools/torch_k2_launch_host.py [--out results.json]

Each call is timed on the host clock (``time.perf_counter`` around the
wrapper call alone), after a synchronize, so the launch queue is empty
as at the start of a step. "uncached" empties the cache before the call
(outside the timed part), so the wrapper makes the tap variant and the
parameter block with numpy as it did before the cache. The two modes run
in turns (cached, uncached, uncached, cached), ``--calls`` calls each,
after 20 warm-up calls; the median per call of each is printed with the
card's name and power limit. Run it from the repository root.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--calls", type=int, default=300)
  ap.add_argument("--out")
  args = ap.parse_args(argv)
  sys.path.insert(0, ".")
  import torch
  from taichi_image_tpu_torch.ops import bayer
  from taichi_image_tpu_torch.ops.hopper import demosaic as hd

  if not torch.cuda.is_available():
    raise SystemExit("torch_k2_launch_host: no CUDA device")
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  dev = torch.device("cuda")
  n, hh, wh = 6, 1080, 1920
  weights = bayer._demosaic_tables(bayer.BayerPattern.RGGB, "mhc")
  out = dict(card=card)
  for dtype in (torch.bfloat16, torch.float16, torch.float32):
    phases = torch.rand((n, 4, hh, wh), device=dev).to(dtype)
    fin = bayer._finish_spec_for(bayer.BayerPattern.RGGB, "mhc", hh, wh,
                                 None, dtype)

    def call(cached):
      if not cached:
        hd._LAUNCH_ARGS.clear()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      hd.demosaic_stencil(phases, weights, fin, 8)
      return (time.perf_counter() - t0) * 1e6

    for _ in range(20):
      call(True)
    times = {True: [], False: []}
    for cached in (True, False, False, True):
      times[cached] += [call(cached) for _ in range(args.calls)]
    # the numpy work the cache saves, alone
    t0 = time.perf_counter()
    for _ in range(args.calls):
      hd.tap_variant(weights)
      hd.stencil_params(weights, fin)
    numpy_us = (time.perf_counter() - t0) / args.calls * 1e6
    r = out[str(dtype).removeprefix("torch.")] = dict(
        cached_us=statistics.median(times[True]),
        uncached_us=statistics.median(times[False]), numpy_us=numpy_us)
    print(f"K2 launch host time, {dtype}: " + ", ".join(
        f"{k} {v:.2f}" for k, v in r.items()) + f"; {card}", flush=True)
  print(json.dumps(out), flush=True)
  if args.out:
    with open(args.out, "w") as f:
      json.dump(out, f, indent=1)


if __name__ == "__main__":
  main()
