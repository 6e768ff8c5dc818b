#!/usr/bin/env python3
"""Where the host time of the per-image API's lazy list path goes, beside
``process`` on the same raws: 6 cameras at 4K, CameraBF16, on one Hopper
card.

    python3 tools/torch_lazy_host_profile.py [--out results.json]

For each path (``process``; each camera's ``load_packed12`` then one
``tonemap_reinhard``): the host time per step of K chained steps (wall
clock, no checksum, the device left to run behind), the same chain under
cProfile with its functions by own time, and the host time of the lazy
path's pieces alone (the six loads, the key and the ``torch.cat``, the
step). Run it from the repository root (it imports chip_smoke.py's
inputs).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import sys
import time


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--out")
  args = ap.parse_args(argv)
  sys.path.insert(0, ".")
  import torch
  import chip_smoke as cs
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch.ops import hopper

  card = cs.phase_device()
  hopper.build_all()
  inputs = cs._inputs()

  def chain(lazy):
    isp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cuda")
    for raws in inputs:
      if lazy:
        isp.tonemap_reinhard([isp.load_packed12(r) for r in raws])
      else:
        isp.process(raws)

  out = {"card": card}
  for name, lazy in (("process", False), ("lazy", True)):
    chain(lazy)
    torch.cuda.synchronize()
    host = []
    for _ in range(7):
      t0 = time.perf_counter()
      chain(lazy)
      host.append((time.perf_counter() - t0) * 1e3 / len(inputs))
      torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    chain(lazy)
    prof.disable()
    torch.cuda.synchronize()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(25)
    out[name] = dict(host_ms=host, median_host_ms=statistics.median(host))
    cs.log(f"{name}: host {statistics.median(host):.4f} ms/step (median of "
           f"7 chains of {len(inputs)} steps, runs {host}); {card}")
    cs.log(buf.getvalue())

  # the lazy path's pieces alone, each over the K input batches
  isp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cuda")
  handles = [[isp.load_packed12(r) for r in raws] for raws in inputs]
  times = {}
  for piece in ("6 x load_packed12", "_lazy_key + torch.cat",
                "fused step (tonemap_reinhard)"):
    runs = []
    for _ in range(7):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      for k, raws in enumerate(inputs):
        if piece == "6 x load_packed12":
          [isp.load_packed12(r) for r in raws]
        elif piece == "_lazy_key + torch.cat":
          isp._lazy_key(handles[k])
          torch.cat([h._lazy[0] for h in handles[k]])
        else:
          isp.tonemap_reinhard([isp.load_packed12(r) for r in raws])
      runs.append((time.perf_counter() - t0) * 1e3 / len(inputs))
    times[piece] = statistics.median(runs)
    cs.log(f"piece {piece}: host {times[piece]:.4f} ms/step (median of 7)")
  out["pieces_host_ms"] = times
  if args.out:
    with open(args.out, "w") as f:
      json.dump(out, f, indent=1)


if __name__ == "__main__":
  sys.exit(main())
