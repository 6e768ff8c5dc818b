#!/usr/bin/env python3
"""Host cost of the port's tracer (``utils/profiling.py``) on a host-bound
``process`` loop, on one Hopper card.

    cd <tree> && python3 <repo>/tools/torch_tracer_cost.py [--calls 2000] \\
        [--modes off,on] [--out results.json]

``<tree>`` is any checkout of the port (a parent's ``git archive`` too): its
``taichi_image_tpu_torch`` is imported from the current directory. CameraBF16
on 6 x 256x384 packed12 sets already on the card: a set's kernels take a few
tens of microseconds, well under the host's time a call, so every call's
host time is its own and the launch queue never fills (each turn of 250
calls ends with a device sync, whose wait is reported: it stays near zero
while the loop is bound by the host). Each call is timed on the host clock,
in each of ``--modes``, in turns: the tracer off, and, where the tree has
one, on (no profiler session). Prints one JSON line: the median and
quartiles of microseconds a call in each mode, and with the tracer on its
spans a set and its own host work a set (``isp.process`` less
``isp.launch``) beside the launchers' time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

TURN = 250


def _quartiles(us: list) -> dict:
  q1, q2, q3 = statistics.quantiles(us, n=4)
  return {"median_us": q2, "q1_us": q1, "q3_us": q3, "calls": len(us)}


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--calls", type=int, default=2000)
  ap.add_argument("--modes", default="off,on",
                  help="comma-separated: off, on (on is skipped where the "
                  "tree has no tracer)")
  ap.add_argument("--out")
  args = ap.parse_args(argv)
  sys.path.insert(0, ".")
  import torch
  from taichi_image_tpu_torch.models.camera_isp import CameraBF16
  from taichi_image_tpu_torch.ops.bayer import BayerPattern
  from taichi_image_tpu_torch.utils import profiling

  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev)
  gen.manual_seed(2 ** 31 + 19)
  pool = torch.randint(0, 256, (4, 6, 256, 384 * 3 // 2), generator=gen,
                       dtype=torch.uint8, device=dev)
  isp = CameraBF16(BayerPattern.RGGB, device=dev)
  for i in range(200):
    isp.process(pool[i % 4])
  torch.cuda.synchronize(dev)

  modes = [m for m in args.modes.split(",")
           if m == "off" or (m == "on" and hasattr(profiling, "tracing"))]
  times = {m: [] for m in modes}
  sync_wait_us = []
  i = 0
  while len(times[modes[-1]]) < args.calls:
    for mode in modes:
      if mode == "on":
        profiling.enable()
      for _ in range(TURN):
        t0 = time.perf_counter_ns()
        isp.process(pool[i % 4])
        times[mode].append((time.perf_counter_ns() - t0) / 1e3)
        i += 1
      if mode == "on":
        profiling.disable()
      t0 = time.perf_counter_ns()
      torch.cuda.synchronize(dev)
      sync_wait_us.append((time.perf_counter_ns() - t0) / 1e3)

  out = {"card": torch.cuda.get_device_name(dev),
         "sync_wait_us": statistics.median(sync_wait_us),
         **{m: _quartiles(t) for m, t in times.items()}}
  if "on" in modes and "off" in modes:
    snap = profiling.snapshot()
    spans = snap["spans"]
    sets = spans["isp.process"]["calls"]
    launch = spans.get("isp.launch", {"ns": 0, "calls": 0})
    out["on"].update(
        spans_a_set=sum(s["calls"] for n, s in spans.items()
                        if n != "isp.load") / sets,
        driver_self_us=(spans["isp.process"]["ns"] - launch["ns"]) / sets
        / 1e3,
        launch_call_us=sum(snap["launch_ns"].values()) / sets / 1e3,
        cost_us=out["on"]["median_us"] - out["off"]["median_us"])
  line = json.dumps(out)
  print(line, flush=True)
  if args.out:
    with open(args.out, "w") as f:
      f.write(line + "\n")


if __name__ == "__main__":
  main()
