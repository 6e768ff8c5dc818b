#!/usr/bin/env python3
"""Host cost of the port's tracer (``utils/profiling.py``) on a host-bound
``process`` loop, on one Hopper card.

    cd <tree> && python3 <repo>/tools/torch_tracer_cost.py [--calls 2000] \\
        [--modes off,unmarked,on] [--out results.json]

``<tree>`` is any checkout of the port (a parent's ``git archive`` too): its
``taichi_image_tpu_torch`` is imported from the current directory. CameraBF16
on 6 x 256x384 packed12 sets already on the card: a set's kernels take a few
tens of microseconds, well under the host's time a call, so every call's
host time is its own and the launch queue never fills (each turn of 250
calls ends with a device sync, whose wait is reported: it stays near zero
while the loop is bound by the host). Each call is timed on the host clock,
in each of ``--modes``, in turns: the tracer off; where the tree has one,
``on`` (no profiler session), with its set markers where the tree has
them; and ``unmarked``, the tracer on without its set markers (skipped
where the tree has none). Prints one JSON line: the median and quartiles of
microseconds a call in each mode, and in each mode with the tracer on its
spans a set, its own host work a set (``isp.process`` less ``isp.launch``)
beside the launchers' time and its cost over ``off``; with the markers,
their counters a set (the card's span of a set, its wait between sets, the
sets in flight) and their cost over ``unmarked`` (``markers_us``), and
``empty_set_us``: an empty set-opening span's host us without and with the
markers (on new events and on events given back by a snapshot), whose
difference is the markers' own cost a set, and the host us a set of the
snapshot that times the sets.
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


def _add(agg: dict, snap: dict) -> None:
  """Add one turn's snapshot of the tracer to a mode's aggregates."""
  spans = snap["spans"]
  agg["calls"] += spans["isp.process"]["calls"]
  agg["spans"] += sum(s["calls"] for n, s in spans.items()
                      if n != "isp.load")
  agg["process_ns"] += spans["isp.process"]["ns"]
  agg["launch_ns"] += spans.get("isp.launch", {"ns": 0})["ns"]
  agg["launchers_ns"] += sum(snap["launch_ns"].values())
  for k, v in snap.get("markers", {}).items():
    agg["markers"][k] = agg["markers"].get(k, 0) + v


def _empty_sets(profiling, dev, marked_stream) -> dict:
  """The host us of an empty set-opening span with the tracer on (median
  of turns of 2,000 spans each, in turns): ``unmarked``; ``marked``, each
  turn on new events, as in a traced window that takes no snapshot;
  ``reused``, on the events of the turn before, which the snapshot after
  each turn timed and gave back; and ``snapshot_us``, that snapshot's host
  us a set it timed. ``markers_us``
  is ``marked`` less ``unmarked``: the markers' own cost a set on the hot
  path, free of the loop's spread. Each set's end completes at once, so
  each new set pops one."""
  import itertools
  import torch
  us = {"unmarked": [], "marked": [], "reused": []}
  snap_us = []
  sets = itertools.count()
  profiling.enable()
  for _ in range(7):
    for mode in us:
      profiling._stream = ((lambda device: None) if mode == "unmarked"
                           else marked_stream)
      if mode == "marked":
        for marks in profiling._devices.values():
          marks.spare.clear()
      t0 = time.perf_counter_ns()
      for _ in range(2000):
        with profiling.span("isp.process", sets, dev):
          pass
      us[mode].append((time.perf_counter_ns() - t0) / 2000 / 1e3)
      torch.cuda.synchronize(dev)
      t0 = time.perf_counter_ns()
      profiling.snapshot()
      if mode == "reused":
        snap_us.append((time.perf_counter_ns() - t0) / 2000 / 1e3)
  profiling.disable()
  profiling._stream = marked_stream
  profiling.reset()
  out = {m: statistics.median(t) for m, t in us.items()}
  out["snapshot_us"] = statistics.median(snap_us)
  out["markers_us"] = out["marked"] - out["unmarked"]
  return out


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--calls", type=int, default=2000)
  ap.add_argument("--modes", default="off,unmarked,on",
                  help="comma-separated: off, unmarked, on (each skipped "
                  "where the tree lacks it)")
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

  has = {"off": True, "on": hasattr(profiling, "tracing"),
         "unmarked": hasattr(profiling, "_stream")}
  modes = [m for m in args.modes.split(",") if has.get(m)]
  times = {m: [] for m in modes}
  # per mode with the tracer on: its spans' calls, ns and launchers' ns
  seen = {m: {"calls": 0, "spans": 0, "process_ns": 0, "launch_ns": 0,
              "launchers_ns": 0, "markers": {}} for m in modes if m != "off"}
  marked_stream = getattr(profiling, "_stream", None)
  sync_wait_us = []
  i = 0
  while len(times[modes[-1]]) < args.calls:
    for mode in modes:
      if mode == "unmarked":
        profiling._stream = lambda device: None
      if mode != "off":
        profiling.enable()
      for _ in range(TURN):
        t0 = time.perf_counter_ns()
        isp.process(pool[i % 4])
        times[mode].append((time.perf_counter_ns() - t0) / 1e3)
        i += 1
      if mode != "off":
        profiling.disable()
      if mode == "unmarked":
        profiling._stream = marked_stream
      t0 = time.perf_counter_ns()
      torch.cuda.synchronize(dev)
      sync_wait_us.append((time.perf_counter_ns() - t0) / 1e3)
      if mode != "off":
        _add(seen[mode], profiling.snapshot())
        profiling.reset()

  out = {"card": torch.cuda.get_device_name(dev),
         "sync_wait_us": statistics.median(sync_wait_us),
         **{m: _quartiles(t) for m, t in times.items()}}
  for mode, agg in seen.items():
    sets = agg["calls"]
    out[mode].update(
        spans_a_set=agg["spans"] / sets,
        driver_self_us=(agg["process_ns"] - agg["launch_ns"]) / sets / 1e3,
        launch_call_us=agg["launchers_ns"] / sets / 1e3)
    if "off" in out:
      out[mode]["cost_us"] = out[mode]["median_us"] - out["off"]["median_us"]
    m = agg["markers"]
    if m.get("sets"):
      out[mode].update(
          marked_sets=m["sets"],
          set_device_us=m["set_device_ns"] / m["sets"] / 1e3,
          host_wait_us=(m["wait_ns"] / m["waited_sets"] / 1e3
                        if m["waited_sets"] else None),
          sets_in_flight=m["in_flight"] / m["sets"])
      if "unmarked" in out:
        out[mode]["markers_us"] = (out[mode]["median_us"]
                                   - out["unmarked"]["median_us"])
  if has["unmarked"]:
    out["empty_set_us"] = _empty_sets(profiling, dev, marked_stream)
  line = json.dumps(out)
  print(line, flush=True)
  if args.out:
    with open(args.out, "w") as f:
      f.write(line + "\n")


if __name__ == "__main__":
  main()
