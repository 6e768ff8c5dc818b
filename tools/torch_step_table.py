#!/usr/bin/env python3
"""Time the RGB 6x4K and resize->1920 steps of each class of the PyTorch
port in the current directory with chip_smoke.py's ``bench_step`` and
``profile_step``: the step with the u8 checksum and without it (device
ms and host enqueue ms per step, median of 5 x 10 chained steps under
sync-debug "error"), the device busy share and the device operations per
step. Needs one Hopper card.

    cd <tree> && python3 <repo>/tools/torch_step_table.py \\
        <repo>/chip_smoke.py [--out results.json]

``<tree>`` is any checkout of the port (the parent's ``git archive`` as
well as this one's), so that two trees are timed by the same code: its
``taichi_image_tpu_torch`` is imported from the current directory, the
timing from the given ``chip_smoke.py``. Run two trees in turns in one
call (parent, change, change, parent) to compare them on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("chip_smoke")
  ap.add_argument("--out")
  args = ap.parse_args(argv)
  sys.path.insert(0, ".")
  spec = importlib.util.spec_from_file_location("chip_smoke", args.chip_smoke)
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  from taichi_image_tpu_torch.ops import hopper

  card = cs.phase_device()
  inputs = cs._inputs()
  plan = ((1920, 1080), 1920 / cs.W)
  out = dict(card=card)
  for dtype, sfx in hopper.DTYPE_SUFFIX.items():
    for step, kw in (("6x4K", {}), ("resize1920", dict(plan=plan))):
      name = f"{cs.CLASSES[sfx]} {step}"
      a = cs._step_args(dtype, **kw)
      times, host, _ = cs.bench_step(inputs, a)
      bare, bare_host, _ = cs.bench_step(inputs, a, checksum=False)
      busy, ops = cs.profile_step(name, inputs, a)
      r = out[name] = dict(
          step_ms=statistics.median(times), host_ms=statistics.median(host),
          bare_ms=statistics.median(bare),
          bare_host_ms=statistics.median(bare_host), busy=busy, ops=ops)
      print(f"{name}: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()
                                    if v is not None) + f"; {card}",
            flush=True)
  print(json.dumps(out), flush=True)
  if args.out:
    with open(args.out, "w") as f:
      json.dump(out, f, indent=1)


if __name__ == "__main__":
  main()
