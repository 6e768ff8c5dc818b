#!/usr/bin/env python3
"""Profile the RGB and I420 steps (6x4K and resize->1920, each class) of
the PyTorch port in the current directory with chip_smoke.py's
``profile_step``: device operations per step, busy share and the
kernels by device time. Needs one Hopper card.

    cd <tree> && python3 <repo>/tools/torch_i420_step_profile.py \\
        <repo>/chip_smoke.py [--out results.json]

``<tree>`` is any checkout of the port (the parent's ``git archive`` as
well as this one's), so that two trees are profiled by the same code: its
``taichi_image_tpu_torch`` is imported from the current directory, the
profiling from the given ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
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

  inputs = cs._inputs()
  plan = ((1920, 1080), 1920 / cs.W)
  out = {}
  for dtype, sfx in hopper.DTYPE_SUFFIX.items():
    for step, kw in (("6x4K", {}), ("resize1920", dict(plan=plan))):
      for fmt in ("rgb", "yuv420"):
        name = f"{cs.CLASSES[sfx]} {step} {fmt}"
        busy, ops = cs.profile_step(
            name, inputs, cs._step_args(dtype, color_format=fmt, **kw))
        out[name] = dict(busy=busy, ops=ops)
  print(json.dumps(out), flush=True)
  if args.out:
    with open(args.out, "w") as f:
      json.dump(out, f, indent=1)


if __name__ == "__main__":
  main()
