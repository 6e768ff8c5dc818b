"""The readings that the limits of ``correct`` are set from, in one
process:

    python3 -m isp_bench.calibrate --workload <name> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...]

For each seed a short window of the cell at its own size and load, and
the program's numbers against the reference; for each control seed, the
numbers of each of the configuration's controls (``compare.CONTROLS``:
the program's class one precision down, run in the program's place on
the same sets, or the reference in that precision on the same chain).
One JSON line a reading on standard output. The benchmark's runs never
run a control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from isp_bench import compare, harness, manifest
from isp_bench.reference import isp as ref


def control_values(kind: str, what: str, cfg: dict, traffic: dict, loop,
                   seed: int, seconds: float, device: torch.device,
                   pipe: ref.Pipeline, pool: torch.Tensor, chain: list,
                   positions) -> dict:
  """The numbers of one control against the reference ``pipe`` of the
  run on ``seed`` (its ``pool``, ``chain`` and kept ``positions``)."""
  color = traffic["color_format"]
  if kind == "program":
    _, ctx = harness.execute(compare.as_control(cfg, what), traffic, seed,
                             seconds, False, device, loop)
    if not torch.equal(ctx.pool, pool):
      raise RuntimeError("the control's run made other sets from the seed")
    final, kept = harness.free_program(ctx)
    return compare.readings(pipe, ctx.chain, kept, final, color)
  outs, final = compare.reference_control(cfg, what, pool, chain, positions,
                                          color)
  return compare.readings(pipe, chain, outs, final, color)


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--seeds", type=int, nargs="+", required=True)
  p.add_argument("--control-seeds", type=int, nargs="*", default=())
  args = p.parse_args(argv)

  if not torch.cuda.is_available():
    print("isp_bench.calibrate: no CUDA device", file=sys.stderr)
    return 2
  device = torch.device("cuda", 0)
  m = manifest.load()
  w = manifest.workload(m, args.workload)
  cfg = manifest.config(m, w["config"])
  traffic = manifest.traffic(w["traffic"])
  loop = manifest.module("loops", traffic["loop"])
  color = traffic["color_format"]
  for seed in args.seeds:
    run, ctx = harness.execute(cfg, traffic, seed, args.seconds, False,
                               device, loop)
    final, kept = harness.free_program(ctx)
    pipe = ref.Pipeline(cfg, ctx.pool, compare.work_dtype(cfg))
    values = compare.readings(pipe, ctx.chain, kept, final, color)
    print(json.dumps({"workload": w["name"], "seed": seed, "who": "program",
                      "sets": run.loop.completed, **values}), flush=True)
    if seed in args.control_seeds:
      for kind, what in compare.controls(cfg):
        values = control_values(kind, what, cfg, traffic, loop, seed,
                                args.seconds, device, pipe, ctx.pool,
                                ctx.chain, sorted(kept))
        print(json.dumps({"workload": w["name"], "seed": seed,
                          "who": f"{kind}:{what}", **values}), flush=True)
        torch.cuda.empty_cache()
    del run, ctx, kept, pipe
    torch.cuda.empty_cache()
  return 0


if __name__ == "__main__":
  sys.exit(main())
