#!/usr/bin/env python3
"""Where the one-rank NCCL camera step's time goes beside ``process``:
6 cameras at 4K, CameraBF16, on one Hopper card.

    python3 tools/torch_nccl_step_probe.py [--out results.json]

In a one-rank NCCL group (file:// rendezvous in a temporary directory):
the host time per call of one ``all_reduce`` of 2 and of 5 floats, and of
``metering_update_ca`` on the 6x4K step's sample with and without the
group (wall clock over 200 calls, then one synchronize; CUDA events for
the device time); then the camera step's and ``process``'s host enqueue
per step (K chained steps, with the u8 checksum), each one's profile
(device operations per step, busy share; chip_smoke.py's
``profile_step``) and its functions by own host time under cProfile. Run
it from the repository root (it imports chip_smoke.py).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import sys
import tempfile
import time

CALLS = 200


def _per_call(fn):
  """(host us per call, device us per call) of ``fn`` over CALLS calls,
  after 20 warm-up calls."""
  import torch
  for _ in range(20):
    fn()
  torch.cuda.synchronize()
  a = torch.cuda.Event(enable_timing=True)
  b = torch.cuda.Event(enable_timing=True)
  a.record()
  t0 = time.perf_counter()
  for _ in range(CALLS):
    fn()
  host = (time.perf_counter() - t0) / CALLS * 1e6
  b.record()
  b.synchronize()
  return host, a.elapsed_time(b) / CALLS * 1e3


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--out")
  args = ap.parse_args(argv)
  sys.path.insert(0, ".")
  import torch
  import torch.distributed as dist
  from torch.distributed.device_mesh import init_device_mesh
  import chip_smoke as cs
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch import parallel
  from taichi_image_tpu_torch.models import camera_isp as ci
  from taichi_image_tpu_torch.ops import hopper

  card = cs.phase_device()
  hopper.build_all()
  torch.cuda.set_device(0)
  out = {"card": card}
  with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0)
    try:
      group = dist.group.WORLD
      v2 = torch.zeros(2, device="cuda")
      v5 = torch.zeros(5, device="cuda")
      sample = torch.rand(cs.N_CAM, 3, cs.H // 8, cs.W // 8, device="cuda",
                          dtype=torch.bfloat16)
      prev = torch.zeros(9, device="cuda")
      n = cs.N_CAM * (cs.H // 8) * (cs.W // 8)
      calls = {
          "all_reduce MAX of 2 floats": lambda: dist.all_reduce(
              v2, op=dist.ReduceOp.MAX, group=group),
          "all_reduce SUM of 5 floats": lambda: dist.all_reduce(
              v5, group=group),
          "metering_update_ca": lambda: ci.metering_update_ca(sample, prev,
                                                              0.9),
          "metering_update_ca, one-rank NCCL group": lambda: (
              ci.metering_update_ca(sample, prev, 0.9, group=group,
                                    n_total=n)),
      }
      for what, fn in calls.items():
        host, dev = _per_call(fn)
        out[what] = dict(host_us=host, device_us=dev)
        cs.log(f"{what}: host {host:.1f} us, device {dev:.1f} us per call "
               f"(mean of {CALLS}); {card}")
      # does a call return before the device reaches it? Each one queued
      # behind a kernel that spins for about 20 ms
      for what, fn in (("add_", lambda: v2.add_(1)),
                       ("all_reduce", calls["all_reduce MAX of 2 floats"])):
        waits = []
        for _ in range(5):
          torch.cuda.synchronize()
          torch.cuda._sleep(40_000_000)
          t0 = time.perf_counter()
          fn()
          waits.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        out[f"{what} behind a 20 ms kernel"] = dict(host_ms=waits)
        cs.log(f"{what} queued behind a ~20 ms kernel: host "
               f"{', '.join(f'{w:.3f}' for w in waits)} ms per call; {card}")

      isp = ttit.CameraBF16(ttit.BayerPattern.RGGB, device="cuda")
      mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("cam",))
      step = parallel.sharded_step_for_isp(isp, mesh,
                                           (cs.N_CAM, cs.H, cs.WB))
      inputs = cs._inputs()
      chains = {
          "process": lambda i: cs._chain_api(i, "CameraBF16", False),
          "camera step": lambda i: cs._chain_step(i, step),
      }
      for which, chain in chains.items():
        chain(inputs)
        torch.cuda.synchronize()
        host = []
        for _ in range(cs.REPS):
          t0 = time.perf_counter()
          chain(inputs)
          host.append((time.perf_counter() - t0) * 1e3 / cs.K)
          torch.cuda.synchronize()
        busy, ops = cs.profile_step(f"CameraBF16 6x4K {which}", inputs,
                                    None, chain=chain)
        prof = cProfile.Profile()
        prof.enable()
        chain(inputs)
        prof.disable()
        torch.cuda.synchronize()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(12)
        cs.log(f"{which}: cProfile of {cs.K} chained steps, by own time:\n"
               + "\n".join(text.getvalue().splitlines()[4:24]))
        out[which] = dict(host_ms=statistics.median(host), busy_share=busy,
                          ops_per_step=ops)
        cs.log(f"{which}: host enqueue {statistics.median(host):.4f} "
               f"ms/step (median of {cs.REPS} x {cs.K}, with the u8 "
               f"checksum), {ops:g} device operations per step; {card}")
    finally:
      dist.destroy_process_group()
  if args.out:
    with open(args.out, "w") as f:
      json.dump(out, f, indent=1)


if __name__ == "__main__":
  main()
