#!/usr/bin/env python3
"""Where the time of M's one cooperative launch goes (``meter_kernel`` in
``taichi_image_tpu_torch/ops/hopper/csrc/meter.cu``), on one Hopper card.

    python3 tools/torch_meter_stages.py [--out results.json]

Builds a copy of ``meter.cu`` with ``%globaltimer`` stamps (ns) added
between the kernel's stages, runs it through the port's wrapper on a
random sample of the 6x4K main path's shape (6 x 3 x 270 x 480) and of
the 6x8K whole frame's (6 x 3 x 540 x 1440) in each working dtype, and
prints, for each, the median over 25 launches of each stage's end after
the first block's start: the last block's start, pass 1 (the last thread
to finish it, then its block's reduction), the grid barrier (first and
last block through), the bounds read, pass 2, its block reduction, the
last block's count, its reduction of the partials and the finalize; then
the uninstrumented kernel's device time a launch from a profiler trace
of 50 launches (over the launches the trace holds). The
stamps cost a few atomics a block. Run it from the repository root; the
card's name and power limit are printed with the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

STAMPS = r'''
__device__ unsigned long long g_stamps[16];
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_MIN(i) if (threadIdx.x == 0) atomicMin(&g_stamps[i], stamp_now());
#define STAMP_MAX(i) if (threadIdx.x == 0) atomicMax(&g_stamps[i], stamp_now());
#define STAMP(i) if (threadIdx.x == 0) g_stamps[i] = stamp_now();
'''
ACCESS = r'''
extern "C" int stamps_reset() {
  unsigned long long init[16];
  for (int i = 0; i < 16; ++i) init[i] = (i == 0 || i == 4) ? ~0ull : 0ull;
  return cudaMemcpyToSymbol(g_stamps, init, sizeof(init));
}
extern "C" int stamps_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
'''
# (statement of meter_kernel, its instrumented form): stamp 0 and 1 the
# first and last block's start, 4 and 5 the first and last through the
# barrier; the others the last block (STAMP_MAX) or the finalizing block
EDITS = [
    ("  const Share sh = share_of(g);\n",
     "  STAMP_MIN(0) STAMP_MAX(1)\n  const Share sh = share_of(g);\n"),
    ("  MinMax mm = block_reduce(bounds_pass(x, g, sh, runs), sh_mm);\n",
     "  MinMax mm = bounds_pass(x, g, sh, runs);\n  STAMP_MAX(2)\n"
     "  mm = block_reduce(mm, sh_mm);\n  STAMP_MAX(3)\n"),
    ("  cg::this_grid().sync();\n",
     "  cg::this_grid().sync();\n  STAMP_MIN(4) STAMP_MAX(5)\n"),
    ("  mm = grid_mm;\n", "  mm = grid_mm;\n  STAMP_MAX(6)\n"),
    ("  const StatsPartial st = block_reduce(\n"
     "      stats_pass(x, g, sh, runs, norm_of(mm.mn, mm.mx, prev, t)), "
     "sh_st);\n",
     "  StatsPartial st = stats_pass(x, g, sh, runs, norm_of(mm.mn, mm.mx, "
     "prev, t));\n  STAMP_MAX(7)\n  st = block_reduce(st, sh_st);\n"
     "  STAMP_MAX(8)\n"),
    ("  if (!last_block(&sc->count[1], g.blocks)) return;\n",
     "  if (!last_block(&sc->count[1], g.blocks)) return;\n  STAMP(9)\n"),
    ("  const StatsPartial tot = reduce_stats(sc->stats, g.blocks, sh_st);\n"
     "  if (threadIdx.x != 0) return;\n  float fs[5];\n  round_sums(tot, fs);\n"
     "  finalize(mm.mn, mm.mx, tot.lmin, tot.lmax, fs, prev, t, n_total, v, "
     "out);\n",
     "  const StatsPartial tot = reduce_stats(sc->stats, g.blocks, sh_st);\n"
     "  STAMP(10)\n  if (threadIdx.x != 0) return;\n  float fs[5];\n"
     "  round_sums(tot, fs);\n  finalize(mm.mn, mm.mx, tot.lmin, tot.lmax, fs,"
     " prev, t, n_total, v, out);\n  STAMP(11)\n"),
]
NAMES = ["last block started", "pass 1 (last thread)", "pass 1 reduced",
         "barrier (first through)", "barrier (last through)", "bounds read",
         "pass 2 (last thread)", "pass 2 reduced", "last block counted",
         "partials reduced", "finalized"]


def instrumented(src: str) -> str:
  start = src.index("    meter_kernel(")
  end = src.index("\n}\n", start) + 1
  body = src[start:end]
  for old, new in EDITS:
    if body.count(old) != 1:
      raise SystemExit(f"meter.cu's meter_kernel changed: no unique {old!r}")
    body = body.replace(old, new)
  src = src[:start] + body + src[end:]
  return src.replace("namespace {\n", STAMPS + "namespace {\n", 1) + ACCESS


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--out")
  args = ap.parse_args(argv)
  sys.path.insert(0, ".")
  import torch
  from taichi_image_tpu_torch.ops import hopper
  from taichi_image_tpu_torch.ops.hopper import meter
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  if not torch.cuda.is_available():
    raise SystemExit("torch_meter_stages: no CUDA device")
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  tmp = Path(tempfile.mkdtemp())
  for f in hopper.CSRC.glob("*.cuh"):
    shutil.copy(f, tmp)
  (tmp / "meter.cu").write_text(instrumented(
      (hopper.CSRC / "meter.cu").read_text()))
  so = tmp / "meter_stages.so"
  proc = subprocess.run([hopper._nvcc(), *hopper.nvcc_flags("meter.cu"),
                         "-o", str(so), str(tmp / "meter.cu")],
                        capture_output=True, text=True)
  if proc.returncode:
    raise SystemExit(f"nvcc failed:\n{proc.stderr}")
  lib = ctypes.CDLL(str(so))
  gen = torch.Generator(device="cuda").manual_seed(0)
  out = dict(card=card)
  for dtype, sfx in hopper.DTYPE_SUFFIX.items():
    kernel = meter.KERNELS[dtype]
    plain_fn = kernel._launcher()
    staged = getattr(lib, kernel.symbol)
    staged.argtypes, staged.restype = kernel.argtypes, ctypes.c_int
    for shape in ((6, 3, 270, 480), (6, 3, 540, 1440)):
      samp = torch.rand(shape, generator=gen, device="cuda").to(dtype)
      prev = torch.rand(9, generator=gen, device="cuda")
      kernel._fn = staged
      rows = []
      for _ in range(30):
        torch.cuda.synchronize()
        if lib.stamps_reset():
          raise SystemExit("stamps_reset failed")
        meter.meter(samp, prev, 0.9)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        if lib.stamps_read(buf):
          raise SystemExit("stamps_read failed")
        rows.append([(buf[i] - buf[0]) / 1e3 for i in range(1, 12)])
      stages = {n: statistics.median(r[i] for r in rows[5:])
                for i, n in enumerate(NAMES)}
      kernel._fn = plain_fn
      for _ in range(3):
        meter.meter(samp, prev, 0.9)
      torch.cuda.synchronize()
      with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
          meter.meter(samp, prev, 0.9)
        torch.cuda.synchronize()
      # per traced launch: a trace may drop events
      kern = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
      traced = sum(e.count for e in kern)
      dev_us = (sum(e.self_device_time_total for e in kern) / traced
                if traced else float("nan"))
      p = meter.plan(shape, dtype)
      key = f"{sfx} {'x'.join(map(str, shape))}"
      out[key] = dict(stages_us=stages, device_us=dev_us, traced=traced,
                      grid=p.grid, per_block=p.per_block, cached=p.cached)
      print(f"{key} ({p.grid} blocks of {p.per_block} runs, pass 2 from "
            f"{'shared' if p.cached else 'device'} memory): "
            + ", ".join(f"{n} {v:.2f}" for n, v in stages.items())
            + f" us after the first block's start; device time "
            f"{dev_us:.2f} us a launch (profiler, {traced} of 50 launches "
            f"traced); {card}", flush=True)
  print(json.dumps(out), flush=True)
  if args.out:
    with open(args.out, "w") as f:
      json.dump(out, f, indent=1)


if __name__ == "__main__":
  main()
