#!/usr/bin/env python3
"""What limits the PyTorch port's first K4 I420 kernel (commit 6086e79's
``finish_yuv420_<T>``, one thread per run of 8 half-res pixels in all 12
planes): its loads and stores, or its arithmetic. Needs one Hopper card.

    python3 tools/torch_i420_limiter.py TREE [--out results.json]

TREE is a checkout of a commit whose ``csrc/finish.cu`` holds that kernel
(``git archive 6086e79``). The script copies TREE's
``taichi_image_tpu_torch`` into ``TREE/_limiter/<variant>/`` three times and
patches the copies' ``finish.cu``:

  * ``kernel``: unchanged;
  * ``loads``:  the tonemap and the I420 arithmetic cut to a byte pack of
    the loaded words (the same loads, the same stores): the time of the
    bytes alone;
  * ``arith``:  every thread reads image 0's first 64 half-res rows (12
    planes x 64 x 1920 bf16, 2.9 MB, which stays in the 50 MB L2), the
    stores unchanged: the time of the arithmetic alone.

Each copy is built in its own process (all at once), then timed in turn at
6 x 4K from the real main path's p (decode -> stencil -> metering -> map on
seeded random raws): CUDA events around batches of 10 launches, median of 7,
bf16/f16/f32 without a transform and bf16 under rotate_90, beside K4 RGB
(``finish_planar_u8``). Registers per instantiation come from ptxas' report.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

PKG = "taichi_image_tpu_torch"
FINISH = Path(PKG) / "ops" / "hopper" / "csrc" / "finish.cu"

# (old, new) replacements of each variant; each old text must occur once
_PACK = """\
      for (int k = 0; k < kV; ++k) {
        q[c][k] = (raw[pp % kRing][c].w[k * RawRun<T>::kWords / kV] >>
                   (8 * (k & 3))) & 0xFFu;
      }
"""
_LOADS_ARITH = """\
    for (int k = 0; k < kV; ++k) {
      yw[opr][k >> 1] |= (q[0][k] ^ q[1][k] ^ q[2][k])
                         << (8 * (2 * (k & 1) + opc));
      acc[0][k] = __uint_as_float(pp ? __float_as_uint(acc[0][k]) ^ q[0][k]
                                     : q[0][k]);
      acc[1][k] = __uint_as_float(pp ? __float_as_uint(acc[1][k]) ^ q[1][k]
                                     : q[1][k]);
    }
  }
  unsigned vw[kV / 4] = {}, uw[kV / 4] = {};
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    vw[k >> 2] |= (__float_as_uint(acc[0][k]) & 0xFFu) << (8 * (k & 3));
    uw[k >> 2] |= (__float_as_uint(acc[1][k]) & 0xFFu) << (8 * (k & 3));
  }
"""


def _patch(src: str, variant: str) -> str:
  def once(text, old, new):
    if text.count(old) != 1:
      raise SystemExit(f"{variant}: {old[:60]!r} occurs {text.count(old)} "
                       "times in finish.cu: not the kernel this probe patches")
    return text.replace(old, new)

  if variant == "kernel":
    return src
  head = src.index("template <typename T, bool kLinear, bool kSwap>\n"
                   "__global__ void __launch_bounds__(256)\n"
                   "    finish_yuv420_kernel")
  body = src[head:]
  if variant == "arith":
    return src[:head] + once(
        body, "const T* xb = x + static_cast<size_t>(b) * 12 * plane "
        "+ i * f.wh + j0;", "const T* xb = x + (i & 63) * f.wh + j0;")
  body = once(body, "      tone_run<T, kLinear>(raw[pp % kRing][c], sc, f, "
              "q[c]);\n", _PACK)
  a = body.index("    for (int k = 0; k < kV; ++k) {\n      if constexpr "
                 "(kDot) {")
  b = body.index("  // the output's 2x2 blocks")
  return src[:head] + body[:a] + _LOADS_ARITH + body[b:]


def _registers(log: str) -> dict:
  """{mangled I420 kernel: registers} from ptxas -v."""
  out, fn = {}, None
  for line in log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      fn = m.group(1)
    m = re.search(r"Used (\d+) registers", line)
    if m and fn and "finish_yuv420_kernel" in fn:
      out[fn] = int(m.group(1))
  return out


_CHILD = r"""
import json, statistics, sys, torch
sys.path.insert(0, {root!r})
from taichi_image_tpu_torch.ops.hopper import finish
if {build_only}:
  print(finish.KERNELS[torch.bfloat16].build()); sys.exit()
from taichi_image_tpu_torch.models import camera_isp as ci
from taichi_image_tpu_torch.ops.bayer import BayerPattern
from taichi_image_tpu_torch.ops.interpolate import ImageTransform

def median_ms(fn, reps=7, batch=10):
  for _ in range(2): fn()
  t = []
  for _ in range(reps):
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(batch): fn()
    b.record(); b.synchronize(); t.append(a.elapsed_time(b) / batch)
  return statistics.median(t)

gen = torch.Generator(device="cuda").manual_seed(0)
raws = torch.randint(0, 256, (6, 2160, 5760), generator=gen, device="cuda",
                     dtype=torch.uint8)
out = {{}}
for dtype, sfx in ((torch.bfloat16, "bf16"), (torch.float16, "f16"),
                   (torch.float32, "f32")):
  ph = ci.load_raw_phases(raws, "packed12", dtype)
  x12, samp = ci.demosaic_phases(ph, BayerPattern.RGGB, out_dtype=dtype,
                                 sample_step=4)
  m = ci.metering_update_ca(samp, torch.zeros(9, device="cuda"), 0.0)
  p, mx = ci.reinhard_map_max_ca(x12, m, 1.0, 1.0, 0.0, dtype)
  out[f"finish_yuv420_{{sfx}}"] = median_ms(
      lambda: finish.finish_yuv420(p, mx, 1.0))
  if sfx == "bf16":
    out["finish_yuv420_bf16 rotate_90"] = median_ms(
        lambda: finish.finish_yuv420(p, mx, 1.0,
                                     transform=ImageTransform.rotate_90))
  out[f"finish_{{sfx}} (K4 RGB)"] = median_ms(
      lambda: finish.finish_planar_u8(p, mx, 1.0))
  del ph, x12, samp, p, mx
print(json.dumps(out))
"""


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("tree")
  ap.add_argument("--out")
  args = ap.parse_args(argv)
  tree = Path(args.tree).resolve()
  src = (tree / FINISH).read_text()
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip()
  print(smi, flush=True)
  roots = {}
  for variant in ("kernel", "loads", "arith"):
    root = tree / "_limiter" / variant
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(tree / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (root / FINISH).write_text(_patch(src, variant))
    roots[variant] = root

  def child(root, build_only):
    return [sys.executable, "-c", _CHILD.format(root=str(root),
                                                build_only=build_only)]
  builds = {v: subprocess.Popen(child(r, True), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
            for v, r in roots.items()}
  result = {"card": smi, "variants": {}}
  for v, proc in builds.items():
    so, se = proc.communicate()
    if proc.returncode:
      raise SystemExit(f"{v}: build failed\n{se}")
    lib = Path(so.strip().splitlines()[-1])
    result["variants"][v] = {"registers": _registers(
        lib.with_suffix(".log").read_text())}
  for v, root in roots.items():
    proc = subprocess.run(child(root, False), capture_output=True, text=True)
    if proc.returncode:
      raise SystemExit(f"{v}: timing failed\n{proc.stderr}")
    result["variants"][v]["ms"] = json.loads(proc.stdout.strip()
                                             .splitlines()[-1])
    print(v, json.dumps(result["variants"][v]), flush=True)
  if args.out:
    Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
  main()
