#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA Hopper GPU and check it.

Run from the repository root:

    python3 chip_smoke.py [--out results.json]

Phases (each prints a line; any failure raises and exits non-zero):

1. device   CUDA available, capability (9, 0); the card's name and power
            limit as nvidia-smi reports them.
2. build    nvcc builds the eight kernel sources (csrc/*.cu, one process
            each, in parallel) from this checkout: K1-K4, K4's I420 mode,
            K12 and the planar I420 tonemap form for bf16, f16 and f32,
            the CFA split from u16, f16, f32 and packed16 bytes (K1's
            packed16 mode) to each,
            the bf16 front-fused K7 and the u8 planar I420 conversion (35
            kernels); each source's register range and spill bytes from
            ptxas (every source must show 0 spill bytes), and the registers
            of each I420 kernel instantiation; the SASS instructions of
            each K1, K3 and K12 instantiation and of K7 (cuobjdump), and
            of their loops per pixel (K3), column pair (K1), output (K12)
            or half-res pixel (K7, with its map loop).
3. kernels  each kernel against its plain PyTorch twin on the card, at
            the 6 x 2160 x 5760-byte packed12 shape of the main path, at
            a small odd shape, at a ragged mid-size shape (515 x 1003
            half-res: tiles cut on both axes, rows that are not whole
            vectors, planes that are not 16-byte aligned) and at a cut
            shape (520 x 1000: whole vectors, tiles cut on both axes):
            K1-K4, K2 and K7 for every tap-mask variant (4 patterns x 2
            methods, with and without a CCM), K4's two modes, each under
            the 8 transforms, and its I420 mode likewise (the bf16 dot or
            the f32 chains by the dtype), the planar I420 kernel at the
            shape's full-res frame and at 6 x 1920 x 1080 (6x4K) or a
            2-pixel-narrower one (ragged), its tonemap form (both modes,
            gamma 1 and 2.2, the 8 transforms) on K3's map of the x0.5
            resize (6 x 1920 x 1080) or of a planar frame of the shape's
            full-res size, K12 at x0.5 (6x4K ->
            1920x1080), x0.37, x1.5 and x0.25 on the path its wrapper
            plans and, at x0.5, also on the direct path that any resize
            can take, K3 on the resized planar image, K3 with degenerate
            scalars (range 0, range < 0, every pixel at m0) and with NaN
            pixels at the small shapes, K7 against K2 -> K3 on the card;
            K2's banded mode (a band with a zero-padded halo row each
            side, the finish spec's gates at the image's edges, its own
            rows stored) for each band kind (first, interior, last, the
            frame as one band with both gates) at ODD (all 8 variants,
            with and without a CCM) and RAGGED in each dtype, the bands
            joined bitwise the whole-frame kernel, K7 on each band bitwise
            K2 -> K3 and within K3's contract of its twin, and each band
            kind at the 6x8K band (6 x 4 x 274 x 3840) with and without a
            CCM within K2's contract of its twin, K7 there in bf16 bitwise
            K2 -> K3 and within K3's contract of its twin; kernel
            and twin times from CUDA events around batches of 10 calls,
            K3 in both adapt modes, K4 under every transform that swaps
            the axes, K12's direct path at x0.5 and, in bf16, K12 at x1.5
            and x0.37, K4's I420 mode (Reinhard, linear, rotate_90), the
            planar I420 kernel at 6 x 1920 x 1080 and 6x4K, its tonemap
            form at 6 x 1920 x 1080 (Reinhard, linear, rotate_90), K2's
            banded mode on an interior 6x8K band in each dtype, and each
            time's bound (logical bytes over 3.35 TB/s, or f32
            operations over 67 TFLOP/s, the larger; a resize counts
            only the x12 its taps touch) and share of it. Then K1's
            packed16 mode and the CFA split (each instantiation) against
            their twins, bitwise, at the same four frames (packed16 also
            from an odd address), and timed at 6x4K against their bounds;
            the f16 and f32 splits beside one torch copy_ of the
            phase-ordered view (their library call).
4. slice    for each class, CameraBF16, Camera16 and Camera32
            (RGGB, device="cuda").process over 5 frames of 6 x 4K with
            the EMA carried over, compared frame by frame with the
            all-plain route on the card; the launch counts of that run
            (each class through its own dtype's four kernels); a small
            input against the plain route on the CPU.
5. routes   the other routes the same way, each with the launch counts
            set to 0 just before it and read just after, held to the
            kernels it must launch and no others: resize_width=1920 with
            rotate_90 for each class, scale 0.37, flip_horiz for each
            class, the linear tonemap at gamma 2.2 for each class,
            metering stride 7, and the front-fused route
            (TAICHI_IMAGE_TPU_FRONT_FUSED=1 set for that route only); then
            with color_format="yuv420" on 3 frames: the main path and
            resize_width=1920 with rotate_90 of each class (the tonemap
            form once a step, no u8 conversion), resize_width=1920 with
            the linear tonemap at gamma 2.2, stride 7 and front-fused, each
            output (Y, VU) against the plain route's. Then the raw
            formats and the per-image API: each class with packed16, u16,
            f16 and f32 raws (5 frames at 6x4K) and with a tiny 2 x 6-pixel
            frame (the demosaic's denominator route in torch, K1, K3 and K4
            on one-row planes) against the all-plain route; the lazy list
            path (6 x load_packed12 -> tonemap_reinhard) of each class
            bitwise process on a fresh ISP; a mixed staged list (load_16u,
            one handle forced, update_metering, tonemap_linear) against
            the plain route's two steps; process_stream bitwise process
            frame by frame; resize_image of a loaded image bitwise the
            plain stages; on CameraBF16, f32 (H, W, 3) images through
            tonemap_reinhard and tonemap_only (K3<f32>, then one cast)
            against the plain map, and a Camera32 phase handle through
            resize_image (K12<f32>, then one cast) bitwise the plain
            resize.
   host     the module-level entry points given numpy arrays run on the
            card by default: bayer_to_rgb of a 4K CFA launches K2<f32>
            (within 1 count of the CPU's plain route on a crop);
            rgb_to_bayer, kernel.conv, the packed codecs and PackedMono12
            bitwise their CPU results.
5b. large   process_large at 6x8K (raws 6 x 4320 x 11520): each class
            over 2 frames with the EMA carried, with driver "auto",
            "flat", "loop" and "scan", each bitwise process on the same
            frames (the band drivers launching the stencil once a band);
            CameraBF16's first frame against the all-plain route; then in
            CameraBF16 resize_width=3840 with rotate_90, I420, the linear
            tonemap at gamma 2.2 and packed16 raws, through "auto" and
            "loop", bitwise process.
5c. parallel the parallel package: (a) CameraBF16(device="cuda:0")
            process and the per-image API bitwise device="cuda" over 2
            frames, and use_kernel on a cuda:0 tensor; (b) in this process
            a one-rank NCCL group (file:// rendezvous in a temporary
            directory): the camera step, the row step (one shard, both
            edge gates on) and the 1 x 1 grid step of each class at 6x4K
            over 2 frames, and of CameraBF16 with I420 output and with
            resize_width=1920 and rotate_90, each bitwise the unsharded
            step (metrics and output) and launching the kernels it
            launches, as many times; the NCCL camera step timed beside
            process (CameraBF16, in turns) under sync-debug "error"; the
            group destroyed; (c) two processes on cuda:0 in a gloo group:
            the camera step (3 + 3 cameras) and the row step (2 x 1080
            rows) of CameraBF16 with RGB, I420 and resize->1920 with
            rotate_90 (metering stride 4), of Camera16 and of Camera32,
            each rank against the unsharded step it runs itself (metrics
            within 1e-5, u8 within 1 count, 2 in bf16 on < 0.1% of
            bytes), the worst over the ranks all_reduced and printed; (d)
            four processes: the 2 x 2 grid of CameraBF16 the same way.
            The launches of every sharded step add to the kernel table's.
5d. apps    the apps and tooling layer at full width, its files in a
            temporary directory: (a) a scan folder of 6 cameras x 3
            packed12 3840x2160 frames (a seeded scene), run through
            tonemap_scan at its defaults (Camera32, rotate_90), with
            --resize_width 1920 --dtype bf16 and with --fetch yuv420, each
            pipelined and with --pipeline_depth 0: 3 JPEGs each, the two
            runs bitwise, the last set bitwise write_image of a fresh
            ISP's process outputs, and exactly the kernels of the route
            launched once a set; (b) tonemap_scan's sets/s from the page
            cache without JPEGs (48 sets, twice; and serial), writing
            JPEGs (12 sets), process's sets/s fed host (pageable) sets and
            sets on the card, with and without fetching each output, and
            a set's parts one at a time (file reads, the stack into a
            pinned buffer, pinned and pageable uploads and downloads);
            (c) bench.camera_isp (Camera16, 200 iterations), bench.bayer
            (1000), bench.interpolate and bench.shootout at 2160x3840,
            their lines logged and each kernel side's launches counted;
            (d) tonemap_images on two 2160x3840 u16 PNG CFAs,
            decode_packed on one 4K raw, compare_bayer on a 1080x1920 PNG,
            each with its kernels' launches; (e) profiling.trace around a
            process step names the port's kernels, and types.from_dlpack
            of a CUDA tensor shares its memory. Its launches add to the
            kernel table's.
6. timing   for each class, the step by bench.py's method (K chained
            steps, a distinct XOR byte per step, every output summed into
            one scalar read at the end, median of 5) under torch's
            sync-debug "error" mode (the step must not sync with the
            host); the step without the checksum; the device busy share
            and the device operations per step from a torch.profiler
            trace; a per-stage table. Then the same
            step method for the resize->1920 step of each class and the
            front-fused bf16 step, each resize->1920 step and the
            front-fused step with its profile (busy share, device
            operations per step) and its host enqueue without the
            checksum; the I420 marginal of the 6x4K and resize->1920
            steps of each class (RGB and I420 steps in turns, RGB, I420,
            I420, RGB), and the profile of each I420 step (busy share,
            device operations per step). Then each class's 6x4K step with
            packed16, u16 and f32 raws beside packed12, and the lazy list
            path's step against process (CameraBF16, in turns), both
            under the sync-debug "error" mode. Then each class's 6x8K
            step through process_large with the whole-frame driver and
            with the band loop (in turns, with and without the checksum),
            each one's profile and its peak of device memory in one step.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import statistics
import subprocess
import sys
import time

N_CAM, H, W = 6, 2160, 3840
WB = W * 3 // 2
ODD = (3, 38, 150)          # small odd shape: H/2 = 19, W/2 = 50
RAGGED = (2, 1030, 3009)    # H/2 = 515, W/2 = 1003
CUT = (2, 1040, 3000)       # H/2 = 520, W/2 = 1000: whole vectors, cut tiles
HBM_BPS = 3.35e12           # H100 SXM memory rate (data sheet, 700 W)
F32_FLOPS = 67e12           # H100 SXM f32 rate outside the tensor cores
FRAMES = 5
YUV_FRAMES = 3              # frames of each I420 route
K = 10                      # chained steps per timed run
REPS = 5                    # timed runs (median)
CLASSES = {"bf16": "CameraBF16", "f16": "Camera16", "f32": "Camera32"}
FRONT_FUSED = "TAICHI_IMAGE_TPU_FRONT_FUSED"


def log(msg: str) -> None:
  print(msg, flush=True)


def median_ms(fn, reps: int = 7, warmup: int = 2, batch: int = 10) -> float:
  """Median over ``reps`` of the device time per call of ``fn()`` in ms:
  one CUDA-event pair around ``batch`` back-to-back calls, so the host's
  launch latency overlaps the device's work instead of adding to it."""
  import torch
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(reps):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(batch):
      fn()
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b) / batch)
  return statistics.median(times)


def ulps(a, b) -> int:
  """Largest distance in ulps between two tensors of one float dtype
  (bf16, f16 or f32), on the ordered integer view (+0 and -0
  coincide)."""
  import torch
  it, mag = ((torch.int32, 0x7FFFFFFF) if a.dtype == torch.float32
             else (torch.int16, 0x7FFF))

  def key(t):
    s = t.contiguous().view(it).to(torch.int64)
    return torch.where(s < 0, -(s & mag), s)
  return int((key(a) - key(b)).abs().max().item())


def phase_device():
  import torch
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
  cap = torch.cuda.get_device_capability(0)
  if cap != (9, 0):
    raise SystemExit(f"chip_smoke: need a capability (9, 0) card, got {cap}")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  log(f"device: {torch.cuda.get_device_name(0)}, capability {cap}, "
      f"torch {torch.__version__}, CUDA {torch.version.cuda}")
  log(card)
  return card


# sources redesigned for the card, which must build without spills
NO_SPILLS = ("decode.cu", "demosaic.cu", "finish.cu", "front_fused.cu",
             "reinhard.cu", "resize.cu", "split.cu", "yuv420.cu")
# K3's and K1's instantiations in a mangled name: the kernel, T, then two
# bools (K3: color_adapt, vector path; K1: vector path, IDS layout)
_KERNEL_ARGS = re.compile(r"(map_kernel|decode12_kernel)I(13__nv_bfloat16|"
                          r"6__half|f)Lb([01])ELb([01])E")
_T_NAMES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
# K12's instantiations: T, then the aligned path; K7's: the tap-mask
# variant
_RESIZE_ARGS = re.compile(r"resize_kernelI(13__nv_bfloat16|6__half|f)"
                          r"Lb([01])E")
_RESIZE_PATHS = ("direct", "aligned")  # csrc/resize.cu's kAligned
_FRONT_ARGS = re.compile(r"front_fused_kernelILi(\d)E")
# the I420 kernels' instantiations: K4's I420 mode without a swap (T, the
# linear tonemap) and the I420 tile kernel (T, the sum, the linear tonemap,
# the swap, flip_y, flip_x)
_I420_ROWS = re.compile(r"finish_yuv420_kernelI(13__nv_bfloat16|6__half|f)"
                        r"Lb([01])E")
_I420_TILE = re.compile(r"i420_tile_kernelI(13__nv_bfloat16|6__half|f)"
                        r"L\w*?I420E(\d)E((?:Lb[01]E){4})")
_I420_KINDS = ("dot", "chains", "planar")
# elements per pass of K3's and K1's vector loops, one 16-byte run of T:
# K3 maps that many pixels, K1 unpacks that many column pairs
PER_PASS = {"bf16": 8, "f16": 8, "f32": 4}


def _cuobjdump(path, flag):
  from torch.utils.cpp_extension import CUDA_HOME
  return subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", flag, str(path)],
                        capture_output=True, text=True, check=True).stdout


def sass_counts(path):
  """{mangled kernel: (SASS instructions, instructions of its longest
  loop, registers, the instructions of each loop)} of a built library,
  from ``cuobjdump -sass`` and ``-res-usage`` (NOPs not counted)."""
  regs = dict(re.findall(r"Function (\S+):\s*REG:(\d+)",
                         _cuobjdump(path, "-res-usage")))
  out = {}
  for chunk in _cuobjdump(path, "-sass").split("Function : ")[1:]:
    name = chunk.split(None, 1)[0]
    insns = []  # (address, instruction)
    for line in chunk.splitlines():
      m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
      if m and not m.group(2).strip().startswith("NOP"):
        insns.append((int(m.group(1), 16), m.group(2)))
    loops = []
    for at, ins in insns:
      t = re.search(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+)", ins)
      if t and int(t.group(1), 16) < at:  # a backward branch: a loop
        loops.append(sum(int(t.group(1), 16) <= a <= at for a, _ in insns))
    out[name] = (len(insns), max(loops, default=0), int(regs.get(name, 0)),
                 sorted(loops))
  return out


def phase_build():
  from taichi_image_tpu_torch.ops import hopper
  t0 = time.perf_counter()
  libs = hopper.build_all()
  dt = time.perf_counter() - t0
  log(f"build: {len(libs)} sources, {len(hopper.KERNELS)} kernels in "
      f"{dt:.1f} s")
  sources = {}
  for source, path in libs.items():
    text = path.with_suffix(".log").read_text()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", text))
    sources[source] = dict(kernels=len(regs), registers=[min(regs),
                                                         max(regs)],
                           spill_bytes=spills)
    log(f"  {source}: {path.name}, {len(regs)} kernels, {min(regs)}-"
        f"{max(regs)} registers, {spills} spill bytes")
    if spills and source in NO_SPILLS:
      which = [name for name, st, ld in re.findall(
          r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) "
          r"bytes spill stores, (\d+) bytes spill loads", text)
               if int(st) + int(ld)]
      raise AssertionError(f"{source} spills {spills} bytes in {which}")
    i420 = {}  # registers of the I420 kernels' instantiations
    fn = None
    for line in text.splitlines():
      m = re.search(r"Compiling entry function '(\S+)'", line)
      fn = m.group(1) if m else fn
      m = re.search(r"Used (\d+) registers", line)
      if not (m and fn):
        continue
      a, t = _I420_ROWS.search(fn), _I420_TILE.search(fn)
      if a:
        key = f"finish_yuv420_{_T_NAMES[a.group(1)]} linear={a.group(2)}"
      elif t:  # the 8 flips and 2 modes of one sum and swap, as a range
        swap = re.findall(r"[01]", t.group(3))[1]
        key = (f"tile {_I420_KINDS[int(t.group(2))]}_{_T_NAMES[t.group(1)]}"
               f" swap={swap}")
      else:
        continue
      lo, hi = i420.get(key, (999, 0))
      i420[key] = (min(lo, int(m.group(1))), max(hi, int(m.group(1))))
    if i420:
      sources[source]["i420_registers"] = i420
      log(f"  {source} I420 kernels, registers: " + ", ".join(
          f"{k} {lo}-{hi}" if lo != hi else f"{k} {lo}"
          for k, (lo, hi) in sorted(i420.items())))
  # SASS of K3 and K1: the vector loop's instructions (static: the
  # branches around the slow paths included) per pixel or column pair
  for source in ("reinhard.cu", "decode.cu"):
    rows = {}
    try:
      counts = sass_counts(libs[source])
    except (OSError, subprocess.CalledProcessError) as e:
      log(f"  {source}: SASS not measured (cuobjdump: {e})")
      continue
    for mangled, (total, loop, regs, _) in counts.items():
      m = _KERNEL_ARGS.search(mangled)
      if not m:
        continue
      kind, t, a, b = m.groups()
      if kind == "map_kernel":
        name, vec = f"reinhard_{_T_NAMES[t]} ca={a} vec={b}", b
      else:
        name, vec = f"decode_{_T_NAMES[t]} vec={a} ids={b}", a
      per = loop / PER_PASS[_T_NAMES[t]] if vec == "1" else None
      unit = "pixel" if kind == "map_kernel" else "column pair"
      rows[name] = dict(sass=total, loop=loop, registers=regs,
                        per_element=per, unit=unit)
      log(f"  {name}: {regs} registers, {total} SASS instructions, "
          f"longest loop {loop}" + (f"; {per:.1f} per {unit}" if per else ""))
    sources[source]["sass"] = rows
  # SASS of K12 and K7: K12's row loop per output (a run of kV columns
  # times 3 colors); K7's row loop (the edge and the interior run of
  # front_fused.cu's kV = 2 pixels, so both are counted) and its map loop
  # (kU = 2 maps of 3 channels, run 4 times a run)
  for source, pattern in (("resize.cu", _RESIZE_ARGS),
                          ("front_fused.cu", _FRONT_ARGS)):
    rows = {}
    try:
      counts = sass_counts(libs[source])
    except (OSError, subprocess.CalledProcessError) as e:
      log(f"  {source}: SASS not measured (cuobjdump: {e})")
      continue
    for mangled, (total, loop, regs, loops) in counts.items():
      m = pattern.search(mangled)
      if not m:
        continue
      if source == "resize.cu":
        t, path = m.groups()
        name = f"resize_{_T_NAMES[t]} {_RESIZE_PATHS[int(path)]}"
        per, unit = loop / (3 * PER_PASS[_T_NAMES[t]]), "output"
        extra = ""
      else:
        if m.group(1) != "0":  # the variants differ only in their live taps
          continue
        name = "front_fused_bf16 variant=0"
        per, unit = loop / 2, "pixel (edge + interior run)"
        inner = max((n for n in loops if n < loop), default=0)
        extra = f"; map loop {inner} for 2 maps"
      rows[name] = dict(sass=total, loop=loop, registers=regs,
                        per_element=per, unit=unit, loops=loops)
      log(f"  {name}: {regs} registers, {total} SASS instructions, "
          f"longest loop {loop}; {per:.1f} per {unit}{extra}")
    sources[source]["sass"] = rows
  return dict(seconds=dt, sources=sources)


def _check_bitwise(what, k, p):
  import torch
  if k.shape != p.shape or not torch.equal(k, p):
    d = ((k.float() - p.float()).abs().max().item()
         if k.shape == p.shape else "shape")
    raise AssertionError(f"{what}: not bitwise (max |d| {d})")


def _check_map(what, kp, km, pp, pm):
  """K3's contract: p within 1 ulp of T, the max within 1e-6 relative."""
  u = ulps(kp, pp)
  rel = ((km - pm).abs() / pm.abs().clamp_min(1e-30)).max().item()
  if u > 1 or rel > 1e-6:
    raise AssertionError(f"{what}: {u} ulps, max rel {rel:.3g}")


def _map_edge_cases(kt, x12, scal, scal_ca):
  """K3 against its twin where the map degenerates: range 0 (every
  quotient inf or NaN), range < 0, every pixel at m0 (a zero dividend
  everywhere, also with range 0 and < 0), and NaN pixels; both adapt
  modes. Returns the largest |kernel - twin| of p."""
  import torch
  from taichi_image_tpu_torch.ops.hopper import reinhard

  def with_(s, at):  # scal with entries {index: value} replaced
    s = s.clone()
    for i, v in at.items():
      s[i] = v
    return s

  at_m0 = torch.full_like(x12, 0.25)  # 0.25 is exact in every T
  nan = x12.clone()
  nan.view(-1)[::97] = float("nan")
  worst = 0.0
  for ca, s in ((False, scal), (True, scal_ca)):
    rng = s[1].abs().item()
    cases = {
        "range 0": (x12, with_(s, {1: 0.0})),
        "range < 0": (x12, with_(s, {1: -rng})),
        "x == m0": (at_m0, with_(s, {0: 0.25})),
        "x == m0, range 0": (at_m0, with_(s, {0: 0.25, 1: 0.0})),
        "x == m0, range < 0": (at_m0, with_(s, {0: 0.25, 1: -rng})),
        "NaN pixels": (nan, s),
    }
    for name, (x, sc) in cases.items():
      kp, km = reinhard.reinhard_map(x, sc, ca, backend="kernel")
      pp, pm = reinhard.reinhard_map(x, sc, ca, backend="plain")
      _check_map(f"reinhard {kt} ca={int(ca)} {name}", kp, km, pp, pm)
      worst = max(worst, (kp.float() - pp.float()).abs().max().item())
  return worst


def _nbytes(*tensors) -> int:
  import torch
  total = 0
  for t in tensors:
    if isinstance(t, (tuple, list)):
      total += _nbytes(*t)
    elif isinstance(t, torch.Tensor):
      total += t.numel() * t.element_size()
    elif isinstance(t, _Bytes):
      total += t
  return total


def _time(results, name, call, inputs, ops=0, shape_note="6x4K",
          library=None):
  """Kernel and twin times, in turns plain, kernel, kernel, plain (with
  ``library``, one PyTorch call computing the same function: plain,
  kernel, library, library, kernel, plain); the lower median of each
  side. The bound is the larger of the logical bytes (``inputs`` read
  once, the kernel's outputs written once) over the memory rate and
  ``ops`` f32 operations over the f32 rate."""
  nbytes = _nbytes(inputs, call("kernel"))
  order = (("plain", "kernel", "library", "library", "kernel", "plain")
           if library else ("plain", "kernel", "kernel", "plain"))
  t = {}
  for b in order:
    fn = library if b == "library" else (lambda b=b: call(b))
    t.setdefault(b, []).append(median_ms(fn))
  by_bytes, by_ops = nbytes / HBM_BPS * 1e3, ops / F32_FLOPS * 1e3
  r = results[name] = dict(
      ms=min(t["kernel"]), plain_ms=min(t["plain"]), bytes=nbytes, ops=ops,
      bound_ms=max(by_bytes, by_ops),
      bound_by="bytes" if by_bytes >= by_ops else "operations",
      library_ms=min(t["library"]) if library else None)
  r["share"] = r["bound_ms"] / r["ms"]
  lib = ("" if library is None
         else f", library call {r['library_ms']:.4f} ms")
  log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
      f"{lib}; bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({nbytes} "
      f"bytes, {ops} f32 ops), {r['share']:.1%} of it ({shape_note}, median "
      "of 7 batches of 10)")


RESIZE_SCALES = (0.5, 0.37, 1.5, 0.25)


class _Bytes(int):
  """A count of bytes that ``_nbytes`` takes as it stands: the part of a
  tensor that a kernel must read, where that is not all of it."""


def _resize_x12_bytes(x12, taps):
  """The bytes of x12 that a resize must read: in each of the four
  phases (row parity, column parity), the half-res rows and columns that
  its taps touch, in 3 colors (at x0.5 all of x12; a downscale by more
  skips rows and columns)."""
  import torch

  def touched(lo, hi):
    t = torch.cat([lo, hi])
    return [torch.unique(t[t % 2 == p] >> 1).numel() for p in (0, 1)]
  rows, cols = touched(taps.r_lo, taps.r_hi), touched(taps.c_lo, taps.c_hi)
  return _Bytes(x12.shape[0] * 3 * x12.element_size()
                * sum(r * c for r in rows for c in cols))


BAND_8K = (N_CAM, 272, 3840)  # a 6x8K band: hb half-res rows, wh wide


def _band_kinds(hh, b):
  """(r0, r1, top_row, bot_row) of each band of at most b rows of an
  hh-row frame (gates as models/large.py sets them), then the frame as
  one band with both gates."""
  kinds = [(r0, min(r0 + b, hh), 1 if r0 == 0 else -1,
            min(r0 + b, hh) - r0 if r0 + b >= hh else -1)
           for r0 in range(0, hh, b)]
  return kinds + [(0, hh, 1, hh)]


def _check_banded(kt, phases, dtype, variants, ccm, scal, note):
  """K2's banded mode (and K7's gates, in bf16) against the twins on the
  card, for each band kind of ``phases`` (first, interior, last, and the
  whole frame as one band with both gates): a band of the frame with a
  zero-padded halo row on each side, its own rows stored. K2 bitwise
  without a CCM, <= 1 ulp of T with one, its sample the stored rows'
  (x12[:, :3, ::4, ::4]); the bands joined bitwise the whole-frame
  kernel (the same arithmetic per pixel, with a CCM too). K7 on each
  band: bitwise K2 (every row read) -> K3 on the card, K3's contract
  against its twin. Returns the band kinds' count."""
  import torch
  import torch.nn.functional as F
  from taichi_image_tpu_torch.ops import hopper
  from taichi_image_tpu_torch.ops.bayer import (_demosaic_tables,
                                                _stencil_finish_spec)
  from taichi_image_tpu_torch.ops.hopper import demosaic, front_fused
  from taichi_image_tpu_torch.ops.hopper import reinhard
  hh, wh = phases.shape[-2:]
  pad = F.pad(phases, (0, 0, 1, 1))
  kinds = _band_kinds(hh, 4 * -(-hh // 12))  # 3 bands on the sample grid
  for (pattern, method), cc in itertools.product(variants, (None, ccm)):
    w = _demosaic_tables(pattern, method)
    kv = f"{kt} {pattern.name} {method} cc={cc is not None}"
    whole, whole_s = demosaic.demosaic_stencil(
        phases, w, _stencil_finish_spec(w, hh, wh, cc, dtype), 4,
        backend="kernel")
    joined, joined_s = [], []
    for i, (r0, r1, top, bot) in enumerate(kinds):
      hb = r1 - r0
      band = pad[:, :, r0:r1 + 2].contiguous()
      fin = _stencil_finish_spec(w, hb + 2, wh, cc, dtype, top_row=top,
                                 bot_row=bot)
      what = f"demosaic banded {kv} rows {r0}:{r1} gates ({top}, {bot})"
      kx, ks = demosaic.demosaic_stencil(band, w, fin, 4, backend="kernel",
                                         rows=(1, hb + 1))
      px, ps = demosaic.demosaic_stencil(band, w, fin, 4, backend="plain",
                                         rows=(1, hb + 1))
      ux, us = ulps(kx, px), ulps(ks, ps)
      if (cc is None and (ux or us)) or max(ux, us) > 1:
        raise AssertionError(f"{what}: {ux}, {us} ulps from the twin")
      _check_bitwise(f"{what} sample", ks, kx[:, 0:3, ::4, ::4])
      note(f"demosaic_{hopper.DTYPE_SUFFIX[dtype]}", kx, px)
      if i < len(kinds) - 1:  # the bands, not the frame as one band
        joined.append(kx)
        joined_s.append(ks)
      if dtype == torch.bfloat16:
        fx, _ = demosaic.demosaic_stencil(band, w, fin, backend="kernel")
        cp, cm = reinhard.reinhard_map(fx, scal, False, backend="kernel")
        fp, fm = front_fused.front_fused(band, w, fin, scal,
                                         backend="kernel")
        _check_bitwise(f"front_fused banded {kv} rows {r0}:{r1} p", fp, cp)
        _check_bitwise(f"front_fused banded {kv} rows {r0}:{r1} max", fm,
                       cm)
        pp, pm = front_fused.front_fused(band, w, fin, scal,
                                         backend="plain")
        _check_map(f"front_fused banded {kv} rows {r0}:{r1} vs twin", fp,
                   fm, pp, pm)
        note("front_fused_bf16", fp, pp)
    _check_bitwise(f"demosaic banded {kv}: bands joined vs whole frame",
                   torch.cat(joined, 2), whole)
    _check_bitwise(f"demosaic banded {kv}: samples joined vs whole frame",
                   torch.cat(joined_s, 2), whole_s)
  return len(kinds)


def phase_kernels(results):
  """Each kernel against its plain twin on the card; fills ``results``
  {name: {ms, plain_ms, max_abs_err}} (kernel names, plus extra timed
  modes named "<kernel> <mode>")."""
  import torch
  from taichi_image_tpu_torch.models.camera_isp import (_plan_scales,
                                                        default_cc,
                                                        metering_update_ca)
  from taichi_image_tpu_torch.ops import hopper
  from taichi_image_tpu_torch.ops.bayer import (_TRANSFORM_SFF,
                                                BayerPattern,
                                                _demosaic_tables,
                                                _stencil_finish_spec)
  from taichi_image_tpu_torch.ops.hopper import decode, demosaic, finish
  from taichi_image_tpu_torch.ops.hopper import front_fused, reinhard, resize
  from taichi_image_tpu_torch.ops.hopper import yuv420
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform

  swaps = [t for t in ImageTransform if _TRANSFORM_SFF[t][0]]
  dev = torch.device("cuda")
  gen = torch.Generator(device=dev).manual_seed(0)
  ccm = tuple((default_cc * [1.8, 1.0, 2.1]).astype("float32").ravel()
              .tolist())
  weights = _demosaic_tables(BayerPattern.RGGB, "mhc")
  err = {name: 0.0 for name in hopper.KERNELS
         if name not in format_kernels()}

  def note(name, a, b):
    err[name] = max(err[name], (a.float() - b.float()).abs().max().item())

  for shape in ((N_CAM, H, WB), ODD, RAGGED, CUT):
    raws = torch.randint(0, 256, shape, generator=gen, device=dev,
                         dtype=torch.uint8)
    tag = "x".join(map(str, shape))
    for dtype, sfx in hopper.DTYPE_SUFFIX.items():
      kt = f"{tag} {sfx}"
      # K1: bitwise, both layouts
      for ids in (False, True):
        k = decode.decode12_phases(raws, ids, dtype, backend="kernel")
        p = decode.decode12_phases(raws, ids, dtype, backend="plain")
        if ulps(k, p):
          raise AssertionError(f"decode {kt} ids={ids}: not bitwise")
        note(f"decode_{sfx}", k, p)
      phases = decode.decode12_phases(raws, False, dtype, backend="kernel")
      hh, wh = phases.shape[-2:]
      # K2: bitwise without a CCM, <= 1 ulp of T with one, for every
      # tap-mask variant
      for pattern, method in demosaic.VARIANTS:
        w = _demosaic_tables(pattern, method)
        for cc in (None, ccm):
          kv = f"{kt} {pattern.name} {method} cc={cc is not None}"
          fin = _stencil_finish_spec(w, hh, wh, cc, dtype)
          kx, ks = demosaic.demosaic_stencil(phases, w, fin, 4,
                                             backend="kernel")
          px, ps = demosaic.demosaic_stencil(phases, w, fin, 4,
                                             backend="plain")
          ux, us = ulps(kx, px), ulps(ks, ps)
          if cc is None and (ux or us):
            raise AssertionError(f"demosaic {kv}: not bitwise ({ux}, {us})")
          if max(ux, us) > 1:
            raise AssertionError(f"demosaic {kv}: {max(ux, us)} ulps")
          if ulps(ks, kx[:, 0:3, ::4, ::4]):
            raise AssertionError(f"demosaic {kv}: sample != "
                                 "x12[:, :3, ::4, ::4]")
          note(f"demosaic_{sfx}", kx, px)
      fin = _stencil_finish_spec(weights, hh, wh, None, dtype)
      x12, samp = demosaic.demosaic_stencil(phases, weights, fin, 4,
                                            backend="kernel")
      metrics = metering_update_ca(samp, torch.zeros(9, device=dev), 0.0)
      if shape in (ODD, RAGGED):
        # K2's banded mode (and K7's gates): every variant at ODD, the
        # main one at RAGGED
        n_kinds = _check_banded(
            kt, phases, dtype,
            demosaic.VARIANTS if shape == ODD else demosaic.VARIANTS[:1],
            ccm, reinhard.reinhard_scal(metrics, 1.0, 1.0), note)
        log(f"kernels {kt}: demosaic banded ({n_kinds} band kinds"
            + (", 8 variants" if shape == ODD else "")
            + (", and front_fused's gates" if dtype == torch.bfloat16
               else "") + ") agrees with its twin and the whole frame")
      # K3: p <= 1 ulp of T, max within 1e-6 relative, both adapt modes
      for ca in (0.0, 0.5):
        scal = (reinhard.reinhard_scal_ca(metrics, 1.0, 1.0, ca) if ca
                else reinhard.reinhard_scal(metrics, 1.0, 1.0))
        kp, km = reinhard.reinhard_map(x12, scal, bool(ca), backend="kernel")
        pp, pm = reinhard.reinhard_map(x12, scal, bool(ca), backend="plain")
        _check_map(f"reinhard {kt} ca={ca}", kp, km, pp, pm)
        note(f"reinhard_{sfx}", kp, pp)
        note(f"reinhard_{sfx}", km, pm)
      scal_ca = reinhard.reinhard_scal_ca(metrics, 1.0, 1.0, 0.5)
      if shape != (N_CAM, H, WB):
        # degenerate scalars and NaN pixels, on both of K3's paths (CUT's
        # planes are whole runs, ODD's and RAGGED's are not)
        edge = _map_edge_cases(kt, x12, reinhard.reinhard_scal(
            metrics, 1.0, 1.0), scal_ca)
        err[f"reinhard_{sfx}"] = max(err[f"reinhard_{sfx}"], edge)
      # K4: bitwise, Reinhard and linear modes at gamma 1 and 2.2, each
      # under the 8 transforms at gamma 2.2
      scal0 = reinhard.reinhard_scal(metrics, 1.0, 1.0)
      p_cast, max_out = reinhard.reinhard_map(x12, scal0, False)
      lin = finish.linear_scal(metrics)
      for mode, src, sc in (("reinhard", p_cast, max_out),
                            ("linear", x12, lin)):
        cases = [(1.0, ImageTransform.none)]
        cases += [(2.2, t) for t in ImageTransform]
        for gamma, t in cases:
          ko = finish.finish_planar_u8(src, sc, gamma, mode, t,
                                       backend="kernel")
          po = finish.finish_planar_u8(src, sc, gamma, mode, t,
                                       backend="plain")
          _check_bitwise(f"finish {kt} {mode} gamma={gamma} {t.value}", ko,
                         po)
          note(f"finish_{sfx}", ko, po)
          # K4's I420 mode: Y and VU bitwise
          ky, kvu = finish.finish_yuv420(src, sc, gamma, mode, t,
                                         backend="kernel")
          py, pvu = finish.finish_yuv420(src, sc, gamma, mode, t,
                                         backend="plain")
          what = f"finish_yuv420 {kt} {mode} gamma={gamma} {t.value}"
          _check_bitwise(f"{what} Y", ky, py)
          _check_bitwise(f"{what} VU", kvu, pvu)
          note(f"finish_yuv420_{sfx}", ky, py)
          note(f"finish_yuv420_{sfx}", kvu, pvu)
          del ko, po, ky, kvu, py, pvu
      # K12: bitwise at x0.5, x0.37 (odd h', w'), x1.5 and x0.25, on the
      # path the wrapper plans and, where that is the aligned one, on the
      # direct one too; K3 on its output
      plans, paths = {}, []
      for scale in RESIZE_SCALES:
        size = (round(2 * wh * scale), round(2 * hh * scale))
        taps = resize.resize_taps(hh, wh, size,
                                  _plan_scales(2 * hh, 2 * wh, size, scale),
                                  dev)
        kr = resize.resize_x12(x12, taps, backend="kernel")
        pr = resize.resize_x12(x12, taps, backend="plain")
        _check_bitwise(f"resize {kt} x{scale} -> {size}", kr, pr)
        note(f"resize_{sfx}", kr, pr)
        pick = resize.plan(x12, taps)
        if pick != "direct":
          ko = resize._launch(x12, taps, "direct")
          _check_bitwise(f"resize {kt} x{scale} -> {size} direct", ko, pr)
        paths.append(f"x{scale} {pick}"
                     + (" + direct" if pick != "direct" else ""))
        kp, km = reinhard.reinhard_map(kr, scal0, False, backend="kernel")
        pp, pm = reinhard.reinhard_map(kr, scal0, False, backend="plain")
        _check_map(f"reinhard {kt} on planar {tuple(kr.shape)}", kp, km, pp,
                   pm)
        plans[scale] = (taps, kr)
        del kr, pr, kp, km, pp, pm
      # K7 (bf16): bitwise against K2 -> K3 on the card, K3's contract
      # against its twin
      if dtype == torch.bfloat16:
        for (pattern, method), cc in itertools.product(demosaic.VARIANTS,
                                                       (None, ccm)):
          kv = f"{kt} {pattern.name} {method} cc={cc is not None}"
          w = _demosaic_tables(pattern, method)
          fin_c = _stencil_finish_spec(w, hh, wh, cc, dtype)
          cx, _ = demosaic.demosaic_stencil(phases, w, fin_c,
                                            backend="kernel")
          cp, cm = reinhard.reinhard_map(cx, scal0, False, backend="kernel")
          fp, fm = front_fused.front_fused(phases, w, fin_c, scal0,
                                           backend="kernel")
          _check_bitwise(f"front_fused {kv} p", fp, cp)
          _check_bitwise(f"front_fused {kv} max", fm, cm)
          pp, pm = front_fused.front_fused(phases, w, fin_c, scal0,
                                           backend="plain")
          _check_map(f"front_fused {kv} vs twin", fp, fm, pp, pm)
          note("front_fused_bf16", fp, pp)
      # the planar I420 tonemap form: bitwise, both modes, gamma 1 and
      # 2.2 under the 8 transforms, on K3's map of the x0.5 resize (6x4K)
      # or of a planar frame of the shape's full-res size (RAGGED: rows not
      # whole copies, odd block counts; CUT: tiles cut on both axes)
      if shape == (N_CAM, H, WB):
        img = plans[0.5][1]
      else:
        img = (torch.rand((shape[0], 3, 2 * hh, 2 * wh), generator=gen,
                          device=dev) * 1.2).to(dtype)
        img.view(-1)[::13] = 0.0
      tp, tmx = reinhard.reinhard_map(img, scal0, False)
      for mode, src, sc in (("reinhard", tp, tmx), ("linear", img, lin)):
        for gamma, t in [(1.0, ImageTransform.none),
                         *((2.2, t) for t in ImageTransform)]:
          ky, kvu = yuv420.yuv420_planar_tone(src, sc, gamma, mode, t,
                                              backend="kernel")
          py, pvu = yuv420.yuv420_planar_tone(src, sc, gamma, mode, t,
                                              backend="plain")
          what = (f"yuv420_planar_tone {kt} {tuple(src.shape)} {mode} "
                  f"gamma={gamma} {t.value}")
          _check_bitwise(f"{what} Y", ky, py)
          _check_bitwise(f"{what} VU", kvu, pvu)
          note(f"yuv420_planar_tone_{sfx}", ky, py)
          note(f"yuv420_planar_tone_{sfx}", kvu, pvu)
      del img, tp, tmx, ky, kvu, py, pvu
      log(f"kernels {kt}: decode, demosaic (8 variants), reinhard"
          + (" (and its degenerate cases)" if shape != (N_CAM, H, WB) else "")
          + ", finish and its I420 mode (both modes, each under 8 "
          "transforms), the planar I420 tonemap form (the same), resize ("
          + ", ".join(paths) + ")"
          + (", front_fused (8 variants)" if dtype == torch.bfloat16 else "")
          + " agree with their plain twins")
      if dtype == torch.bfloat16:
        # the planar I420 kernel (u8 only): bitwise at the shape's full-res
        # frame and at 6 x 1920 x 1080 (6x4K) or 2 pixels narrower, which
        # no row's 16-pixel runs divide (the byte path)
        n_img = shape[0]
        for hw in ((2 * hh, 2 * wh),
                   (1080, 1920) if shape == (N_CAM, H, WB)
                   else (2 * hh, 2 * wh - 2)):
          rgb8 = torch.randint(0, 256, (n_img, 3, *hw), generator=gen,
                               device=dev, dtype=torch.uint8)
          ky, kvu = yuv420.yuv420_planar(rgb8, backend="kernel")
          py, pvu = yuv420.yuv420_planar(rgb8, backend="plain")
          _check_bitwise(f"yuv420_planar {n_img}x3x{hw[0]}x{hw[1]} Y", ky,
                         py)
          _check_bitwise(f"yuv420_planar {n_img}x3x{hw[0]}x{hw[1]} VU", kvu,
                         pvu)
          note("yuv420_planar", ky, py)
          note("yuv420_planar", kvu, pvu)
        log(f"kernels {tag}: yuv420_planar at 3x{2 * hh}x{2 * wh} and "
            f"3x{hw[0]}x{hw[1]} agrees with its plain twin")
      if shape != (N_CAM, H, WB):
        continue
      # times at the main path's shapes, each with its inputs and f32
      # operations (counted from the kernel's arithmetic: the stencil's
      # live taps as a multiply and an add each, inv_full and the clip;
      # the map's ~30 operations per pixel; 4 to 7 per finished byte; a
      # resize output's 2 x 3 lerp operations per tap pair)
      rgb = plans[0.5][1]
      both = {s: plans[s][0] for s in RESIZE_SCALES}
      npix = N_CAM * hh * wh
      live = sum(bin(m).count("1") for m in demosaic.TAP_MASKS[
          demosaic.tap_variant(weights)])
      calls = {
          f"decode_{sfx}": (lambda b: decode.decode12_phases(
              raws, False, dtype, backend=b), [raws], 2 * 4 * npix),
          f"demosaic_{sfx}": (lambda b: demosaic.demosaic_stencil(
              phases, weights, fin, 4, backend=b), [phases],
              (2 * live + 12 + 24) * npix),
          f"reinhard_{sfx}": (lambda b: reinhard.reinhard_map(
              x12, scal0, False, backend=b), [x12, scal0], 30 * 4 * npix),
          f"reinhard_{sfx} ca": (lambda b: reinhard.reinhard_map(
              x12, scal_ca, True, backend=b), [x12, scal_ca],
              50 * 4 * npix),
          f"finish_{sfx}": (lambda b: finish.finish_planar_u8(
              p_cast, max_out, 1.0, backend=b), [p_cast, max_out],
              4 * 12 * npix),
          f"finish_{sfx} linear": (lambda b: finish.finish_planar_u8(
              x12, lin, 1.0, "linear", backend=b), [x12, lin],
              7 * 12 * npix),
      }
      for t in [ImageTransform.flip_horiz, *swaps]:
        calls[f"finish_{sfx} {t.value}"] = (
            lambda b, t=t: finish.finish_planar_u8(
                p_cast, max_out, 1.0, transform=t, backend=b),
            [p_cast, max_out], 4 * 12 * npix)
      # K4's I420 mode: the map's 4 operations per value, then per
      # half-res pixel 4 Y of ~10 and the chroma's ~40
      yuv_ops = (4 * 12 + 80) * npix
      calls[f"finish_yuv420_{sfx}"] = (lambda b: finish.finish_yuv420(
          p_cast, max_out, 1.0, backend=b), [p_cast, max_out], yuv_ops)
      calls[f"finish_yuv420_{sfx} linear"] = (
          lambda b: finish.finish_yuv420(x12, lin, 1.0, "linear",
                                         backend=b), [x12, lin],
          yuv_ops + 3 * 12 * npix)
      calls[f"finish_yuv420_{sfx} rotate_90"] = (
          lambda b: finish.finish_yuv420(
              p_cast, max_out, 1.0, transform=ImageTransform.rotate_90,
              backend=b), [p_cast, max_out], yuv_ops)
      if dtype == torch.bfloat16:
        # the planar I420 kernel at the resize route's 6 x 1920 x 1080 and
        # the odd-stride route's 6x4K; ~30 operations per pixel
        for tag_, hw in (("", (1080, 1920)), (" 6x4K", (H, W))):
          rgb8 = torch.randint(0, 256, (N_CAM, 3, *hw), generator=gen,
                               device=dev, dtype=torch.uint8)
          calls[f"yuv420_planar{tag_}"] = (
              lambda b, rgb8=rgb8: yuv420.yuv420_planar(rgb8, backend=b),
              [rgb8], 30 * rgb8[:, 0].numel())
      # the planar I420 tonemap form at the resize route's 6 x 1920 x 1080:
      # the tone's ~4 operations per value, the conversion's ~30 per pixel
      rp, rmx = reinhard.reinhard_map(rgb, scal0, False)
      tone_ops = (3 * 4 + 30) * rgb[:, 0].numel()
      calls[f"yuv420_planar_tone_{sfx}"] = (
          lambda b: yuv420.yuv420_planar_tone(rp, rmx, 1.0, backend=b),
          [rp, rmx], tone_ops)
      calls[f"yuv420_planar_tone_{sfx} linear"] = (
          lambda b: yuv420.yuv420_planar_tone(rgb, lin, 1.0, "linear",
                                              backend=b),
          [rgb, lin], tone_ops + 3 * 3 * rgb[:, 0].numel())
      calls[f"yuv420_planar_tone_{sfx} rotate_90"] = (
          lambda b: yuv420.yuv420_planar_tone(
              rp, rmx, 1.0, transform=ImageTransform.rotate_90, backend=b),
          [rp, rmx], tone_ops)
      calls[f"reinhard_{sfx} planar1080"] = (
          lambda b: reinhard.reinhard_map(rgb, scal0, False, backend=b),
          [rgb, scal0], 10 * rgb.numel())
      # K12: at x0.5 (every dtype, also on the direct path) and, in bf16,
      # at x1.5 and x0.37; the bound counts the x12 that the taps touch
      for scale in (0.5, 1.5, 0.37) if dtype == torch.bfloat16 else (0.5,):
        t_s = both[scale]
        tag = "" if scale == 0.5 else f" x{scale}"
        out_numel = N_CAM * 3 * t_s.h_out * t_s.w_out
        resize_in = [_resize_x12_bytes(x12, t_s), t_s.r_lo, t_s.r_hi,
                     t_s.r_f, t_s.c_lo, t_s.c_hi, t_s.c_f]
        calls[f"resize_{sfx}{tag}"] = (
            lambda b, t_s=t_s: resize.resize_x12(x12, t_s, backend=b),
            resize_in, 6 * out_numel)
        if resize.plan(x12, t_s) != "direct":
          calls[f"resize_{sfx}{tag} direct"] = (
              lambda b, t_s=t_s: (
                  resize._launch(x12, t_s, "direct") if b == "kernel"
                  else resize.resize_x12_plain(x12, t_s)),
              resize_in, 6 * out_numel)
      if dtype == torch.bfloat16:
        calls["front_fused_bf16"] = (lambda b: front_fused.front_fused(
            phases, weights, fin, scal0, backend=b), [phases, scal0],
            (2 * live + 36 + 30 * 4) * npix)
      for name, (call, inputs, ops) in calls.items():
        note_ = "6x4K"
        if name == "yuv420_planar" or name.startswith("yuv420_planar_tone"):
          note_ = "6x1920x1080"
        if name.startswith("resize"):
          sc = next((s for s in (1.5, 0.37) if f"x{s}" in name), 0.5)
          note_ = (f"6x4K x{sc} -> {both[sc].w_out}x{both[sc].h_out}")
        _time(results, name, call, inputs, ops, note_)
      base = results[f"finish_{sfx}"]["ms"]
      ratios = [results[f"finish_{sfx} {t.value}"]["ms"] / base
                for t in swaps]
      log(f"  finish_{sfx} under a swap / without a transform: "
          + ", ".join(f"{t.value} {r:.3f}x" for t, r in zip(swaps, ratios)))
      if dtype == torch.bfloat16:
        # the composed pair K7 replaces, kernels only
        ms = median_ms(lambda: reinhard.reinhard_map(
            demosaic.demosaic_stencil(phases, weights, fin,
                                      backend="kernel")[0], scal0, False,
            backend="kernel"))
        results["demosaic_bf16+reinhard_bf16"] = dict(ms=ms)
        log(f"  demosaic_bf16 -> reinhard_bf16 (what front_fused_bf16 "
            f"replaces): {ms:.4f} ms (6x4K)")
  # K2's banded mode at the 6x8K band (272 of 2160 half-res rows, 3840
  # wide, a halo row each side): each band kind against the twin (bitwise
  # without a CCM, <= 1 ulp with one), K7's gates in bf16 (bitwise K2 ->
  # K3, K3's contract against its twin), and K2 timed on an interior band
  # with the sample, against its bound
  n8, hb, wh8 = BAND_8K
  zeros9 = torch.zeros(9, device=dev)
  for dtype, sfx in hopper.DTYPE_SUFFIX.items():
    band = torch.rand((n8, 4, hb + 2, wh8), generator=gen,
                      device=dev).to(dtype)
    gates = ((1, -1), (-1, -1), (-1, hb), (1, hb))
    for (top, bot), cc in itertools.product(gates, (None, ccm)):
      fin8 = _stencil_finish_spec(weights, hb + 2, wh8, cc, dtype,
                                  top_row=top, bot_row=bot)
      what = (f"demosaic banded 6x8K band {sfx} cc={cc is not None} gates "
              f"({top}, {bot})")
      kx, ks = demosaic.demosaic_stencil(band, weights, fin8, 4,
                                         backend="kernel", rows=(1, hb + 1))
      px, ps = demosaic.demosaic_stencil(band, weights, fin8, 4,
                                         backend="plain", rows=(1, hb + 1))
      ux, us = ulps(kx, px), ulps(ks, ps)
      if (cc is None and (ux or us)) or max(ux, us) > 1:
        raise AssertionError(f"{what}: {ux}, {us} ulps from the twin")
      _check_bitwise(f"{what} sample", ks, kx[:, 0:3, ::4, ::4])
      note(f"demosaic_{sfx}", kx, px)
      if dtype == torch.bfloat16:
        scal8 = reinhard.reinhard_scal(metering_update_ca(ks, zeros9, 0.0),
                                       1.0, 1.0)
        del kx, ks, px, ps
        fx, _ = demosaic.demosaic_stencil(band, weights, fin8,
                                          backend="kernel")
        cp, cm = reinhard.reinhard_map(fx, scal8, False, backend="kernel")
        del fx
        fp, fm = front_fused.front_fused(band, weights, fin8, scal8,
                                         backend="kernel")
        what = what.replace("demosaic", "front_fused")
        _check_bitwise(f"{what} p", fp, cp)
        _check_bitwise(f"{what} max", fm, cm)
        del cp, cm
        pp, pm = front_fused.front_fused(band, weights, fin8, scal8,
                                         backend="plain")
        _check_map(f"{what} vs twin", fp, fm, pp, pm)
        note("front_fused_bf16", fp, pp)
        del fp, fm, pp, pm
      else:
        del kx, ks, px, ps
    log(f"kernels {n8}x4x{hb + 2}x{wh8} {sfx}: demosaic banded (first, "
        "interior, last, single band; with and without a CCM) within its "
        "contract of the twin"
        + (", front_fused's gates bitwise K2 -> K3 and within K3's "
           "contract of its twin" if dtype == torch.bfloat16 else ""))
    fin8 = _stencil_finish_spec(weights, hb + 2, wh8, None, dtype,
                                top_row=-1, bot_row=-1)
    live = sum(bin(m).count("1") for m in demosaic.TAP_MASKS[
        demosaic.tap_variant(weights)])
    _time(results, f"demosaic_{sfx} banded", lambda b: (
        demosaic.demosaic_stencil(band, weights, fin8, 4, backend=b,
                                  rows=(1, hb + 1))), [band],
          (2 * live + 12 + 24) * n8 * hb * wh8,
          f"6x8K band: {hb} of 2160 half-res rows x {wh8}, halo read")
    del band
  for name in err:
    results[name]["max_abs_err"] = err[name]
  torch.cuda.synchronize()


def format_kernels():
  """{name: (format, source dtype or None, T)} of the decodes of the raw
  formats other than packed12: K1's packed16 mode and the CFA split."""
  from taichi_image_tpu_torch.ops.hopper import decode
  out = {k.name: ("packed16", None, t)
         for t, k in decode.DECODE16_KERNELS.items()}
  for (src, t), k in decode.SPLIT_KERNELS.items():
    out[k.name] = (decode.SPLIT_SOURCES[src], src, t)
  return out


def format_raws(fmt, shape, gen, wide=True):
  """A raw batch of ``fmt`` holding the frame of a packed12 batch shape
  (N, H, 1.5W): packed16 bytes (N, H, 2W), or a u16, f16 or f32 CFA
  (N, H, W). u16 spans every code (every 11th a zero); the floats take,
  with ``wide`` (the kernel checks), random signs and exponents from
  2^-30 (f16 subnormals and zeros) to 2^17 (past f16's range, so its
  casts overflow to inf), else (the routes) values in [0, 1)."""
  import torch
  dev = torch.device("cuda")
  b, h, wb = shape
  w = wb * 2 // 3
  if fmt == "packed16":
    return torch.randint(0, 256, (b, h, 2 * w), generator=gen, device=dev,
                         dtype=torch.uint8)
  if fmt == "u16":
    x = torch.randint(-32768, 32768, (b, h, w), generator=gen, device=dev,
                      dtype=torch.int16)
    x.view(-1)[::11] = 0
    return x.view(torch.uint16)
  if wide:
    x = torch.randn((b, h, w), generator=gen, device=dev) * torch.exp2(
        torch.randint(-30, 18, (b, h, w), generator=gen,
                      device=dev).float())
  else:
    x = torch.rand((b, h, w), generator=gen, device=dev)
  return x.to(torch.float16 if fmt == "f16" else torch.float32)


def _split_copy(cfa, dtype):
  """One torch call for the split of a float CFA: ``copy_`` of the
  (N, row parity, column parity, H/2, W/2) view into T, with its cast."""
  import torch
  n, h, w = cfa.shape
  out = torch.empty((n, 2, 2, h // 2, w // 2), dtype=dtype, device=cfa.device)
  out.copy_(cfa.view(n, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3))
  return out.view(n, 4, h // 2, w // 2)


def _same_bits(k, p) -> bool:
  """Bitwise, on the integer view (-0 and +0, and every NaN, apart)."""
  import torch
  it = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[k.element_size()]
  return k.shape == p.shape and torch.equal(k.view(it), p.view(it))


def _check_bits(what, k, p):
  if not _same_bits(k, p):
    raise AssertionError(f"{what}: not bitwise")


def phase_format_kernels(results):
  """K1's packed16 mode and the CFA split against their plain twins on
  the card, bitwise, at the 6x4K frame and the ODD, RAGGED and CUT
  frames (the same pixels as phase_kernels' packed12 shapes), each
  instantiation; timed at 6x4K against its bound, the float splits
  beside their library call (one ``copy_``). packed16 bytes that start on
  an odd address (the wrapper's aligned copy) at the ODD frame. Fills
  ``results``."""
  import torch
  from taichi_image_tpu_torch.ops.hopper import decode

  gen = torch.Generator(device="cuda").manual_seed(3)
  kernels = format_kernels()
  err = dict.fromkeys(kernels, 0.0)
  lib_same = {}
  for shape in ((N_CAM, H, WB), ODD, RAGGED, CUT):
    tag = "x".join(map(str, shape))
    raws = {fmt: format_raws(fmt, shape, gen)
            for fmt in ("packed16", "u16", "f16", "f32")}
    for name, (fmt, src, t) in kernels.items():
      def call(b, fmt=fmt, t=t):
        if fmt == "packed16":
          return decode.decode16_phases(raws[fmt], t, backend=b)
        return decode.split_phases(raws[fmt], t, backend=b)
      k, p = call("kernel"), call("plain")
      _check_bits(f"{name} {tag}", k, p)
      d = (k.float() - p.float()).abs()
      err[name] = max(err[name], d.nan_to_num(0.0).max().item())
      # a float CFA's split is one strided copy with a cast: torch's copy_
      # of the phase-ordered view computes the same function
      library = (None if fmt in ("packed16", "u16") else
                 lambda fmt=fmt, t=t: _split_copy(raws[fmt], t))
      if library is not None:
        lib_same[name] = (lib_same.get(name, True)
                          and _same_bits(library(), k))
      if shape == (N_CAM, H, WB):
        # per half-res pixel: 4 conversions (and the u16's division) and,
        # for packed16, 4 assemblies
        ops = (8 if fmt == "packed16" else 4) * N_CAM * (H // 2) * (W // 2)
        _time(results, name, call, [raws[fmt]], ops, library=library)
    if shape == ODD:
      src = raws["packed16"]
      odd = torch.empty(src.numel() + 1, dtype=torch.uint8,
                        device=src.device)[1:].view(src.shape)
      odd.copy_(src)
      for t in decode.DECODE16_KERNELS:
        _check_bits(f"decode16 {t} odd address",
                    decode.decode16_phases(odd, t, backend="kernel"),
                    decode.decode16_phases(odd, t, backend="plain"))
    log(f"kernels {tag}: decode16 (3 dtypes) and split (9 instantiations) "
        f"agree bitwise with their plain twins")
  log(f"kernels: the float splits' library call (copy_) bitwise the "
      f"kernel at every frame: {lib_same}")
  for name in kernels:
    results[name]["max_abs_err"] = err[name]
  torch.cuda.synchronize()


def _step_args(dtype, plan=None, stride=8, transform=None,
               tonemap="reinhard", gamma=1.0, color_format="rgb",
               fmt="packed12"):
  """fused_isp_step's static arguments after prev, t: gamma, intensity,
  light_adapt, color_adapt, fmt, ids_format, work_dtype, pattern, cc,
  resize_plan, stride, transform, tonemap, color_format (the main path's
  by default)."""
  from taichi_image_tpu_torch.ops.bayer import BayerPattern
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform
  return (gamma, 1.0, 1.0, 0.0, fmt, False, dtype, BayerPattern.RGGB,
          None, plan, stride, transform or ImageTransform.none, tonemap,
          color_format)


class _env:
  """Set an environment variable inside a ``with`` block only."""

  def __init__(self, env):
    self.env = env or {}

  def __enter__(self):
    import os
    self.old = {k: os.environ.get(k) for k in self.env}
    os.environ.update(self.env)

  def __exit__(self, *exc):
    import os
    for k, v in self.old.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v


def _outputs(out):
  """A step's u8 outputs: (planar RGB,) or (Y, VU)."""
  return out if isinstance(out, tuple) else (out,)


def drive_route(frames, name, sfx, expect, isp_kw=None, proc_kw=None,
                env=None, extra=()):
  """One route of one class: ``process`` over the frames with the launch
  counts set to 0 just before and read just after, each frame against
  the all-plain route (metrics within 1e-5, u8 within 1 count; with
  ``color_format="yuv420"`` in ``proc_kw``, Y and VU each). Fails unless
  exactly the ``expect`` stages of the class's dtype and the ``extra``
  kernels launched. Returns (isp, launch counts)."""
  import torch
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch import BayerPattern
  from taichi_image_tpu_torch.models.camera_isp import (decoded_width,
                                                        fused_isp_step)
  from taichi_image_tpu_torch.ops import hopper

  isp_kw, proc_kw = isp_kw or {}, proc_kw or {}
  cls = getattr(ttit, CLASSES[sfx])
  fmt = proc_kw.get("fmt", "packed12")
  n, h, w_raw = frames[0].shape
  dev = torch.device("cuda")
  isp = cls(BayerPattern.RGGB, device="cuda", **isp_kw)
  with _env(env):
    torch.cuda.synchronize()
    hopper.reset_launches()
    prevs, outs, metrics = [], [], []
    for raws in frames:
      prevs.append(None if isp.metrics is None else isp.metrics.clone())
      outs.append(isp.process(raws, **proc_kw))
      metrics.append(isp.metrics.clone())
    torch.cuda.synchronize()
    launches = hopper.launch_counts()
    own = {f"{st}_{sfx}" for st in expect} | set(extra)
    if (any(launches[n] == 0 for n in own)
        or any(v for n, v in launches.items() if n not in own)):
      raise AssertionError(f"{name} {cls.__name__} did not run through "
                           f"{sorted(own)} alone: {launches}")
    plan = isp._resize_plan(h, decoded_width(fmt, w_raw))
    color_format = proc_kw.get("color_format", "rgb")
    args = _step_args(cls._work_dtype, plan, isp.metering_stride,
                      isp.transform, proc_kw.get("tonemap", "reinhard"),
                      proc_kw.get("gamma", 1.0), color_format, fmt)
    worst = [0.0, 0, 0.0]
    for f, raws in enumerate(frames):
      outs_f, m = _outputs(outs[f]), metrics[f]
      lead = ((n,), (n, 2)) if color_format == "yuv420" else ((n, 3),)
      for out, head in zip(outs_f, lead, strict=True):
        if (out.dtype != torch.uint8 or out.ndim != len(head) + 2
            or out.shape[:len(head)] != head):
          raise AssertionError(f"{name} frame {f}: output "
                               f"{tuple(out.shape)} {out.dtype}")
        if out.max().item() == out.min().item():
          raise AssertionError(f"{name} frame {f}: constant output")
      if color_format == "yuv420":
        y, vu = outs_f
        if vu.shape[2:] != (y.shape[1] // 2, y.shape[2] // 2):
          raise AssertionError(f"{name} frame {f}: Y {tuple(y.shape)}, VU "
                               f"{tuple(vu.shape)}")
      if not torch.isfinite(m).all():
        raise AssertionError(f"{name} frame {f}: non-finite metrics {m}")
      prev = torch.zeros(9, device=dev) if prevs[f] is None else prevs[f]
      t = 0.0 if prevs[f] is None else 1.0 - isp.moving_alpha
      pm, po = fused_isp_step(raws, prev, t, *args, backend="plain")
      dm = (m - pm).abs().max().item()
      for out, p_out in zip(outs_f, _outputs(po), strict=True):
        if p_out.shape != out.shape:
          raise AssertionError(f"{name} frame {f}: {tuple(out.shape)} vs "
                               f"the plain route's {tuple(p_out.shape)}")
        d = (out.int() - p_out.int()).abs()
        if dm > 1e-5 or d.max().item() > 1:
          raise AssertionError(f"{name} frame {f}: vs plain route metrics "
                               f"|d| {dm:.3g}, u8 max {d.max().item()}")
        worst = [max(worst[0], dm), max(worst[1], d.max().item()),
                 max(worst[2], (d != 0).float().mean().item())]
  log(f"route {name} {cls.__name__}: {len(frames)} frames -> "
      f"{' + '.join(str(tuple(o.shape)) for o in _outputs(outs[0]))}, "
      "launches "
      f"{ {n: launches[n] for n in sorted(own)} }; vs the plain route "
      f"metrics |d| <= {worst[0]:.3g}, u8 max |d| {worst[1]} "
      f"({worst[2]:.2e} of bytes)")
  return isp, {n: launches[n] for n in own}


_MAIN = ("decode", "demosaic", "reinhard", "finish")


def phase_slice(frames, sfx):
  """One class's main path, 5 frames at 6x4K, against the all-plain
  route, and a small input against the CPU; returns the launch counts of
  its run."""
  import numpy as np
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch import BayerPattern

  cls = getattr(ttit, CLASSES[sfx])
  _, launches = drive_route(frames, "main", sfx, _MAIN)

  # a small input against the plain route on the CPU, which the CPU
  # tests hold to the JAX package
  rng = np.random.default_rng(2)
  gpu_isp = cls(BayerPattern.GBRG, correct_colors=True, device="cuda")
  cpu_isp = cls(BayerPattern.GBRG, correct_colors=True, device="cpu")
  for f in range(3):
    raws = rng.integers(0, 256, size=(2, 64, 1152), dtype=np.uint8)
    og = gpu_isp.process(raws, gamma=2.2).cpu()
    oc = cpu_isp.process(raws, gamma=2.2)
    dm = (gpu_isp.metrics.cpu() - cpu_isp.metrics).abs().max().item()
    d = (og.int() - oc.int()).abs()
    if dm > 1e-5 or d.max().item() > 2 or (d != 0).float().mean() > 0.02:
      raise AssertionError(f"small frame {f}: GPU vs CPU metrics |d| "
                           f"{dm:.3g}, u8 max {d.max().item()}")
  log(f"slice {cls.__name__}: 2x64x768 GBRG+CCM gamma 2.2, 3 frames on the "
      f"card agree with the CPU plain route (last: metrics |d| {dm:.3g}, "
      f"u8 max {d.max().item()})")
  return launches


def phase_routes(frames):
  """Every other route, each driven alone; returns the launch counts
  summed over the routes."""
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform
  resize = ("decode", "demosaic", "resize", "reinhard")
  routes = []
  for sfx in CLASSES:
    routes += [
        ("resize1920+rotate_90", sfx, resize,
         dict(resize_width=1920, transform=ImageTransform.rotate_90), {}),
        ("flip_horiz", sfx, _MAIN,
         dict(transform=ImageTransform.flip_horiz), {}),
        ("linear gamma 2.2", sfx, ("decode", "demosaic", "finish"), {},
         dict(tonemap="linear", gamma=2.2)),
    ]
  routes += [
      ("scale 0.37", "bf16", resize, dict(scale=0.37), {}),
      ("stride 7", "bf16", _MAIN, dict(metering_stride=7), {}),
  ]
  total = {}
  for name, sfx, expect, isp_kw, proc_kw in routes:
    _, launches = drive_route(frames, name, sfx, expect, isp_kw, proc_kw)
    for n, v in launches.items():
      total[n] = total.get(n, 0) + v
  # the front-fused route: the variable set for this route only
  _, launches = drive_route(frames, "front-fused", "bf16",
                            ("decode", "front_fused", "finish"),
                            env={FRONT_FUSED: "1"})
  for n, v in launches.items():
    total[n] = total.get(n, 0) + v
  # I420 output on fewer frames: K4's I420 mode on the phase and
  # front-fused routes, the planar kernel on the resize and odd-stride ones
  yuv = dict(color_format="yuv420")
  routes = []
  for sfx in CLASSES:
    routes += [
        ("I420 main", sfx, ("decode", "demosaic", "reinhard",
                            "finish_yuv420"), {}, yuv, {}, ()),
        ("I420 resize1920+rotate_90", sfx, (*resize, "yuv420_planar_tone"),
         dict(resize_width=1920, transform=ImageTransform.rotate_90), yuv,
         {}, ()),
    ]
  routes += [
      ("I420 resize1920 linear gamma 2.2", "bf16",
       ("decode", "demosaic", "resize", "yuv420_planar_tone"),
       dict(resize_width=1920), dict(yuv, tonemap="linear", gamma=2.2), {},
       ()),
      ("I420 stride 7", "bf16", _MAIN, dict(metering_stride=7), yuv, {},
       ("yuv420_planar",)),
      ("I420 front-fused", "bf16", ("decode", "front_fused",
                                    "finish_yuv420"), {}, yuv,
       {FRONT_FUSED: "1"}, ()),
  ]
  for name, sfx, expect, isp_kw, proc_kw, env, extra in routes:
    _, launches = drive_route(frames[:YUV_FRAMES], name, sfx, expect, isp_kw,
                              proc_kw, env, extra)
    tone = f"yuv420_planar_tone_{sfx}"
    if tone in launches and launches[tone] != YUV_FRAMES:
      raise AssertionError(f"{name}: {tone} launched {launches[tone]} times "
                           f"in {YUV_FRAMES} steps")
    for n, v in launches.items():
      total[n] = total.get(n, 0) + v
  return total


_DECODE_STAGE = {"packed16": "decode16", "u16": "split_u16",
                 "f16": "split_f16", "f32": "split_f32"}


def _add(total, launches):
  for n, v in launches.items():
    total[n] = total.get(n, 0) + v


def phase_format_routes(frames):
  """The raw formats and the per-image API on the card, each against the
  all-plain route (or, for the lazy list path and process_stream,
  ``process`` on a fresh ISP, bitwise), with the launch counts set to 0
  just before and read just after each; returns their launch counts."""
  import torch
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch import BayerPattern
  from taichi_image_tpu_torch.models import camera_isp as ci
  from taichi_image_tpu_torch.ops import hopper

  gen = torch.Generator(device="cuda").manual_seed(4)
  total = {}
  # each class x each format through process, 5 frames at 6x4K
  for fmt, stage in _DECODE_STAGE.items():
    fframes = [format_raws(fmt, (N_CAM, H, WB), gen, wide=False)
               for _ in range(FRAMES)]
    for sfx in CLASSES:
      _, launches = drive_route(fframes, f"format {fmt}", sfx,
                                (stage, "demosaic", "reinhard", "finish"),
                                proc_kw=dict(fmt=fmt))
      _add(total, launches)
    del fframes
  # a tiny frame (2 x 6 pixels, phase planes 1 x 3): the demosaic's
  # denominator route in torch, K1, K3 and K4 on one-row planes
  tiny = [torch.randint(0, 256, (N_CAM, 2, 9), generator=gen, device="cuda",
                        dtype=torch.uint8) for _ in range(FRAMES)]
  for sfx in CLASSES:
    _, launches = drive_route(tiny, "tiny 2x6", sfx,
                              ("decode", "reinhard", "finish"))
    _add(total, launches)

  def reset():
    torch.cuda.synchronize()
    hopper.reset_launches()

  def counts(name, want):
    torch.cuda.synchronize()
    got = {n: v for n, v in hopper.launch_counts().items() if v}
    if got != want:
      raise AssertionError(f"{name}: launches {got}, expected {want}")
    _add(total, got)
    return got

  # the lazy list path: 6 x load_packed12 -> tonemap_reinhard, bitwise
  # process on a fresh ISP, one launch of each stage per step
  for sfx, name in CLASSES.items():
    cls = getattr(ttit, name)
    lazy = cls(BayerPattern.RGGB, device="cuda")
    fresh = cls(BayerPattern.RGGB, device="cuda")
    reset()
    outs = []
    for raws in frames:
      handles = lazy.tonemap_reinhard([lazy.load_packed12(r) for r in raws])
      outs.append((torch.stack([h.planar for h in handles]),
                   lazy.metrics.clone()))
    got = counts(f"lazy list {name}", {f"{st}_{sfx}": FRAMES
                                       for st in _MAIN})
    for f, raws in enumerate(frames):
      want = fresh.process(raws)
      if not (torch.equal(outs[f][0], want)
              and torch.equal(outs[f][1], fresh.metrics)):
        raise AssertionError(f"lazy list {name} frame {f}: not bitwise "
                             "process")
    log(f"route lazy list {name}: {FRAMES} steps of {N_CAM} x load_packed12 "
        f"-> tonemap_reinhard bitwise process on a fresh ISP; launches "
        f"{got}")

  # a mixed staged list: load_16u of each camera, one handle forced,
  # update_metering, tonemap_linear (two EMA updates) against the plain
  # route's two steps
  u16 = format_raws("u16", (N_CAM, H, WB), gen)
  for sfx, name in CLASSES.items():
    cls = getattr(ttit, name)
    isp = cls(BayerPattern.RGGB, device="cuda")
    reset()
    handles = [isp.load_16u(r) for r in u16]
    handles[2]._force()
    isp.update_metering(handles)
    outs = isp.tonemap_linear(handles, gamma=1.2)
    got = counts(f"staged u16 {name}", {
        f"split_u16_{sfx}": N_CAM, f"demosaic_{sfx}": N_CAM,
        f"finish_{sfx}": 1})
    args = _step_args(cls._work_dtype, tonemap="linear", gamma=1.2,
                      fmt="u16")
    m1, _ = ci.fused_isp_step(u16, torch.zeros(9, device="cuda"), 0.0,
                              *args, backend="plain")
    m2, po = ci.fused_isp_step(u16, m1, 1.0 - isp.moving_alpha, *args,
                               backend="plain")
    out = torch.stack([h.planar for h in outs])
    dm = (isp.metrics - m2).abs().max().item()
    d = (out.int() - po.int()).abs().max().item()
    if dm > 1e-5 or d > 1:
      raise AssertionError(f"staged u16 {name}: vs plain metrics |d| "
                           f"{dm:.3g}, u8 max {d}")
    log(f"route staged u16 list {name}: load_16u x {N_CAM} (one forced) -> "
        f"update_metering -> tonemap_linear vs the plain route: metrics "
        f"|d| {dm:.3g}, u8 max |d| {d}; launches {got}")

  # process_stream: bitwise process frame by frame
  stream = ttit.CameraBF16(BayerPattern.RGGB, device="cuda")
  ref = ttit.CameraBF16(BayerPattern.RGGB, device="cuda")
  reset()
  outs = list(stream.process_stream(iter(frames)))
  got = counts("process_stream", {f"{st}_bf16": FRAMES for st in _MAIN})
  for f, raws in enumerate(frames):
    if not torch.equal(outs[f], ref.process(raws)):
      raise AssertionError(f"process_stream frame {f}: not bitwise process")
  log(f"route process_stream CameraBF16: {FRAMES} frames bitwise process; "
      f"launches {got}")

  # resize_image of a loaded image: K1, K2, K12 bitwise the plain stages
  for sfx, name in CLASSES.items():
    cls = getattr(ttit, name)
    isp = cls(BayerPattern.RGGB, resize_width=1920, device="cuda")
    raw = frames[0][0]
    reset()
    img = isp.resize_image(isp.load_packed12(raw))
    got = counts(f"resize_image {name}", {f"decode_{sfx}": 1,
                                          f"demosaic_{sfx}": 1,
                                          f"resize_{sfx}": 1})
    wd = cls._work_dtype
    ph = ci.load_raw_phases(raw[None], "packed12", wd, backend="plain")
    x12 = ci.demosaic_phases(ph, BayerPattern.RGGB, out_dtype=wd,
                             backend="plain")
    want = ci._resize_x12(x12, *isp._resize_plan(H, W), wd,
                          backend="plain")[0]
    _check_bits(f"resize_image {name}", img.planar, want)
    log(f"route resize_image {name}: load_packed12 -> resize_image "
        f"{tuple(img.planar.shape)} bitwise the plain stages; launches {got}")

  # images not of the class's working dtype, on CameraBF16: f32 (H, W, 3)
  # images through tonemap_reinhard (a planar batch) and tonemap_only
  # (one strided view) run K3<f32> and one cast; a Camera32 phase handle
  # through resize_image runs K12<f32> and one cast
  from taichi_image_tpu_torch.ops.hopper import finish as hfin
  from taichi_image_tpu_torch.ops.hopper import reinhard as hrh
  bf = ttit.CameraBF16(BayerPattern.RGGB, device="cuda")
  imgs = [torch.rand((H, W, 3), generator=gen, device="cuda")
          for _ in range(N_CAM)]
  reset()
  outs = bf.tonemap_reinhard(imgs)
  one = bf.tonemap_only(imgs[1], bf.metrics, 1.0, 1.0, 1.0, 0.0)
  got = counts("f32 images on CameraBF16", {"reinhard_f32": 2})
  batch = torch.stack([im.movedim(-1, 0) for im in imgs])
  m = ci._jit_metering_planar(batch, torch.zeros(9, device="cuda"), 0.0,
                              bf.metering_stride)
  scal, ca_mode = ci._map_scal(m, 1.0, 1.0, 0.0)
  p, mx = hrh.reinhard_map_plain(batch, scal, ca_mode, torch.bfloat16)
  want = hfin.gamma_u8(p, mx, 1.0)
  p1, mx1 = hrh.reinhard_map_plain(batch[1:2], scal, ca_mode, torch.bfloat16)
  want1 = hfin.gamma_u8(p1, mx1, 1.0)[0]
  out = torch.stack([h.planar for h in outs])
  dm = (bf.metrics - m).abs().max().item()
  d = max((out.int() - want.int()).abs().max().item(),
          (one.planar.int() - want1.int()).abs().max().item())
  if dm > 1e-5 or d > 1:
    raise AssertionError(f"f32 images on CameraBF16: vs plain metrics |d| "
                         f"{dm:.3g}, u8 max {d}")
  log(f"route f32 images on CameraBF16: tonemap_reinhard of {N_CAM} and "
      f"tonemap_only of one (H, W, 3) f32 image vs the plain map: metrics "
      f"|d| {dm:.3g}, u8 max |d| {d}; launches {got}")
  c32 = ttit.Camera32(BayerPattern.RGGB, device="cuda")
  handle = c32.load_packed12(frames[0][0])
  handle._force()
  bfr = ttit.CameraBF16(BayerPattern.RGGB, resize_width=1920, device="cuda")
  reset()
  img = bfr.resize_image(handle)
  got = counts("resize_image of a Camera32 handle on CameraBF16",
               {"resize_f32": 1})
  want = ci._resize_from_phases(handle._phases[None],
                                *bfr._resize_plan(H, W), torch.bfloat16)[0]
  _check_bits("resize_image of a Camera32 handle on CameraBF16", img.planar,
              want)
  log(f"route resize_image of a Camera32 handle on CameraBF16: "
      f"{tuple(img.planar.shape)} bf16 bitwise the plain resize; launches "
      f"{got}")
  return total


H8, W8 = 4320, 7680          # 8K frames: raws (6, 4320, 11520) u8
WB8 = W8 * 3 // 2
LARGE_FRAMES = 2
LARGE_DRIVERS = ("auto", "flat", "loop", "scan")


def _frames_8k(fmt="packed12", n=LARGE_FRAMES, seed=3):
  """``n`` random 6x8K raw batches of ``fmt`` (packed12 or packed16)."""
  import torch
  gen = torch.Generator(device="cuda").manual_seed(seed)
  wb = WB8 if fmt == "packed12" else 2 * W8
  return [torch.randint(0, 256, (N_CAM, H8, wb), generator=gen,
                        device="cuda", dtype=torch.uint8) for _ in range(n)]


def _large_vs_process(name, sfx, frames, drivers, isp_kw=None, proc_kw=None):
  """``process_large`` of each driver (a fresh ISP each, the EMA carried
  over the frames) bitwise ``process`` of a fresh ISP on the same frames,
  metrics and every output; the launch counts set to 0 just before each
  driver's run and read just after. The band drivers must launch the
  stencil more than once a frame, the whole-frame ones once. Returns
  (the launch counts summed over the drivers, process's outputs and
  metrics per frame)."""
  import torch
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch import BayerPattern
  from taichi_image_tpu_torch.ops import hopper

  isp_kw, proc_kw = isp_kw or {}, proc_kw or {}
  cls = getattr(ttit, CLASSES[sfx])
  ref = cls(BayerPattern.RGGB, device="cuda", **isp_kw)
  want = []
  for raws in frames:
    out = ref.process(raws, **proc_kw)
    want.append((_outputs(out), ref.metrics.clone()))
  total, stencil = {}, {}
  for driver in drivers:
    isp = cls(BayerPattern.RGGB, device="cuda", **isp_kw)
    torch.cuda.synchronize()
    hopper.reset_launches()
    got = []
    for raws in frames:
      out = isp.process_large(raws, driver=driver, **proc_kw)
      got.append((_outputs(out), isp.metrics.clone()))
    torch.cuda.synchronize()
    launches = hopper.launch_counts()
    for f, ((g, gm), (w, wm)) in enumerate(zip(got, want, strict=True)):
      for k, (go, wo) in enumerate(zip(g, w, strict=True)):
        _check_bitwise(f"large {name} {CLASSES[sfx]} {driver} frame {f} "
                       f"output {k} vs process", go, wo)
      _check_bitwise(f"large {name} {CLASSES[sfx]} {driver} frame {f} "
                     "metrics vs process", gm, wm)
    stencil[driver] = launches[f"demosaic_{sfx}"]
    banded = driver in ("loop", "scan")
    if (stencil[driver] <= len(frames)) if banded else (
        stencil[driver] != len(frames)):
      raise AssertionError(f"large {name} {driver}: the stencil launched "
                           f"{stencil[driver]} times in {len(frames)} "
                           "frames")
    _add(total, {n: v for n, v in launches.items() if v})
  log(f"large {name} {CLASSES[sfx]}: {len(frames)} frames of "
      f"{tuple(frames[0].shape)} -> "
      f"{' + '.join(str(tuple(o.shape)) for o in want[0][0])}; drivers "
      f"{', '.join(drivers)} bitwise process (metrics and output); "
      f"stencil launches {stencil}")
  return total, want


def phase_large():
  """process_large at 6x8K: each class over 2 frames with every driver,
  bitwise process; CameraBF16's first frame against the all-plain route;
  then in CameraBF16 resize_width=3840 with rotate_90, I420, the linear
  tonemap and packed16 raws, each through the loop and the whole-frame
  driver. Returns the launch counts summed over the phase."""
  import torch
  from taichi_image_tpu_torch.models.camera_isp import fused_isp_step
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform

  frames = _frames_8k()
  total = {}
  for sfx in CLASSES:
    launches, want = _large_vs_process("8K", sfx, frames, LARGE_DRIVERS)
    _add(total, launches)
    if sfx == "bf16":
      # what comes out is right: the first frame against the all-plain
      # route (metrics within 1e-5, u8 within 1 count)
      (out,), m = want[0]
      pm, po = fused_isp_step(frames[0], torch.zeros(9, device="cuda"), 0.0,
                              *_step_args(torch.bfloat16), backend="plain")
      dm = (m - pm).abs().max().item()
      d = (out.int() - po.int()).abs()
      if dm > 1e-5 or d.max().item() > 1 or not torch.isfinite(m).all():
        raise AssertionError(f"large 8K CameraBF16 vs the plain route: "
                             f"metrics |d| {dm:.3g}, u8 {d.max().item()}")
      log(f"large 8K CameraBF16 frame 0 vs the all-plain route: metrics "
          f"|d| {dm:.3g}, u8 max |d| {d.max().item()} "
          f"({(d != 0).float().mean().item():.2e} of bytes)")
      del po, d
  both = ("auto", "loop")
  for name, isp_kw, proc_kw in (
      ("8K resize3840+rotate_90",
       dict(resize_width=3840, transform=ImageTransform.rotate_90), {}),
      ("8K I420", {}, dict(color_format="yuv420")),
      ("8K linear gamma 2.2", {}, dict(tonemap="linear", gamma=2.2))):
    launches, _ = _large_vs_process(name, "bf16", frames, both, isp_kw,
                                    proc_kw)
    _add(total, launches)
  del frames
  launches, _ = _large_vs_process("8K packed16", "bf16",
                                  _frames_8k("packed16"), both,
                                  proc_kw=dict(fmt="packed16"))
  _add(total, launches)
  torch.cuda.synchronize()
  return total


PARALLEL_TIMEOUT = 600       # seconds for each multi-process run


def _explicit_device(frames):
  """(a): CameraBF16 on device="cuda:0" bitwise device="cuda" through
  process (2 frames, the EMA carried) and the per-image API (6 x
  load_packed12 -> tonemap_reinhard); use_kernel takes a cuda:0 tensor.
  Returns the launch counts of the cuda:0 runs."""
  import torch
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch.ops import hopper

  if not hopper.use_kernel("auto", torch.empty(1, device="cuda:0")):
    raise AssertionError("use_kernel refused a cuda:0 tensor")
  isps = {dev: ttit.CameraBF16(ttit.BayerPattern.RGGB, device=dev)
          for dev in ("cuda", "cuda:0")}
  apis = {dev: ttit.CameraBF16(ttit.BayerPattern.RGGB, device=dev)
          for dev in ("cuda", "cuda:0")}
  total = {}
  for f, raws in enumerate(frames):
    got = {}
    for dev in ("cuda", "cuda:0"):
      torch.cuda.synchronize()
      hopper.reset_launches()
      out = isps[dev].process(raws)
      handles = apis[dev].tonemap_reinhard(
          [apis[dev].load_packed12(r) for r in raws])
      api = torch.stack([h.planar for h in handles])
      torch.cuda.synchronize()
      if dev == "cuda:0":
        _add(total, {n: v for n, v in hopper.launch_counts().items() if v})
      got[dev] = (out, isps[dev].metrics, api, apis[dev].metrics)
    for what, a, b in zip(("process", "metrics", "per-image API",
                           "API metrics"), got["cuda:0"], got["cuda"]):
      _check_bitwise(f"device='cuda:0' {what} frame {f} vs 'cuda'", a, b)
  log(f"explicit device: CameraBF16(device='cuda:0') process and the "
      f"per-image API over {len(frames)} frames of "
      f"{tuple(frames[0].shape)} bitwise device='cuda'; use_kernel takes "
      f"cuda:0; launches {total}")
  return total


def _one_rank_cases():
  """(b)'s steps: (class suffix, name, ISP keywords, step keywords)."""
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform
  cases = [(sfx, "plain", {}, {}) for sfx in CLASSES]
  cases += [("bf16", "I420", {}, dict(color_format="yuv420")),
            ("bf16", "resize1920+rotate_90",
             dict(resize_width=1920, transform=ImageTransform.rotate_90), {})]
  return cases


def _one_rank_steps(frames):
  """(b): the camera, row and 1 x 1 grid steps on a one-rank NCCL group
  (in this process), each over 2 frames with the EMA carried, bitwise
  the unsharded step (a fresh ISP's process): metrics and output. Returns
  (launch counts, the camera step of CameraBF16)."""
  import torch
  from torch.distributed.device_mesh import init_device_mesh
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch import parallel
  from taichi_image_tpu_torch.ops import hopper

  meshes = {
      "camera": init_device_mesh("cuda", (1,), mesh_dim_names=("cam",)),
      "rows": init_device_mesh("cuda", (1,), mesh_dim_names=("rows",)),
      "grid": init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("cam", "rows"))}
  total, camera_step = {}, None
  for sfx, name, isp_kw, step_kw in _one_rank_cases():
    cls = getattr(ttit, CLASSES[sfx])
    for kind, mesh in meshes.items():
      isp = cls(ttit.BayerPattern.RGGB, device="cuda", **isp_kw)
      ref = cls(ttit.BayerPattern.RGGB, device="cuda", **isp_kw)
      n, h, wb = frames[0].shape
      if kind == "camera":
        step = parallel.sharded_step_for_isp(isp, mesh, frames[0].shape,
                                             **step_kw)
      else:
        factory = (parallel.make_spatial_isp_step if kind == "rows"
                   else parallel.make_grid_isp_step)
        step = factory(mesh, work_dtype=isp._work_dtype,
                       pattern=isp.bayer_pattern, cc=isp._cc_tuple(),
                       stride=isp.metering_stride, n_cameras=n,
                       image_hw=(h, wb * 2 // 3),
                       resize_plan=isp._resize_plan(h, wb * 2 // 3),
                       transform=isp.transform, **step_kw)
      m = torch.zeros(9, device="cuda")
      for f, raws in enumerate(frames):
        t = 0.0 if f == 0 else 1.0 - isp.moving_alpha
        torch.cuda.synchronize()
        hopper.reset_launches()
        m, out = step(raws, m, t, 1.0, 1.0, 1.0, 0.0)
        torch.cuda.synchronize()
        launches = {k: v for k, v in hopper.launch_counts().items() if v}
        _add(total, launches)
        hopper.reset_launches()
        want = ref.process(raws, **step_kw)
        torch.cuda.synchronize()
        unsharded = {k: v for k, v in hopper.launch_counts().items() if v}
        what = f"one-rank NCCL {kind} step {CLASSES[sfx]} {name} frame {f}"
        _check_bitwise(f"{what} metrics", m, ref.metrics)
        for k, (a, b) in enumerate(zip(_outputs(out), _outputs(want),
                                       strict=True)):
          _check_bitwise(f"{what} output {k}", a, b)
        # the same kernels, as many times, as the unsharded step
        if launches != unsharded:
          raise AssertionError(f"{what}: launched {launches}, the "
                               f"unsharded step {unsharded}")
      log(f"{what.rsplit(' frame', 1)[0]}: {len(frames)} frames bitwise "
          f"the unsharded step (metrics and output); launches per step "
          f"{launches}")
      if kind == "camera" and sfx == "bf16" and name == "plain":
        camera_step = step
  return total, camera_step


def _chain_step(inputs, step):
  """K chained steps of a sharded step, every output summed into one
  device scalar."""
  import torch
  m = torch.zeros(9, device="cuda")
  acc = torch.zeros((), dtype=torch.int64, device="cuda")
  for raws in inputs:
    m, out = step(raws, m, 0.9, 1.0, 1.0, 1.0, 0.0)
    acc += out.sum(dtype=torch.int64)
  return acc


def _multi_rank(n, variants, u8_max):
  """(c)/(d): ``variants`` on ``n`` processes sharing cuda:0 in a gloo
  group, each rank against the unsharded step it runs itself; returns
  the launch counts summed over the ranks."""
  from taichi_image_tpu_torch import parallel
  from taichi_image_tpu_torch.parallel import dryrun
  t0 = time.perf_counter()
  per_rank = parallel.run_ranks(dryrun.run_variants, n, variants, "cuda:0",
                                device="cuda:0", backend="gloo",
                                timeout=PARALLEL_TIMEOUT)
  total = {}
  for results in per_rank:
    for r in results:
      _add(total, r["launches"])
  for r in per_rank[0]:
    dryrun.check(r, u8_max[r["name"]])
    log(f"{n} processes on cuda:0 (gloo), {r['name']}: worst over the "
        f"ranks against the unsharded step metrics |d| {r['metrics_d']:.3g}"
        f", u8 |d| {r['u8_d']} ({r['share']:.2e} of bytes differ, "
        f"{r['share2']:.2e} by more than 1); metrics spread over the ranks "
        f"{r['spread']:.3g}")
  log(f"{n} processes: {len(variants)} variants in "
      f"{time.perf_counter() - t0:.1f} s; launches {total}")
  return total


def _multi_rank_variants():
  """(c) on 2 ranks and (d) on 4: the camera step (3 + 3 cameras), the row
  step (2 x 1080 rows) of CameraBF16 with RGB, I420 and resize->1920 with
  rotate_90, and of Camera16 and Camera32; the 2 x 2 grid of CameraBF16;
  6 x 4K random raws. The resize variant meters at stride 4: its 1080
  output rows split into 540 a rank, which stride 8 does not divide."""
  raws = dict(shape=(N_CAM, H, WB), seed=7)
  two = [
      dict(name="camera CameraBF16", kind="camera", cls="CameraBF16",
           raws=raws, steps=2),
      dict(name="rows CameraBF16", kind="rows", cls="CameraBF16", raws=raws,
           steps=2),
      dict(name="rows CameraBF16 I420", kind="rows", cls="CameraBF16",
           raws=raws, color_format="yuv420"),
      dict(name="rows CameraBF16 resize1920+rotate_90 stride 4",
           kind="rows", cls="CameraBF16", raws=raws,
           isp_kw=dict(resize_width=1920, transform="rotate_90",
                       metering_stride=4)),
      dict(name="rows Camera16", kind="rows", cls="Camera16", raws=raws),
      dict(name="rows Camera32", kind="rows", cls="Camera32", raws=raws),
  ]
  four = [dict(name="grid 2x2 CameraBF16", kind="grid", grid=(2, 2),
               cls="CameraBF16", raws=raws, steps=2)]
  return two, four


def phase_parallel(card, frames):
  """The parallel package on the card: (a) the explicit device, (b) the
  camera, row and grid steps on a one-rank NCCL group bitwise the
  unsharded step, and the NCCL camera step timed beside process under
  the sync-debug "error" mode, (c) 2 and (d) 4 processes sharing cuda:0
  in a gloo group within the contract. Returns (launch counts, timing)."""
  import tempfile
  import torch
  import torch.distributed as dist

  total = {}
  _add(total, _explicit_device(frames[:2]))
  torch.cuda.set_device(0)
  with tempfile.TemporaryDirectory(prefix="chip-smoke-nccl-") as tmp:
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0)
    try:
      launches, camera_step = _one_rank_steps(frames[:2])
      _add(total, launches)
      inputs = _inputs()
      runs = {"process": [], "camera step": []}
      for which in ("process", "camera step", "camera step", "process"):
        chain = ((lambda i: _chain_api(i, "CameraBF16", False))
                 if which == "process"
                 else (lambda i: _chain_step(i, camera_step)))
        times, host, _ = bench_step(inputs, None, chain=chain)
        runs[which].append((statistics.median(times),
                            statistics.median(host)))
      del inputs
    finally:
      dist.destroy_process_group()
  timing = {k: dict(step_ms=min(r[0] for r in rs), runs=rs)
            for k, rs in runs.items()}
  log(f"timing CameraBF16 6x4K one-rank NCCL camera step "
      f"{timing['camera step']['step_ms']:.4f} vs process "
      f"{timing['process']['step_ms']:.4f} ms/step (lower of two medians "
      f"of {REPS} x {K} chained steps each, incl. the u8 checksum, in "
      f"turns, under sync-debug 'error': 0 host syncs; (device, host "
      f"enqueue) medians {runs}); {card}")
  two, four = _multi_rank_variants()
  bf16 = {v["name"]: 2 if v["cls"] == "CameraBF16" else 1
          for v in two + four}
  _add(total, _multi_rank(2, two, bf16))
  _add(total, _multi_rank(4, four, bf16))
  return total, timing


APP_FRAMES = 3       # frames per camera of phase_apps' scan folder
APP_SETS = 48        # frame sets of the timed scan (links to those frames)
APP_JPEG_SETS = 12   # frame sets of the timed run that writes JPEGs
APP_STEPS = 30       # frame sets of each timed `process` loop
# the tonemap_scan runs of phase_apps: flags beyond --scan/--width/--write,
# the stages they launch and their dtype (the CLI's defaults: Camera32,
# rotate_90, gamma 0.9, intensity 3, light_adapt 0.9, moving_alpha 0.02)
APP_SCANS = {
    "defaults": ([], ("decode", "demosaic", "reinhard", "finish"), "f32"),
    "resize1920 bf16": (["--resize_width", "1920", "--dtype", "bf16"],
                        ("decode", "demosaic", "resize", "reinhard"), "bf16"),
    "I420 fetch": (["--fetch", "yuv420"],
                   ("decode", "demosaic", "reinhard", "finish_yuv420"), "f32"),
}


def _app_run(fn, argv, expect=None):
  """``fn(argv)`` with its standard output captured and the launch counts
  set to 0 just before and read just after; fails unless exactly the
  ``expect`` kernels launched, each as many times as it gives. Returns
  (output, seconds, launch counts)."""
  import contextlib
  import io
  import torch
  from taichi_image_tpu_torch.ops import hopper
  buf = io.StringIO()
  torch.cuda.synchronize()
  hopper.reset_launches()
  t0 = time.perf_counter()
  try:
    with contextlib.redirect_stdout(buf):
      fn(argv)
  except BaseException:
    log(buf.getvalue())
    raise
  torch.cuda.synchronize()
  secs = time.perf_counter() - t0
  launches = {n: v for n, v in hopper.launch_counts().items() if v}
  if expect is not None and launches != expect:
    raise AssertionError(f"{fn.__module__} {argv}: launches {launches}, "
                         f"expected {expect}")
  return buf.getvalue(), secs, launches


def _app_scan(root):
  """N_CAM camera folders of APP_FRAMES packed12 W x H frames: a smooth
  moving scene per camera plus noise from a seeded generator, mosaiced
  and packed on the card."""
  import torch
  from taichi_image_tpu_torch.ops import bayer, packed
  gen = torch.Generator(device="cuda").manual_seed(12)
  yy, xx = torch.meshgrid(
      torch.arange(H, dtype=torch.float32, device="cuda"),
      torch.arange(W, dtype=torch.float32, device="cuda"), indexing="ij")
  scan = root / "scan"
  for cam in range(N_CAM):
    d = scan / f"cam{cam}"
    d.mkdir(parents=True)
    for f in range(APP_FRAMES):
      ph = f * 0.3 + cam * 0.7
      img = torch.stack([0.5 + 0.4 * torch.sin(xx / 97.0 + ph),
                         0.5 + 0.4 * torch.sin(yy / 71.0 - ph * 1.3),
                         0.5 + 0.4 * torch.sin((xx + yy) / 133.0 + ph / 2)],
                        dim=-1) * (0.6 + 0.1 * cam)
      img = (img + 0.02 * torch.randn(img.shape, generator=gen,
                                      device="cuda")).clamp(0.0, 1.0)
      raw = packed.encode12(bayer.rgb_to_bayer(img), scaled=True)
      (d / f"frame{f:03d}.raw").write_bytes(raw.cpu().numpy().tobytes())
  return scan


def _linked_scan(scan, root, n):
  """A scan of ``n`` frame names per camera, each a link to one of the
  scan's frames (read from the page cache once the scan was read)."""
  for cam in sorted(scan.iterdir()):
    d = root / cam.name
    d.mkdir(parents=True)
    for i in range(n):
      (d / f"frame{i:03d}.raw").symlink_to(cam / f"frame{i % APP_FRAMES:03d}.raw")
  return root


def _host_sets(scan):
  """The scan's frame sets as host (N_CAM, H, WB) u8 arrays, in order."""
  import numpy as np
  return [np.stack([np.fromfile(scan / f"cam{c}" / f"frame{f:03d}.raw",
                                np.uint8).reshape(H, WB)
                    for c in range(N_CAM)]) for f in range(APP_FRAMES)]


def _scan_reference(sets, flags, sfx, path):
  """write_image of the grid of a fresh ISP's ``process`` outputs for the
  last set, after the others in order, with the CLI's defaults; returns
  (the path, seconds of the fetch, grid and write in one thread)."""
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform
  from taichi_image_tpu_torch.scripts import tonemap_scan, util
  resize = int(flags[flags.index("--resize_width") + 1]) if (
      "--resize_width" in flags) else 0
  i420 = "yuv420" in flags
  isp = getattr(ttit, CLASSES[sfx])(
      ttit.BayerPattern.RGGB, transform=ImageTransform.rotate_90,
      moving_alpha=0.02, resize_width=resize, device="cuda")
  for raws in sets:
    out = isp.process(raws, gamma=0.9, intensity=3.0, light_adapt=0.9,
                      color_adapt=0.0,
                      color_format="yuv420" if i420 else "rgb")
  t0 = time.perf_counter()
  if i420:
    util.write_image(path, tonemap_scan.i420_grid(
        out[0].cpu().numpy(), out[1].cpu().numpy(), 2), mode="YCbCr")
  else:
    util.write_image(path, tonemap_scan.rgb_grid(out.cpu().numpy(), 2))
  return path, time.perf_counter() - t0


def _apps_scan_checks(root, scan, sets):
  """(a): each APP_SCANS run of tonemap_scan, pipelined and serial, with
  its JPEGs checked; returns (launch counts, sets/s of the JPEG runs)."""
  from taichi_image_tpu_torch.scripts import tonemap_scan
  total, rates = {}, {}
  for name, (flags, stages, sfx) in APP_SCANS.items():
    expect = {f"{st}_{sfx}": APP_FRAMES for st in stages}
    slug = name.replace(" ", "_")
    base = ["--scan", str(scan), "--width", str(W), *flags]
    jpegs, secs = {}, {}
    for depth in ("2", "0"):
      out = root / f"{slug}_{depth}"
      argv = base + ["--write", str(out)]
      if depth == "0":
        argv += ["--pipeline_depth", "0"]
      _, secs[depth], launches = _app_run(tonemap_scan.main, argv, expect)
      _add(total, launches)
      jpegs[depth] = sorted(out.glob("*.jpg"))
      if len(jpegs[depth]) != APP_FRAMES:
        raise AssertionError(f"tonemap_scan {name}: {len(jpegs[depth])} "
                             f"JPEGs for {APP_FRAMES} frame sets")
    for a, b in zip(jpegs["2"], jpegs["0"]):
      if a.name != b.name or a.read_bytes() != b.read_bytes():
        raise AssertionError(f"tonemap_scan {name}: {a.name} pipelined != "
                             "--pipeline_depth 0")
    ref, one = _scan_reference(sets, flags, sfx, root / f"{slug}_ref.jpg")
    if ref.read_bytes() != jpegs["2"][-1].read_bytes():
      raise AssertionError(f"tonemap_scan {name}: {jpegs['2'][-1].name} is "
                           "not write_image of process's outputs")
    rates[name] = dict(sets_per_s=APP_FRAMES / secs["2"], one_jpeg_s=one)
    log(f"apps tonemap_scan {name}: {APP_FRAMES} sets of {N_CAM}x{H}x{W} "
        f"packed12 -> {APP_FRAMES} JPEGs ({jpegs['2'][-1].stat().st_size} "
        f"bytes the last), pipelined bitwise --pipeline_depth 0 and "
        f"bitwise write_image of a fresh ISP's process outputs; launches "
        f"{expect} a run; {secs['2']:.3f} s pipelined, {secs['0']:.3f} s "
        f"serial (incl. start-up and JPEG writing); one set's fetch, grid "
        f"and JPEG in one thread {one:.3f} s")
  return total, rates


def _host_ms(fn, reps=5, batch=5):
  """Median host ms per call of ``fn()`` over ``reps`` batches, each
  timed to a synchronize."""
  import torch
  fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    t0 = time.perf_counter()
    for _ in range(batch):
      fn()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3 / batch)
  return statistics.median(times)


def _apps_breakdown(timed, sets):
  """A set's costs in the CLI, one at a time: the file reads
  (load_images_iter over the timed scan), the stack into a pinned buffer,
  the upload of a set and the download of its rotate_90 RGB output from
  pinned and from pageable host memory."""
  import contextlib
  import io
  import numpy as np
  import torch
  from taichi_image_tpu_torch.scripts import util
  with contextlib.redirect_stdout(io.StringIO()):
    folders, names = util.find_scan_folders(timed)
  t0 = time.perf_counter()
  for _ in util.load_images_iter(util.load_raw_bytes, folders, names):
    pass
  read_ms = (time.perf_counter() - t0) * 1e3 / len(names)
  pinned_in = torch.empty(sets[0].shape, dtype=torch.uint8, pin_memory=True)
  stack_ms = _host_ms(lambda: np.stack(list(sets[0]), out=pinned_in.numpy()))
  out_shape = (N_CAM, 3, W, H)
  dev_in = torch.empty(sets[0].shape, dtype=torch.uint8, device="cuda")
  dev_out = torch.randint(0, 256, out_shape, dtype=torch.uint8,
                          device="cuda")
  pinned_out = torch.empty(out_shape, dtype=torch.uint8, pin_memory=True)
  pageable_in = torch.from_numpy(sets[0])
  pageable_out = torch.empty(out_shape, dtype=torch.uint8)
  ms = {
      "read": read_ms, "stack into pinned": stack_ms,
      "H2D pinned": _host_ms(lambda: dev_in.copy_(pinned_in,
                                                  non_blocking=True)),
      "H2D pageable": _host_ms(lambda: dev_in.copy_(pageable_in)),
      "D2H pinned": _host_ms(lambda: pinned_out.copy_(dev_out,
                                                      non_blocking=True)),
      "D2H pageable": _host_ms(lambda: pageable_out.copy_(dev_out)),
  }
  nbytes = {"read": sets[0].nbytes, "stack into pinned": sets[0].nbytes,
            "H2D pinned": sets[0].nbytes, "H2D pageable": sets[0].nbytes,
            "D2H pinned": dev_out.numel(), "D2H pageable": dev_out.numel()}
  gbps = {k: nbytes[k] / (v * 1e-3) / 1e9 for k, v in ms.items()}
  log("timing apps a 6x4K set's parts, one at a time (host clock to a "
      "synchronize, median of 5 x 5): "
      + ", ".join(f"{k} {ms[k]:.3f} ms ({gbps[k]:.2f} GB/s)" for k in ms))
  return dict(ms=ms, gbps=gbps)


def _apps_timing(card, root, scan, sets, jpeg_rates):
  """(b): sets/s of tonemap_scan from files in the page cache, and of
  ``process`` fed host (pageable) sets or sets on the card."""
  import torch
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform
  from taichi_image_tpu_torch.scripts import tonemap_scan
  timed = _linked_scan(scan, root / "timed", APP_SETS)
  base = ["--scan", str(timed), "--width", str(W)]
  cli = [APP_SETS / _app_run(tonemap_scan.main, base)[1] for _ in range(2)]
  serial = APP_SETS / _app_run(tonemap_scan.main,
                               base + ["--pipeline_depth", "0"])[1]
  jpeg_scan = _linked_scan(scan, root / "timed_jpeg", APP_JPEG_SETS)
  jpeg = APP_JPEG_SETS / _app_run(tonemap_scan.main, [
      "--scan", str(jpeg_scan), "--width", str(W), "--write",
      str(root / "timed_jpeg_out")])[1]
  isp = ttit.Camera32(ttit.BayerPattern.RGGB,
                      transform=ImageTransform.rotate_90, moving_alpha=0.02,
                      device="cuda")
  kw = dict(gamma=0.9, intensity=3.0, light_adapt=0.9, color_adapt=0.0)
  dev_sets = [torch.from_numpy(s).cuda() for s in sets]

  def rate(feed, fetch):
    for raws in feed:
      isp.process(raws, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(APP_STEPS):
      out = isp.process(feed[i % len(feed)], **kw)
      if fetch:
        out.cpu()
    torch.cuda.synchronize()
    return APP_STEPS / (time.perf_counter() - t0)

  proc = {"host sets": rate(sets, False), "host sets + fetch": rate(sets, True),
          "card sets": rate(dev_sets, False),
          "card sets + fetch": rate(dev_sets, True)}
  timing = dict(cli_sets_per_s=cli, cli_serial_sets_per_s=serial,
                cli_jpeg_sets_per_s=jpeg, jpeg_runs=jpeg_rates,
                process_sets_per_s=proc,
                breakdown=_apps_breakdown(timed, sets))
  log(f"timing apps tonemap_scan 6x4K (Camera32, rotate_90, RGB fetch) from "
      f"the page cache, no JPEG: {cli[0]:.2f} / {cli[1]:.2f} sets/s (two "
      f"runs of {APP_SETS} sets), --pipeline_depth 0 {serial:.2f} sets/s; "
      f"writing JPEGs: {jpeg:.2f} sets/s ({APP_JPEG_SETS} sets); process "
      f"({APP_STEPS} sets, host clock to a synchronize): "
      + ", ".join(f"{k} {v:.2f}" for k, v in proc.items())
      + f" sets/s; {card}")
  return timing


def _apps_benches():
  """(c): the bench modules at 6x4K / 2160x3840, each kernel side's
  launches counted; returns (launch counts, printed lines)."""
  import torch._inductor.config
  # the shootout's torch.compile side compiles in this process, so that no
  # compile worker pool is left to stop
  torch._inductor.config.compile_threads = 1
  from taichi_image_tpu_torch.bench import bayer as bench_bayer
  from taichi_image_tpu_torch.bench import camera_isp as bench_isp
  from taichi_image_tpu_torch.bench import interpolate as bench_interp
  from taichi_image_tpu_torch.bench import shootout
  runs = [
      ("bench.camera_isp", bench_isp.main, ["--iterations", "200"],
       {f"{st}_f16": 1 + 20 + 200 for st in _MAIN}),
      ("bench.bayer", bench_bayer.main,
       ["--iterations", "1000", "--warmup", "50"], {"demosaic_f32": 1050}),
      ("bench.interpolate", bench_interp.main,
       ["--iterations", "500", "--warmup", "20"], {}),
      # the kernel side of each race: a warm-up and 3 reps of 10 steps
      ("bench.shootout", shootout.main, [],
       {"demosaic_f32": 40, "decode_bf16": 40}),
  ]
  total, lines = {}, {}
  for name, fn, argv, expect in runs:
    out, secs, launches = _app_run(fn, argv, expect)
    _add(total, launches)
    lines[name] = out.splitlines()
    log(f"apps {name} {' '.join(argv)} ({secs:.1f} s, launches {launches}):")
    for line in lines[name]:
      log(f"  {line}")
  return total, lines


def _apps_other_clis(root, scan):
  """(d): tonemap_images on two 2160x3840 u16 PNG CFAs, decode_packed on
  one 4K raw, compare_bayer on a 1080x1920 PNG; returns launch counts."""
  import numpy as np
  import torch
  from PIL import Image
  from taichi_image_tpu_torch.ops import bayer
  from taichi_image_tpu_torch.scripts import (compare_bayer, decode_packed,
                                              tonemap_images)
  gen = torch.Generator(device="cuda").manual_seed(13)
  yy, xx = torch.meshgrid(
      torch.arange(H, dtype=torch.float32, device="cuda"),
      torch.arange(W, dtype=torch.float32, device="cuda"), indexing="ij")
  rgb = torch.stack([0.5 + 0.4 * torch.sin(xx / 61.0),
                     0.5 + 0.4 * torch.cos(yy / 43.0),
                     0.5 + 0.4 * torch.sin((xx - yy) / 89.0)], dim=-1)
  cfas = root / "cfa"
  cfas.mkdir()
  for i in range(2):
    img = (rgb * (0.7 + 0.1 * i) + 0.01 * torch.randn(
        rgb.shape, generator=gen, device="cuda")).clamp(0.0, 1.0)
    cfa = (bayer.rgb_to_bayer(img) * 65535.0).to(torch.int32).cpu().numpy()
    Image.fromarray(cfa.astype(np.uint16)).save(str(cfas / f"im{i}.png"),
                                                compress_level=1)
  total = {}
  out = root / "images_out"
  _, secs, launches = _app_run(
      tonemap_images.main, [str(cfas), "--write", str(out)],
      {f"{st}_f32": 2 for st in ("split_u16", "demosaic", "reinhard",
                                 "finish")})
  _add(total, launches)
  if len(list(out.glob("*.jpg"))) != 2:
    raise AssertionError(f"tonemap_images wrote {list(out.glob('*'))}")
  log(f"apps tonemap_images: 2 {H}x{W} u16 PNG CFAs -> 2 JPEGs "
      f"({secs:.2f} s), launches {launches}")
  dest = root / "decoded.jpg"
  text, secs, launches = _app_run(
      decode_packed.main, [str(scan / "cam0" / "frame000.raw"), "--width",
                           str(W), "--out", str(dest)],
      {f"{st}_f32": 1 for st in _MAIN})
  _add(total, launches)
  if not dest.is_file() or f"({W}x{H})" not in text:
    raise AssertionError(f"decode_packed: {text!r}")
  log(f"apps decode_packed: {text.strip()} ({secs:.2f} s), launches "
      f"{launches}")
  png = root / "rgb1080.png"
  small = (rgb[::2, ::2] * 255.0).to(torch.uint8).cpu().numpy()
  Image.fromarray(small).save(str(png), compress_level=1)
  text, secs, launches = _app_run(compare_bayer.main, [str(png)],
                                  {"demosaic_f32": 8})
  _add(total, launches)
  log(f"apps compare_bayer on a {small.shape[0]}x{small.shape[1]} PNG "
      f"({secs:.2f} s), launches {launches}:")
  for line in text.splitlines():
    log(f"  {line}")
  return total


def _apps_utils(root, sets):
  """(e): profiling.trace around one process step names the port's
  kernels; types.from_dlpack of a CUDA tensor shares its memory."""
  import torch
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch import types
  from taichi_image_tpu_torch.utils import profiling
  isp = ttit.Camera32(ttit.BayerPattern.RGGB, device="cuda")
  raws = torch.from_numpy(sets[0]).cuda()
  isp.process(raws)
  torch.cuda.synchronize()
  tdir = root / "trace"
  with profiling.trace(str(tdir)):
    with profiling.annotate("process"):
      isp.process(raws)
    torch.cuda.synchronize()
  files = sorted(tdir.glob("*.pt.trace.json"))
  if len(files) != 1:
    raise AssertionError(f"profiling.trace wrote {files}")
  events = json.loads(files[0].read_text())["traceEvents"]
  names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
  want = ("decode12_kernel", "stencil_kernel", "map_kernel", "finish_")
  missing = [k for k in want if not any(k in n for n in names)]
  if missing or not any(e.get("name") == "process" for e in events):
    raise AssertionError(f"the trace lacks {missing} (kernels {names})")
  t = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
  for src in (t.__dlpack__(), t):
    u = types.from_dlpack(src)
    if u.data_ptr() != t.data_ptr() or u.device != t.device:
      raise AssertionError(f"from_dlpack copied: {u.device} {u.data_ptr()}")
  u[0] = -1.0
  if t[0].item() != -1.0:
    raise AssertionError("from_dlpack's tensor does not share memory")
  log(f"apps utils: profiling.trace wrote {files[0].name} "
      f"({files[0].stat().st_size} bytes) naming "
      f"{sorted(n[:60] for n in names)}; types.from_dlpack of a CUDA "
      "tensor and of its __dlpack__ capsule share its memory")


def phase_apps(card):
  """The apps and tooling layer at 6x4K, its files staged in a temporary
  directory: (a) tonemap_scan's runs checked, (b) its rate and
  ``process``'s timed, (c) the benches, (d) the other CLIs, (e) utils.
  Returns (launch counts, timing)."""
  import pathlib
  import tempfile
  total = {}
  with tempfile.TemporaryDirectory(prefix="chip-smoke-apps-") as tmp:
    root = pathlib.Path(tmp)
    scan = _app_scan(root)
    sets = _host_sets(scan)
    launches, jpeg_rates = _apps_scan_checks(root, scan, sets)
    _add(total, launches)
    timing = _apps_timing(card, root, scan, sets, jpeg_rates)
    launches, timing["bench_lines"] = _apps_benches()
    _add(total, launches)
    _add(total, _apps_other_clis(root, scan))
    _apps_utils(root, sets)
  return total, timing


def _chain_large(inputs, dtype, driver, checksum):
  """K chained 6x8K steps of the working dtype through ``process_banded``
  with ``driver``, the EMA carried over; with ``checksum`` every output
  summed into one device scalar."""
  import torch
  from taichi_image_tpu_torch import BayerPattern
  from taichi_image_tpu_torch.models import large
  m = torch.zeros(9, device="cuda")
  acc = torch.zeros((), dtype=torch.int64, device="cuda")
  for raws in inputs:
    m, out = large.process_banded(raws, m, 0.9, n_bands=4, work_dtype=dtype,
                                  pattern=BayerPattern.RGGB, driver=driver)
    if checksum:
      acc += out.sum(dtype=torch.int64)
  return acc


def phase_large_timing(card):
  """The 6x8K step of each class through process_banded with the
  whole-frame driver and with the band loop, by bench.py's method (K
  chained steps, a distinct XOR byte each, median of 5, CUDA events,
  sync-debug "error"), with and without the checksum, in turns (auto,
  loop, loop, auto); and each one's profile (device operations per step,
  busy share) and its peak of device memory in one step."""
  import torch
  from taichi_image_tpu_torch.ops import hopper
  gen = torch.Generator(device="cuda").manual_seed(4)
  base = torch.randint(0, 256, (N_CAM, H8, WB8), generator=gen,
                       device="cuda", dtype=torch.uint8)
  inputs = [base ^ i for i in range(K)]
  del base
  out = {}
  for dtype, sfx in hopper.DTYPE_SUFFIX.items():
    name = f"{CLASSES[sfx]} 6x8K"
    for ck in (True, False):
      runs = {"auto": [], "loop": []}
      for driver in ("auto", "loop", "loop", "auto"):
        times, host, _ = bench_step(
            inputs, None, chain=lambda i, d=driver, c=ck: _chain_large(
                i, dtype, d, c))
        runs[driver].append((statistics.median(times),
                             statistics.median(host)))
      for driver, rs in runs.items():
        out[f"{name} {driver}" + ("" if ck else " bare")] = dict(
            step_ms=min(r[0] for r in rs), runs=rs)
      tag = "incl. the u8 checksum" if ck else "without the checksum"
      log(f"timing {name} process_large {tag}: auto "
          f"{min(r[0] for r in runs['auto']):.4f}, loop "
          f"{min(r[0] for r in runs['loop']):.4f} ms/step (lower of two "
          f"medians of {REPS} x {K} chained steps each, in turns; (device, "
          f"host enqueue) medians {runs}); {card}")
    for driver in ("auto", "loop"):
      busy, ops = profile_step(f"{name} {driver}", inputs, None,
                               chain=lambda i, d=driver: _chain_large(
                                   i, dtype, d, False))
      # the step's peak of device memory above what was allocated before
      # it (the inputs), one step, without the checksum
      torch.cuda.synchronize()
      before = torch.cuda.memory_allocated()
      torch.cuda.reset_peak_memory_stats()
      _chain_large(inputs[:1], dtype, driver, False)
      torch.cuda.synchronize()
      peak = (torch.cuda.max_memory_allocated() - before) / 2**30
      out[f"{name} {driver} bare"].update(busy_share=busy, ops_per_step=ops,
                                          peak_gib=peak)
      log(f"memory {name} {driver}: peak {peak:.3f} GiB above the inputs "
          f"in one step; {card}")
  del inputs
  torch.cuda.synchronize()
  return out


def phase_host_api():
  """The module-level entry points given host (numpy) arrays run on the
  card by default: bayer_to_rgb (K2<f32>, its launches counted and
  within 1 count of the CPU's plain route), rgb_to_bayer, kernel.conv,
  the packed codecs and PackedMono12, each bitwise its CPU result."""
  import numpy as np
  import torch
  from taichi_image_tpu_torch.ops import bayer, hopper, packed
  from taichi_image_tpu_torch.ops import kernel as tkernel

  rng = np.random.default_rng(5)
  cfa = rng.integers(0, 65536, (H, W), dtype=np.uint16)
  torch.cuda.synchronize()
  hopper.reset_launches()
  rgb = bayer.bayer_to_rgb(cfa, dtype=np.uint8)
  torch.cuda.synchronize()
  got = {n: v for n, v in hopper.launch_counts().items() if v}
  if not rgb.is_cuda or got != {"demosaic_f32": 1}:
    raise AssertionError(f"bayer_to_rgb of a host array: on {rgb.device}, "
                         f"launches {got}")
  small = cfa[:64, :96]
  d = (bayer.bayer_to_rgb(small, dtype=np.uint8).cpu().int()
       - bayer.bayer_to_rgb(small, dtype=np.uint8, device="cpu").int())
  if d.abs().max().item() > 1:
    raise AssertionError(f"bayer_to_rgb card vs CPU: {d.abs().max()}")
  img = rng.random((64, 96, 3), np.float32)
  u8 = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
  codes = rng.integers(0, 4096, (64, 96), dtype=np.uint16)
  p12 = packed.encode12(codes, device="cpu").numpy()
  taps = tkernel.kernel_square([1, 2, 1, 2, 4, 2, 1, 2, 1], 3)
  checks = {
      "rgb_to_bayer": lambda dev: bayer.rgb_to_bayer(img, device=dev),
      "conv": lambda dev: tkernel.conv(u8, taps, device=dev),
      "encode12": lambda dev: packed.encode12(codes, device=dev),
      "decode12": lambda dev: packed.decode12(p12, device=dev),
      "decode12 f32": lambda dev: packed.decode12(p12, np.float32, True,
                                                  device=dev),
      "encode16": lambda dev: packed.encode16(img, True, device=dev),
      "decode16": lambda dev: packed.decode16(u8.reshape(64, -1),
                                              device=dev),
      "PackedMono12": lambda dev: packed.PackedMono12(p12, device=dev)[
          np.arange(10), np.arange(10) * 7],
  }
  for what, fn in checks.items():
    k, c = fn("cuda"), fn("cpu")
    if not k.is_cuda:
      raise AssertionError(f"{what}: ran on {k.device}")
    if k.dtype == torch.uint16:  # copied to the host as its int16 bits
      k, c = k.view(torch.int16), c.view(torch.int16)
    _check_bits(f"{what} card vs CPU", k.cpu(), c)
  log(f"host API: bayer_to_rgb of a {H}x{W} host CFA on the card (launches "
      f"{got}), within 1 count of the CPU; {', '.join(checks)} on the card "
      "bitwise the CPU")


def _inputs(fmt="packed12"):
  """K raw batches at 6x4K of ``fmt``, a distinct XOR byte (of the bits,
  below a float's exponent) per chained step, made before the clock
  starts."""
  import torch
  gen = torch.Generator(device="cuda").manual_seed(0)
  if fmt == "packed12":
    base = torch.randint(0, 256, (N_CAM, H, WB), generator=gen,
                         device="cuda", dtype=torch.uint8)
    return [base ^ i for i in range(K)]
  base = format_raws(fmt, (N_CAM, H, WB), gen, wide=False)
  it = {torch.uint8: torch.uint8, torch.uint16: torch.int16,
        torch.float16: torch.int16, torch.float32: torch.int32}[base.dtype]
  return [(base.view(it) ^ i).view(base.dtype) for i in range(K)]


def _chain(inputs, args, checksum=True):
  """K chained steps, the EMA carried over; with ``checksum``, every
  output summed into one device scalar."""
  import torch
  from taichi_image_tpu_torch.models import camera_isp as ci
  m = torch.zeros(9, device="cuda")
  acc = torch.zeros((), dtype=torch.int64, device="cuda")
  for raws in inputs:
    m, out = ci.fused_isp_step(raws, m, 0.9, *args)
    if checksum:
      for o in _outputs(out):
        acc += o.sum(dtype=torch.int64)
  return acc


def _chain_api(inputs, name, lazy):
  """K chained steps through a fresh ISP of class ``name``: ``process``,
  or (``lazy``) each camera's ``load_packed12`` then one
  ``tonemap_reinhard``; every output summed into one device scalar."""
  import torch
  import taichi_image_tpu_torch as ttit
  isp = getattr(ttit, name)(ttit.BayerPattern.RGGB, device="cuda")
  acc = torch.zeros((), dtype=torch.int64, device="cuda")
  for raws in inputs:
    if lazy:
      handles = isp.tonemap_reinhard([isp.load_packed12(r) for r in raws])
      out = handles[0]._batch[1]  # the step's output batch they share
    else:
      out = isp.process(raws)
    acc += out.sum(dtype=torch.int64)
  return acc


def bench_step(inputs, args, checksum=True, env=None, chain=None):
  """bench.py's method with CUDA events: :func:`_chain` (or ``chain``
  of the inputs) REPS times under torch's sync-debug "error" mode, the
  scalar read at the end. Returns (device ms/step per rep, host enqueue
  ms/step per rep, checksum)."""
  import torch
  if chain is None:
    def chain(inputs):
      return _chain(inputs, args, checksum)
  with _env(env):
    chain(inputs)
    torch.cuda.synchronize()
    times, host = [], []
    torch.cuda.set_sync_debug_mode("error")  # the step must not sync
    try:
      for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        acc = chain(inputs)
        host.append((time.perf_counter() - t0) * 1e3 / K)
        b.record()
        torch.cuda.set_sync_debug_mode(0)
        b.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        times.append(a.elapsed_time(b) / K)
    finally:
      torch.cuda.set_sync_debug_mode(0)
  return times, host, acc.item()


def profile_step(name, inputs, args, env=None, chain=None):
  """Device busy share of K chained steps (no checksum; or ``chain`` of
  the inputs) from a profiler trace, the sum of kernel times on the one
  stream over the window, and the device operations (kernels and
  memsets) per step; logs the kernels by device time. Returns (busy
  share or None, operations)."""
  import torch
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  if chain is None:
    def chain(inputs):
      return _chain(inputs, args, checksum=False)
  with _env(env):
    chain(inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      a = torch.cuda.Event(enable_timing=True)
      b = torch.cuda.Event(enable_timing=True)
      a.record()
      chain(inputs)
      b.record()
      b.synchronize()
  window_us = a.elapsed_time(b) * 1e3
  kern = [(e.key, e.self_device_time_total, e.count)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
  busy_us = sum(t for _, t, _ in kern)
  busy = busy_us / window_us if busy_us else None
  ops = sum(c for _, _, c in kern) / K  # kernels and memsets
  if busy is None:
    log(f"profile {name}: no device time in the trace (busy share not "
        "measured)")
  else:
    log(f"profile {name}: device busy {busy:.1%} of a {K}-step window "
        f"({window_us / K / 1e3:.4f} ms/step traced), {ops:g} device "
        "operations (kernels and memsets) per step; per step:")
    for key, t, count in sorted(kern, key=lambda r: -r[1])[:12]:
      log(f"  {t / K / 1e3:.4f} ms  x{count // K:<3d} {key[:70]}")
  return busy, ops


def phase_timing(card, sfx):
  """bench.py's method with CUDA events, plus a per-stage table, for one
  class's step."""
  import torch
  from taichi_image_tpu_torch.models import camera_isp as ci
  from taichi_image_tpu_torch.ops import hopper
  from taichi_image_tpu_torch.ops.bayer import BayerPattern
  from taichi_image_tpu_torch.ops.hopper import finish

  dtype = next(d for d, s in hopper.DTYPE_SUFFIX.items() if s == sfx)
  name = CLASSES[sfx]
  dev = torch.device("cuda")
  inputs = _inputs()
  args = _step_args(dtype)
  times, host, checksum = bench_step(inputs, args)
  step_ms = statistics.median(times)
  fps = N_CAM / (step_ms / 1e3)
  log(f"timing {name}: {step_ms:.4f} ms/step (median of {REPS} x {K} "
      f"chained steps, incl. the u8 checksum), {fps:.2f} frames/s, best "
      f"{min(times):.4f} ms; host enqueue {statistics.median(host):.4f} "
      f"ms/step; checksum {checksum}; {card}")
  bare, bare_host, _ = bench_step(inputs, args, checksum=False)
  bare_ms = statistics.median(bare)
  log(f"timing {name}: {bare_ms:.4f} ms/step without the checksum "
      f"reduction, {N_CAM / (bare_ms / 1e3):.2f} frames/s; host enqueue "
      f"{statistics.median(bare_host):.4f} ms/step")

  busy, ops = profile_step(name, inputs, args)

  # per-stage table, each stage alone at the main path's shapes
  raws = inputs[0]
  phases = ci.load_raw_phases(raws, "packed12", dtype)
  x12, samp = ci.demosaic_phases(phases, BayerPattern.RGGB, out_dtype=dtype,
                                 sample_step=4)
  prev = torch.zeros(9, device=dev)
  metrics = ci.metering_update_ca(samp, prev, 0.0)
  p_cast, max_out = ci.reinhard_map_max_ca(x12, metrics, 1.0, 1.0, 0.0,
                                           dtype)
  out = finish.finish_planar_u8(p_cast, max_out, 1.0)
  stages = {
      "decode": lambda: ci.load_raw_phases(raws, "packed12", dtype),
      "stencil": lambda: ci.demosaic_phases(
          phases, BayerPattern.RGGB, out_dtype=dtype, sample_step=4),
      "metering": lambda: ci.metering_update_ca(samp, prev, 0.9),
      "map": lambda: ci.reinhard_map_max_ca(x12, metrics, 1.0, 1.0, 0.0,
                                            dtype),
      "tail": lambda: finish.finish_planar_u8(p_cast, max_out, 1.0),
      "checksum": lambda: out.sum(dtype=torch.int64),
  }
  hh, wh = H // 2, W // 2
  e = x12.element_size()
  nbytes = {  # logical bytes, as bench.py's table counts them
      "decode": N_CAM * H * WB + N_CAM * 4 * hh * wh * e,
      "stencil": N_CAM * 4 * hh * wh * e + N_CAM * 12 * hh * wh * e,
      "map": 2 * N_CAM * 12 * hh * wh * e,
      "tail": N_CAM * 12 * hh * wh * e + N_CAM * 3 * H * W,
      "checksum": N_CAM * 3 * H * W,
  }
  stage_ms = {}
  log(f"stage      ms      GB/s  (6x4K {sfx}, median of 7 batches of 10, "
      "CUDA events)")
  for stage, fn in stages.items():
    stage_ms[stage] = median_ms(fn)
    gbs = (nbytes[stage] / (stage_ms[stage] / 1e3) / 1e9
           if stage in nbytes else float("nan"))
    log(f"  {stage:9s} {stage_ms[stage]:.4f} {gbs:8.1f}")
  return dict(step_ms=step_ms, best_ms=min(times), fps=fps, times=times,
              host_ms=host, bare_step_ms=bare_ms, bare_times=bare,
              bare_host_ms=bare_host, busy_share=busy, ops_per_step=ops,
              stages=stage_ms,
              stage_bytes=nbytes)


def phase_route_timing(card):
  """The same step method for the other routes: the resize->1920 step of
  each class, the transform and linear marginals (bf16), the front-fused
  bf16 step against the composed one in turns (composed, fused, fused,
  composed), and the I420 marginal of each class's 6x4K and resize->1920
  steps the same way."""
  from taichi_image_tpu_torch.ops import hopper
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform

  inputs = _inputs()
  plan = ((1920, 1080), 1920 / W)
  steps = {}
  for dtype, sfx in hopper.DTYPE_SUFFIX.items():
    steps[f"{CLASSES[sfx]} resize1920"] = (_step_args(dtype, plan), None)
  bf16 = next(d for d, s in hopper.DTYPE_SUFFIX.items() if s == "bf16")
  steps.update({
      "CameraBF16 resize1920+rotate_90": (_step_args(
          bf16, plan, transform=ImageTransform.rotate_90), None),
      "CameraBF16 flip_horiz": (_step_args(
          bf16, transform=ImageTransform.flip_horiz), None),
      "CameraBF16 rotate_90": (_step_args(
          bf16, transform=ImageTransform.rotate_90), None),
      "CameraBF16 linear": (_step_args(bf16, tonemap="linear"), None),
  })
  out = {}
  for name, (args, env) in steps.items():
    times, host, checksum = bench_step(inputs, args, env=env)
    out[name] = dict(step_ms=statistics.median(times), times=times,
                     host_ms=host)
    log(f"timing {name}: {out[name]['step_ms']:.4f} ms/step (median of "
        f"{REPS} x {K} chained steps, incl. the u8 checksum); host enqueue "
        f"{statistics.median(host):.4f} ms/step; checksum {checksum}; "
        f"{card}")
    if name.endswith("resize1920"):
      # the resize step's profile and its enqueue without the checksum
      _, bare_host, _ = bench_step(inputs, args, checksum=False)
      busy, ops = profile_step(name, inputs, args)
      out[name].update(bare_host_ms=bare_host, busy_share=busy,
                       ops_per_step=ops)
      log(f"timing {name}: host enqueue {statistics.median(bare_host):.4f} "
          "ms/step without the checksum")
  main_args = _step_args(bf16)
  pair = {"composed": [], "front-fused": []}
  for which in ("composed", "front-fused", "front-fused", "composed"):
    env = {FRONT_FUSED: "1"} if which == "front-fused" else None
    times, _, _ = bench_step(inputs, main_args, env=env)
    pair[which].append(statistics.median(times))
  for which, ms in pair.items():
    out[f"CameraBF16 {which}"] = dict(step_ms=min(ms), runs=ms)
  ff_env = {FRONT_FUSED: "1"}
  _, ff_host, _ = bench_step(inputs, main_args, checksum=False, env=ff_env)
  busy, ops = profile_step("CameraBF16 front-fused", inputs, main_args,
                           env=ff_env)
  out["CameraBF16 front-fused"].update(bare_host_ms=ff_host, busy_share=busy,
                                       ops_per_step=ops)
  log(f"timing CameraBF16 front-fused: host enqueue "
      f"{statistics.median(ff_host):.4f} ms/step without the checksum")
  log(f"timing CameraBF16 front-fused {min(pair['front-fused']):.4f} vs "
      f"composed {min(pair['composed']):.4f} ms/step (lower of two medians "
      f"each, taken in turns); {card}")
  # the I420 marginal: the RGB and I420 steps in turns (RGB, I420, I420,
  # RGB), the lower of each side's two medians; with the checksum (which
  # reads half the bytes of RGB's for I420) and without it
  for dtype, sfx in hopper.DTYPE_SUFFIX.items():
    for step, kw in (("6x4K", {}), ("resize1920", dict(plan=plan))):
      runs = {(fmt, ck): [] for fmt in ("rgb", "yuv420")
              for ck in (True, False)}
      for fmt in ("rgb", "yuv420", "yuv420", "rgb"):
        for ck in (True, False):
          times, _, _ = bench_step(
              inputs, _step_args(dtype, color_format=fmt, **kw), ck)
          runs[fmt, ck].append(statistics.median(times))
      low = {k: min(v) for k, v in runs.items()}
      r = out[f"{CLASSES[sfx]} {step} I420"] = dict(
          step_ms=low["yuv420", True], rgb_step_ms=low["rgb", True],
          marginal_ms=low["yuv420", True] - low["rgb", True],
          bare_step_ms=low["yuv420", False],
          rgb_bare_step_ms=low["rgb", False],
          bare_marginal_ms=low["yuv420", False] - low["rgb", False],
          runs={f"{f} {'checksum' if c else 'bare'}": v
                for (f, c), v in runs.items()})
      r["busy_share"], r["ops_per_step"] = profile_step(
          f"{CLASSES[sfx]} {step} I420", inputs,
          _step_args(dtype, color_format="yuv420", **kw))
      log(f"timing {CLASSES[sfx]} {step}: I420 {r['step_ms']:.4f} vs RGB "
          f"{r['rgb_step_ms']:.4f} ms/step with the checksum (marginal "
          f"{r['marginal_ms']:+.4f}), {r['bare_step_ms']:.4f} vs "
          f"{r['rgb_bare_step_ms']:.4f} without it (marginal "
          f"{r['bare_marginal_ms']:+.4f}); lower of two medians each, in "
          f"turns; runs {r['runs']}; {card}")
  return out


def phase_format_timing(card):
  """The 6x4K step of each class with packed16, u16 and f32 raws beside
  packed12 (bench.py's method), and the lazy list path's step against
  ``process`` (CameraBF16, in turns process, lazy, lazy, process)."""
  from taichi_image_tpu_torch.ops import hopper
  out = {}
  for fmt in ("packed12", "packed16", "u16", "f32"):
    inputs = _inputs(fmt)
    for dtype, sfx in hopper.DTYPE_SUFFIX.items():
      times, host, checksum = bench_step(inputs, _step_args(dtype, fmt=fmt))
      r = out[f"{CLASSES[sfx]} {fmt}"] = dict(
          step_ms=statistics.median(times), times=times, host_ms=host)
      log(f"timing {CLASSES[sfx]} {fmt}: {r['step_ms']:.4f} ms/step (median "
          f"of {REPS} x {K} chained steps, incl. the u8 checksum); host "
          f"enqueue {statistics.median(host):.4f} ms/step; checksum "
          f"{checksum}; {card}")
    del inputs
  inputs = _inputs()
  runs = {"process": [], "lazy": []}
  for which in ("process", "lazy", "lazy", "process"):
    times, host, _ = bench_step(inputs, None, chain=lambda i, w=which:
                                _chain_api(i, "CameraBF16", w == "lazy"))
    runs[which].append((statistics.median(times), statistics.median(host)))
  for which, rs in runs.items():
    out[f"CameraBF16 {which} API"] = dict(step_ms=min(r[0] for r in rs),
                                          runs=rs)
  log(f"timing CameraBF16 lazy list path (6 x load_packed12 -> "
      f"tonemap_reinhard) {out['CameraBF16 lazy API']['step_ms']:.4f} vs "
      f"process {out['CameraBF16 process API']['step_ms']:.4f} ms/step "
      f"(lower of two medians each, in turns; (device, host enqueue) "
      f"medians {runs}); {card}")
  return out


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--out", help="also write every measurement to this JSON")
  args = ap.parse_args(argv)
  t_start = time.perf_counter()

  card = phase_device()
  import torch
  from taichi_image_tpu_torch.ops import hopper
  build = phase_build()
  results = {}
  phase_kernels(results)
  phase_format_kernels(results)
  gen = torch.Generator(device="cuda").manual_seed(1)
  frames = [torch.randint(0, 256, (N_CAM, H, WB), generator=gen,
                          device="cuda", dtype=torch.uint8)
            for _ in range(FRAMES)]
  launches = dict.fromkeys(hopper.KERNELS, 0)
  for sfx in CLASSES:
    for n, v in phase_slice(frames, sfx).items():
      launches[n] += v
  for n, v in phase_routes(frames).items():
    launches[n] += v
  for n, v in phase_format_routes(frames).items():
    launches[n] += v
  phase_host_api()
  for n, v in phase_large().items():
    launches[n] += v
  par_launches, par_timing = phase_parallel(card, frames)
  for n, v in par_launches.items():
    launches[n] += v
  app_launches, app_timing = phase_apps(card)
  for n, v in app_launches.items():
    launches[n] += v
  never = sorted(n for n, v in launches.items() if v == 0)
  if never:
    raise AssertionError(f"kernels no route launched: {never}")
  timing = {CLASSES[sfx]: phase_timing(card, sfx) for sfx in CLASSES}
  timing["routes"] = phase_route_timing(card)
  timing["formats"] = phase_format_timing(card)
  timing["large"] = phase_large_timing(card)
  timing["parallel"] = par_timing
  timing["apps"] = app_timing

  kernels = []
  for name, k in hopper.KERNELS.items():
    r = results[name]
    kernels.append(dict(
        name=name, route="cuda",
        source=f"taichi_image_tpu_torch/ops/hopper/csrc/{k.source}",
        replaces=k.replaces, launches=launches[name],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"], share=r["share"]))
  if args.out:
    with open(args.out, "w") as f:
      json.dump(dict(card=card, build=build, kernels=kernels,
                     kernel_modes=results, timing=timing), f, indent=1)
  log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
  sys.exit(main())
