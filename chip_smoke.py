#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA Hopper GPU and check it.

Run from the repository root:

    python3 chip_smoke.py [--out results.json]

Phases (each prints a line; any failure raises and exits non-zero):

1. device   CUDA available, capability (9, 0); the card's name and power
            limit as nvidia-smi reports them.
2. build    nvcc builds the four kernel sources (csrc/*.cu, one process
            each, in parallel) from this checkout; each holds its
            kernel's bf16, f16 and f32 instantiations (12 in all).
3. kernels  each instantiation against its plain PyTorch twin on the
            card, at the 6 x 2160 x 5760-byte packed12 shape of the main
            path and at a small odd shape; kernel and twin times from CUDA
            events around batches of 10 calls.
4. slice    for each class, CameraBF16, Camera16 and Camera32
            (RGGB, device="cuda").process over 5 frames of 6 x 4K with
            the EMA carried over, compared frame by frame with the
            all-plain route on the card; the launch counts of that run
            (each class through its own dtype's four kernels); a small
            input against the plain route on the CPU.
5. timing   for each class, the step by bench.py's method (K chained
            steps, a distinct XOR byte per step, every output summed into
            one scalar read at the end, median of 5) under torch's
            sync-debug "error" mode (the step must not sync with the
            host); the step without the checksum; the device busy share
            from a torch.profiler trace; a per-stage table.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

N_CAM, H, W = 6, 2160, 3840
WB = W * 3 // 2
ODD = (3, 38, 150)          # small odd shape: H/2 = 19, W/2 = 50
FRAMES = 5
K = 10                      # chained steps per timed run
REPS = 5                    # timed runs (median)
CLASSES = {"bf16": "CameraBF16", "f16": "Camera16", "f32": "Camera32"}


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


def phase_build():
  from taichi_image_tpu_torch.ops import hopper
  t0 = time.perf_counter()
  libs = hopper.build_all()
  dt = time.perf_counter() - t0
  log(f"build: {len(libs)} sources, {len(hopper.KERNELS)} kernels in "
      f"{dt:.1f} s")
  for source, path in libs.items():
    regs = [ln.strip() for ln in path.with_suffix(".log").read_text()
            .splitlines() if "registers" in ln]
    log(f"  {source}: {path.name} | {'; '.join(regs)}")
  return dt


def phase_kernels(results):
  """Each kernel instantiation vs its plain twin on the card; fills
  ``results`` {kernel name: {ms, plain_ms, max_abs_err}}."""
  import torch
  from taichi_image_tpu_torch.models.camera_isp import (default_cc,
                                                        metering_update_ca)
  from taichi_image_tpu_torch.ops import hopper
  from taichi_image_tpu_torch.ops.bayer import (BayerPattern,
                                                _demosaic_tables,
                                                _stencil_finish_spec)
  from taichi_image_tpu_torch.ops.hopper import decode, demosaic, finish
  from taichi_image_tpu_torch.ops.hopper import reinhard

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev).manual_seed(0)
  ccm = tuple((default_cc * [1.8, 1.0, 2.1]).astype("float32").ravel()
              .tolist())
  weights = _demosaic_tables(BayerPattern.RGGB, "mhc")
  err = {name: 0.0 for name in hopper.KERNELS}

  def note(name, a, b):
    err[name] = max(err[name], (a.float() - b.float()).abs().max().item())

  for shape in ((N_CAM, H, WB), ODD):
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
      # K2: bitwise without a CCM, <= 1 ulp of T with one
      for cc in (None, ccm):
        fin = _stencil_finish_spec(weights, hh, wh, cc, dtype)
        kx, ks = demosaic.demosaic_stencil(phases, weights, fin, 4,
                                           backend="kernel")
        px, ps = demosaic.demosaic_stencil(phases, weights, fin, 4,
                                           backend="plain")
        ux, us = ulps(kx, px), ulps(ks, ps)
        if cc is None and (ux or us):
          raise AssertionError(f"demosaic {kt}: not bitwise ({ux}, {us})")
        if max(ux, us) > 1:
          raise AssertionError(f"demosaic {kt} ccm: {max(ux, us)} ulps")
        if ulps(ks, kx[:, 0:3, ::4, ::4]):
          raise AssertionError(f"demosaic {kt}: sample != "
                               "x12[:, :3, ::4, ::4]")
        note(f"demosaic_{sfx}", kx, px)
      fin = _stencil_finish_spec(weights, hh, wh, None, dtype)
      x12, samp = demosaic.demosaic_stencil(phases, weights, fin, 4,
                                            backend="kernel")
      metrics = metering_update_ca(samp, torch.zeros(9, device=dev), 0.0)
      # K3: p <= 1 ulp of T, max within 1e-6 relative, both adapt modes
      for ca in (0.0, 0.5):
        scal = (reinhard.reinhard_scal_ca(metrics, 1.0, 1.0, ca) if ca
                else reinhard.reinhard_scal(metrics, 1.0, 1.0))
        kp, km = reinhard.reinhard_map(x12, scal, bool(ca), backend="kernel")
        pp, pm = reinhard.reinhard_map(x12, scal, bool(ca), backend="plain")
        u = ulps(kp, pp)
        rel = ((km - pm).abs() / pm.abs().clamp_min(1e-30)).max().item()
        if u > 1 or rel > 1e-6:
          raise AssertionError(f"reinhard {kt} ca={ca}: {u} ulps, max rel "
                               f"{rel:.3g}")
        note(f"reinhard_{sfx}", kp, pp)
        note(f"reinhard_{sfx}", km, pm)
      # K4: bitwise at gamma 1 and 2.2
      scal0 = reinhard.reinhard_scal(metrics, 1.0, 1.0)
      p_cast, max_out = reinhard.reinhard_map(x12, scal0, False)
      for gamma in (1.0, 2.2):
        ko = finish.finish_planar_u8(p_cast, max_out, gamma,
                                     backend="kernel")
        po = finish.finish_planar_u8(p_cast, max_out, gamma,
                                     backend="plain")
        if not torch.equal(ko, po):
          d = (ko.int() - po.int()).abs()
          raise AssertionError(f"finish {kt} gamma={gamma}: not bitwise "
                               f"(max {d.max().item()}, "
                               f"{(d != 0).sum().item()} bytes)")
        note(f"finish_{sfx}", ko, po)
      log(f"kernels {kt}: decode, demosaic, reinhard, finish agree with "
          "their plain twins")
      if shape == ODD:
        continue
      # times at the main path's shapes
      calls = {
          f"decode_{sfx}": lambda b: decode.decode12_phases(
              raws, False, dtype, backend=b),
          f"demosaic_{sfx}": lambda b: demosaic.demosaic_stencil(
              phases, weights, fin, 4, backend=b),
          f"reinhard_{sfx}": lambda b: reinhard.reinhard_map(
              x12, scal0, False, backend=b),
          f"finish_{sfx}": lambda b: finish.finish_planar_u8(
              p_cast, max_out, 1.0, backend=b),
      }
      for name, call in calls.items():
        # plain, kernel, kernel, plain; keep the lower median of each side
        t = [median_ms(lambda: call(b)) for b in
             ("plain", "kernel", "kernel", "plain")]
        results[name] = dict(ms=min(t[1], t[2]), plain_ms=min(t[0], t[3]))
        log(f"  {name}: kernel {results[name]['ms']:.4f} ms, plain "
            f"{results[name]['plain_ms']:.4f} ms (6x4K, median of 7 "
            "batches of 10)")
  for name in err:
    results[name]["max_abs_err"] = err[name]
  torch.cuda.synchronize()


def _step_args(dtype):
  """fused_isp_step's static arguments of the main path after prev, t:
  gamma, intensity, light_adapt, color_adapt, fmt, ids_format,
  work_dtype, pattern, cc, resize_plan, stride, transform, tonemap."""
  from taichi_image_tpu_torch.ops.bayer import BayerPattern
  from taichi_image_tpu_torch.ops.interpolate import ImageTransform
  return (1.0, 1.0, 1.0, 0.0, "packed12", False, dtype, BayerPattern.RGGB,
          None, None, 8, ImageTransform.none, "reinhard")


def phase_slice(frames, sfx):
  """One class's main path, 5 frames at 6x4K, against the all-plain
  route; returns the launch counts of its run."""
  import numpy as np
  import torch
  import taichi_image_tpu_torch as ttit
  from taichi_image_tpu_torch import BayerPattern
  from taichi_image_tpu_torch.models.camera_isp import fused_isp_step
  from taichi_image_tpu_torch.ops import hopper

  cls = getattr(ttit, CLASSES[sfx])
  dev = torch.device("cuda")
  isp = cls(BayerPattern.RGGB, device="cuda")
  torch.cuda.synchronize()
  hopper.reset_launches()
  prevs, outs, metrics = [], [], []
  for raws in frames:
    prevs.append(None if isp.metrics is None else isp.metrics.clone())
    outs.append(isp.process(raws))
    metrics.append(isp.metrics.clone())
  torch.cuda.synchronize()
  launches = hopper.launch_counts()
  own = {f"{st}_{sfx}" for st in ("decode", "demosaic", "reinhard",
                                  "finish")}
  if (any(launches[n] == 0 for n in own)
      or any(v for n, v in launches.items() if n not in own)):
    raise AssertionError(f"{cls.__name__} did not run through its own four "
                         f"kernels alone: {launches}")
  log(f"slice {cls.__name__}: launches over {FRAMES} frames "
      f"{ {n: launches[n] for n in sorted(own)} }")

  for f, raws in enumerate(frames):
    out, m = outs[f], metrics[f]
    if out.shape != (N_CAM, 3, H, W) or out.dtype != torch.uint8:
      raise AssertionError(f"frame {f}: output {tuple(out.shape)} {out.dtype}")
    if out.max().item() == out.min().item():
      raise AssertionError(f"frame {f}: constant output")
    if not torch.isfinite(m).all():
      raise AssertionError(f"frame {f}: non-finite metrics {m}")
    prev = (torch.zeros(9, device=dev) if prevs[f] is None else prevs[f])
    t = 0.0 if prevs[f] is None else 1.0 - isp.moving_alpha
    pm, po = fused_isp_step(raws, prev, t, *_step_args(cls._work_dtype),
                            backend="plain")
    dm = (m - pm).abs().max().item()
    d = (out.int() - po.int()).abs()
    if dm > 1e-5 or d.max().item() > 1:
      raise AssertionError(f"frame {f}: vs plain route metrics |d| {dm:.3g}"
                           f", u8 max {d.max().item()}")
    log(f"  frame {f}: metrics |d| {dm:.3g}, u8 max |d| {d.max().item()} "
        f"({(d != 0).float().mean().item():.2e} of bytes)")

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
  return {n: launches[n] for n in own}


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
  gen = torch.Generator(device=dev).manual_seed(0)
  base = torch.randint(0, 256, (N_CAM, H, WB), generator=gen, device=dev,
                       dtype=torch.uint8)
  # a distinct XOR byte per chained step, made before the clock starts
  inputs = [base ^ i for i in range(K)]
  args = _step_args(dtype)

  def chain(checksum=True):
    m = torch.zeros(9, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for raws in inputs:
      m, out = ci.fused_isp_step(raws, m, 0.9, *args)
      if checksum:
        acc += out.sum(dtype=torch.int64)
    return acc

  def timed(checksum):
    """(device ms/step per rep, host enqueue ms/step per rep, checksum)"""
    chain(checksum)
    torch.cuda.synchronize()
    times, host = [], []
    torch.cuda.set_sync_debug_mode("error")  # the step must not sync
    try:
      for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        acc = chain(checksum)
        host.append((time.perf_counter() - t0) * 1e3 / K)
        b.record()
        torch.cuda.set_sync_debug_mode(0)
        b.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        times.append(a.elapsed_time(b) / K)
    finally:
      torch.cuda.set_sync_debug_mode(0)
    return times, host, acc.item()

  times, host, checksum = timed(True)
  step_ms = statistics.median(times)
  fps = N_CAM / (step_ms / 1e3)
  log(f"timing {name}: {step_ms:.4f} ms/step (median of {REPS} x {K} "
      f"chained steps, incl. the u8 checksum), {fps:.2f} frames/s, best "
      f"{min(times):.4f} ms; host enqueue {statistics.median(host):.4f} "
      f"ms/step; checksum {checksum}; {card}")
  bare, bare_host, _ = timed(False)
  bare_ms = statistics.median(bare)
  log(f"timing {name}: {bare_ms:.4f} ms/step without the checksum "
      f"reduction, {N_CAM / (bare_ms / 1e3):.2f} frames/s; host enqueue "
      f"{statistics.median(bare_host):.4f} ms/step")

  # device busy share of K chained steps (no checksum), from a profiler
  # trace: the sum of kernel times on the one stream over the window
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    chain(False)
    b.record()
    b.synchronize()
  window_us = a.elapsed_time(b) * 1e3
  kern = [(e.key, e.self_device_time_total, e.count)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
  busy_us = sum(t for _, t, _ in kern)
  busy = busy_us / window_us if busy_us else None
  if busy is None:
    log("profile: no device time in the trace (busy share not measured)")
  else:
    log(f"profile {name}: device busy {busy:.1%} of a {K}-step window "
        f"({window_us / K / 1e3:.4f} ms/step traced); per step:")
    for key, t, count in sorted(kern, key=lambda r: -r[1])[:12]:
      log(f"  {t / K / 1e3:.4f} ms  x{count // K:<3d} {key[:70]}")

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
              bare_host_ms=bare_host, busy_share=busy, stages=stage_ms,
              stage_bytes=nbytes)


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--out", help="also write every measurement to this JSON")
  args = ap.parse_args(argv)

  card = phase_device()
  import torch
  from taichi_image_tpu_torch.ops import hopper
  build_s = phase_build()
  results = {}
  phase_kernels(results)
  gen = torch.Generator(device="cuda").manual_seed(1)
  frames = [torch.randint(0, 256, (N_CAM, H, WB), generator=gen,
                          device="cuda", dtype=torch.uint8)
            for _ in range(FRAMES)]
  launches = {}
  for sfx in CLASSES:
    launches.update(phase_slice(frames, sfx))
  timing = {CLASSES[sfx]: phase_timing(card, sfx) for sfx in CLASSES}

  kernels = []
  for name, k in hopper.KERNELS.items():
    r = results[name]
    kernels.append(dict(
        name=name, route="cuda",
        source=f"taichi_image_tpu_torch/ops/hopper/csrc/{k.source}",
        replaces=k.replaces, launches=launches[name],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"]))
  if args.out:
    with open(args.out, "w") as f:
      json.dump(dict(card=card, build_s=build_s, kernels=kernels,
                     timing=timing), f, indent=1)
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
  sys.exit(main())
