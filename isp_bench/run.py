"""One run of one cell of the benchmark:

    python3 -m isp_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's ISP (its kernels from the checkout's build cache,
built there on a checkout's first run), makes the cell's raw sets from
the seed, warms up the cell's own route, and drives the cell's traffic
for ``--seconds``. Then it holds what the window produced to the plain
reference and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``:
each number the comparison read beside its limit, also the last lines
of standard error. A run that finds no CUDA device, fewer than the cell
asks for, or a JAX module loaded, exits with another code than 0 and
prints no result.
"""

from __future__ import annotations

from isp_bench import clock

AT_START = clock.process_age_s()   # the interpreter's own start-up

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_CHECKOUT = Path(__file__).resolve().parent.parent
# every cache a library could write goes inside the checkout, at a fixed
# path, so only a checkout's first run fills it
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
  os.environ[_var] = str(_CHECKOUT / ".bench_cache" / _sub)

from isp_bench import (compare, harness, manifest, peaks,  # noqa: E402
                       program_tracer, reduce)
from isp_bench.reference import isp as ref  # noqa: E402

AT_IMPORTS = clock.process_age_s()   # and PyTorch's import, the port's not


def note(msg: str) -> None:
  print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str | None:
  try:
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout
  except (OSError, subprocess.SubprocessError):
    return None
  return out.strip().splitlines()[0] if out.strip() else None


def _read_metrics(m: dict, workload: str, run, trace: bool) -> dict:
  section, kind = (("per_layer", "layer_metrics") if trace
                   else ("end_to_end", "end_to_end"))
  out = {}
  for entry in manifest.metrics_of(m, section, workload):
    value = manifest.module(kind, entry["name"]).read(run)
    if value is not None:
      out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
      note(f"{entry['name']}: nothing to read in this run")
  return out


def _notes(run) -> None:
  """Numbers beside the metrics, for the record (standard error)."""
  lp = run.loop
  note(f"window {lp.window_s:.6f} s, sets attempted {lp.attempted}, "
       f"completed {lp.completed}, setup {run.setup_s:.3f} s")
  note("setup parts s: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in run.phases.items()))
  if len(lp.marks_s) >= 8:
    # sets a second over each eighth of the window, from the submissions
    marks, q = lp.marks_s, len(lp.marks_s) // 8
    rates = [harness.MARK_EVERY * q / (marks[(i + 1) * q - 1]
                                       - (marks[i * q - 1] if i else 0.0))
             for i in range(8)]
    note("sets/s by eighth of the window: "
         + ", ".join(f"{r:.3f}" for r in rates))
  for i, sl in enumerate(run.slices):
    kernels = sum(op.kind == reduce.KERNEL for op in sl.device)
    busy = reduce.busy(reduce.device_intervals(sl), sl.t0, sl.t1)
    note(f"slice {i}: {sl.sets} sets, {sl.launches} launches counted, "
         f"{kernels} kernels traced, device busy {busy / 1e3:.3f} of "
         f"{(sl.t1 - sl.t0) / 1e3:.3f} ms")
  for name, d in sorted(run.spans.durations.items()):
    note(f"span {name}: {len(d)} calls, mean {sum(d) / len(d) * 1e3:.4f} ms,"
         f" median {statistics.median(d) * 1e3:.4f} ms")


def _program_notes() -> None:
  """The program's own tracer over the sets it saw (the window's sets
  outside the profiler slices): each span's calls, and its ms and self ms
  a set (in all, for the set-up's ``isp.load``), each kernel's launcher ms
  a set, and tone-kernel launches a set by form."""
  snap = program_tracer.snapshot()
  if snap is None:
    note("program tracer: the program has none")
    return
  n = program_tracer.sets(snap)
  note(f"program tracer: {n} sets seen")
  for name, s in sorted(program_tracer.spans(snap).items()):
    k, per = ((1, "in all") if name == program_tracer.LOAD or not n
              else (n, "a set"))
    note(f"program span {name}: {s['calls']} calls, {s['ns'] / k / 1e6:.6f}"
         f" ms {per}, self {s['self_ns'] / k / 1e6:.6f} ms {per}")
  if not n:
    return
  for kernel, ns in sorted(snap.get("launch_ns", {}).items()):
    note(f"program launch_ns {kernel}: {ns / n / 1e6:.6f} ms a set")
  for form, count in sorted(snap.get("tone_forms", {}).items()):
    note(f"program tone_forms {form}: {count / n:.6f} a set")


def _kernel_notes(run) -> None:
  """Each kernel family's device time per launch in the slices against
  its own bound (logical bytes or operations, from ``work/``)."""
  color = run.traffic["color_format"]
  for fam, mod in manifest.modules("work").items():
    if not hasattr(mod, "SYMBOLS"):
      continue
    durs = [op.dur for sl in run.slices for op in sl.device
            if op.kind == reduce.KERNEL and op.label == fam]
    if not durs:
      continue
    ms = sum(durs) / len(durs) / 1e3
    nbytes, nops = mod.logical_bytes(run.cfg, color), mod.ops(run.cfg, color)
    bound = max(nbytes / peaks.HBM_BYTES_S, nops / peaks.F32_FLOPS) * 1e3
    by = "bytes" if nbytes / peaks.HBM_BYTES_S >= nops / peaks.F32_FLOPS \
        else "operations"
    note(f"kernel {fam}: {len(durs)} launches, {ms:.6f} ms a launch; bound "
         f"{bound:.6f} ms by {by} ({nbytes} bytes, {nops:.0f} f32 ops), "
         f"{100 * bound / ms:.2f}% of it")


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = p.parse_args(argv)

  m = manifest.load()
  w = manifest.workload(m, args.workload)
  cfg = manifest.config(m, w["config"])
  traffic = manifest.traffic(w["traffic"])
  limits = manifest.limits(w["name"])
  loop = manifest.module("loops", traffic["loop"])

  import torch
  if not torch.cuda.is_available():
    note("isp_bench: no CUDA device (torch.cuda.is_available() is False)")
    return 2
  if torch.cuda.device_count() < int(w["chips"]):
    note(f"isp_bench: the cell needs {w['chips']} CUDA devices, found "
         f"{torch.cuda.device_count()}")
    return 2
  device = torch.device("cuda", 0)
  trace = bool(args.trace)

  before = clock.process_age_s()
  run, ctx = harness.execute(cfg, traffic, args.seed, args.seconds, trace,
                             device, loop)
  run.phases = {"python": AT_START, "imports": AT_IMPORTS - AT_START,
                "cuda_probe": before - AT_IMPORTS, **run.phases}
  peak = torch.cuda.max_memory_allocated(device)
  metrics = _read_metrics(m, w["name"], run, trace)
  _notes(run)
  if trace:
    _kernel_notes(run)
    _program_notes()
  note(f"device memory peak {peak} bytes")

  final, kept = harness.free_program(ctx)
  pipe = ref.Pipeline(cfg, ctx.pool, compare.work_dtype(cfg))
  values = compare.readings(pipe, ctx.chain, kept, final,
                            traffic["color_format"])
  correct = compare.judge(values, limits) and run.loop.failed == 0

  device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                 "count": int(w["chips"]), "memory_peak_bytes": int(peak),
                 "power_limit": _power_limit()}
  result = {"correct": correct, "attempted": run.loop.attempted,
            "failed": run.loop.failed, "metrics": metrics,
            "device": device_info}
  if trace:
    slices = reduce.complete(run.slices) or run.slices
    busy, window = reduce.busy_window_s(slices)
    device_info.update(busy_s=busy, window_s=window)
    result["breakdown"] = {
        "device_ops": reduce.top(reduce.device_time_by_label(slices)),
        "idle_gaps": reduce.top(reduce.idle_by_span(slices))}
  result["compared"] = {k: {"value": values[k], "limit": limits[k]}
                        for k in limits}

  found = harness.forbidden_modules()
  if found:
    note(f"isp_bench: modules that must not load here are loaded: {found}")
    return 3
  for k in limits:
    note(f"compared {k}: {values[k]!r} limit {limits[k]!r}")
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
