"""On the card: a short run of a cell prints a correct result with its
metrics (traced, the program's own host time a set split into its
``driver_self_ms`` and ``launch_call_ms``), and each control at the cell's
own size is not correct."""

import json
import re
import subprocess
import sys

import pytest

from isp_bench import calibrate, compare, harness, manifest
from isp_bench.reference import isp as ref

M = manifest.load()


def _run(workload, trace):
  """(the result line, standard error) of a 2 s run."""
  out = subprocess.run(
      [sys.executable, "-m", "isp_bench.run", "--workload", workload,
       "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace",
       str(trace)], cwd=manifest.CHECKOUT, capture_output=True, text=True,
      timeout=900, check=True)
  return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct(card, trace):
  w = "rig6x4k_f16.device"
  result, err = _run(w, trace)
  assert result["correct"] and result["failed"] == 0
  assert result["device"]["platform"] == "gpu"
  section = "per_layer" if trace else "end_to_end"
  want = {e["name"] for e in manifest.metrics_of(M, section, w)}
  assert set(result["metrics"]) == want
  if trace:
    metrics = result["metrics"]
    assert 0 < metrics["kernels_roofline"]["value"] <= 100
    # the program's isp.process ms a set, from the notes on standard error
    process_ms = float(re.search(
        r"^program span isp\.process: \d+ calls, ([0-9.]+) ms a set", err,
        re.M).group(1))
    parts = [metrics[k]["value"] for k in ("driver_self_ms",
                                           "launch_call_ms")]
    assert all(isinstance(v, float) and v > 0 for v in parts)
    assert sum(parts) == pytest.approx(process_ms, rel=0.01)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_the_controls_are_not_correct_at_the_cells_size(card, workload):
  w = manifest.workload(M, workload)
  cfg = manifest.config(M, w["config"])
  traffic = manifest.traffic(w["traffic"])
  loop = manifest.module("loops", traffic["loop"])
  seed, seconds = 2 ** 31 + 103, 1.0
  _, ctx = harness.execute(cfg, traffic, seed, seconds, False, card, loop)
  final, kept = harness.free_program(ctx)
  pipe = ref.Pipeline(cfg, ctx.pool, compare.work_dtype(cfg))
  limits = manifest.limits(workload)
  assert compare.judge(compare.readings(pipe, ctx.chain, kept, final,
                                        traffic["color_format"]), limits)
  for kind, what in compare.controls(cfg):
    values = calibrate.control_values(kind, what, cfg, traffic, loop, seed,
                                      seconds, card, pipe, ctx.pool,
                                      ctx.chain, sorted(kept))
    assert not compare.judge(values, limits), (kind, what, values)
