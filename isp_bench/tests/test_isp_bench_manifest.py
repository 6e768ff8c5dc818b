"""The manifest keeps to the benchmark's contract, and every file it names
is found by name, also one added later without an edit to another."""

import json
import re
import shutil

import pytest

from isp_bench import manifest

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
M = manifest.load()


def _line(s: str) -> bool:
  return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
  assert set(M) == {"command", "paths", "run_seconds", "configs",
                    "workloads", "end_to_end", "per_layer"}
  assert len(json.dumps(M)) <= 64 * 1024
  assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
  assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
  assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128


def test_command_and_paths():
  assert 1 <= len(M["command"]) <= 32
  assert all(_line(w) and not w.startswith("/") and ".." not in w
             for w in M["command"])
  assert 1 <= len(M["paths"]) <= 16
  for p in M["paths"]:
    assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert (manifest.CHECKOUT / p).is_dir()


def test_names_units_and_lines():
  names = []
  for section in ("configs", "workloads", "end_to_end", "per_layer"):
    for e in M[section]:
      assert NAME.match(e["name"]), e["name"]
      names.append((section, e["name"]))
  assert len(names) == len(set(names))
  for e in M["end_to_end"] + M["per_layer"]:
    assert UNIT.match(e["unit"]), e["unit"]
    assert e["better"] in ("lower", "higher")
  for e in M["configs"]:
    assert _line(e["source"]) and _line(e["why"])
    assert len(e["reduced"]) <= 16
    assert all(NAME.match(k) for k in e["reduced"])
  for e in M["workloads"]:
    assert _line(e["why"]) and e["chips"] in (1, 4)
    assert NAME.match(e["config"]) and NAME.match(e["traffic"])
  for e in M["per_layer"]:
    assert _line(e["layer"])


def test_entry_keys():
  keys = {"configs": {"name", "source", "file", "reduced", "why"},
          "workloads": {"name", "config", "traffic", "chips", "why"},
          "end_to_end": {"name", "unit", "better", "bound", "source"},
          "per_layer": {"name", "unit", "better", "source", "layer",
                        "moves"}}
  for section, want in keys.items():
    for e in M[section]:
      assert set(e) - {"workloads"} == want, e["name"]


def test_bounds_and_sources():
  for e in M["end_to_end"]:
    assert 0.01 <= e["bound"] <= 0.25
    assert e["source"] in ("host_clock", "device_trace")
  setup = [e for e in M["end_to_end"] if e["name"] == "setup_s"]
  assert len(setup) == 1 and "workloads" not in setup[0]
  for e in M["per_layer"]:
    assert e["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")


def test_every_cell_reports_enough():
  e2e = {e["name"] for e in M["end_to_end"]}
  cells = {w["name"] for w in M["workloads"]}
  for w in cells:
    reported = {e["name"] for e in manifest.metrics_of(M, "end_to_end", w)}
    assert "setup_s" in reported and len(reported) >= 2
    assert manifest.metrics_of(M, "per_layer", w)
  for e in M["per_layer"]:
    assert e["moves"] in e2e
    for w in e.get("workloads", cells):
      assert w in cells
      moved = {m["name"] for m in manifest.metrics_of(M, "end_to_end", w)}
      assert e["moves"] in moved, (e["name"], w)
  for e in M["end_to_end"]:
    assert set(e.get("workloads", cells)) <= cells


def test_configs_used_and_pairs_unique():
  used = {w["config"] for w in M["workloads"]}
  assert used == {c["name"] for c in M["configs"]}
  pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
  assert len(pairs) == len(set(pairs))
  files = [c["file"] for c in M["configs"]]
  assert len(files) == len(set(files))


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_every_cell_file_is_found(w):
  cfg = manifest.config(M, w["config"])
  assert cfg["name"] == w["config"]
  traffic = manifest.traffic(w["traffic"])
  loop = manifest.module("loops", traffic["loop"])
  assert callable(loop.warmup) and callable(loop.run)
  limits = manifest.limits(w["name"])
  assert limits and all(v >= 0 for v in limits.values())
  c = next(c for c in M["configs"] if c["name"] == w["config"])
  assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))


@pytest.mark.parametrize("section,kind", [("end_to_end", "end_to_end"),
                                          ("per_layer", "layer_metrics")])
def test_every_metric_module_is_found(section, kind):
  for e in M[section]:
    assert callable(manifest.module(kind, e["name"]).read)


def test_an_added_file_is_found_without_an_edit(tmp_path):
  pkg = tmp_path / "isp_bench"
  shutil.copytree(manifest.PACKAGE, pkg,
                  ignore=shutil.ignore_patterns("__pycache__"))
  before = {p.relative_to(pkg): p.read_bytes()
            for p in pkg.rglob("*") if p.is_file()}
  m = json.loads(json.dumps(M))
  cfg = json.loads((pkg / "configs" / "rig6x4k_f16.json").read_text())
  cfg["name"] = "rig2x1080p_f16"
  (pkg / "configs" / "rig2x1080p_f16.json").write_text(json.dumps(cfg))
  (pkg / "traffic" / "burst.json").write_text(json.dumps(
      dict(json.loads((pkg / "traffic" / "device.json").read_text()),
           loop="burst_loop")))
  (pkg / "loops" / "burst_loop.py").write_text(
      "def warmup(ctx):\n  pass\n\ndef run(ctx):\n  return 'burst'\n")
  (pkg / "layer_metrics" / "queue_depth.p50.py").write_text(
      "def read(run):\n  return 7.0\n")
  (pkg / "limits" / "rig2x1080p_f16.burst.json").write_text(
      json.dumps({"metrics_gap": 1.0}))
  (pkg / "work" / "sharpen.py").write_text(
      "SYMBOLS = ('sharpen_kernel',)\n")
  m["configs"].append({"name": "rig2x1080p_f16", "source": "x",
                       "file": "isp_bench/configs/rig2x1080p_f16.json",
                       "reduced": [], "why": "x"})
  m["workloads"].append({"name": "rig2x1080p_f16.burst",
                         "config": "rig2x1080p_f16", "traffic": "burst",
                         "chips": 1, "why": "x"})
  m["per_layer"].append({"name": "queue_depth.p50", "unit": "sets",
                         "better": "lower", "source": "program_counter",
                         "layer": "x", "moves": "frames_per_s",
                         "workloads": ["rig2x1080p_f16.burst"]})
  (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

  m2 = manifest.load(tmp_path / "BENCHMARK.json")
  w = manifest.workload(m2, "rig2x1080p_f16.burst")
  assert manifest.config(m2, w["config"], root=tmp_path)["name"] == \
      "rig2x1080p_f16"
  traffic = manifest.traffic(w["traffic"], package=pkg)
  assert manifest.module("loops", traffic["loop"], package=pkg).run(None) \
      == "burst"
  assert manifest.limits(w["name"], package=pkg) == {"metrics_gap": 1.0}
  names = [e["name"] for e in manifest.metrics_of(m2, "per_layer",
                                                  w["name"])]
  assert "queue_depth.p50" in names
  assert manifest.module("layer_metrics", "queue_depth.p50",
                         package=pkg).read(None) == 7.0
  assert manifest.modules("work", package=pkg)["sharpen"].SYMBOLS == (
      "sharpen_kernel",)
  after = {p.relative_to(pkg): p.read_bytes()
           for p in pkg.rglob("*") if p.is_file() and p.relative_to(pkg)
           in before}
  assert after == before
