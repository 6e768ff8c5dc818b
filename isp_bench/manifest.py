"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
cells and metrics. Everything that belongs to one of them is a file of
its own under this package, found by its name:

- ``configs/<config>.json`` (the path is the manifest's ``file``);
- ``traffic/<traffic>.json``, which names its loop kind;
- ``loops/<loop>.py``: ``warmup(ctx)`` and ``run(ctx)``;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``:
  ``read(run)``, a number or None;
- ``limits/<workload>.json``: the numbers that decide ``correct``;
- ``work/<kernel family>.py``: a kernel family's bytes and operations.

A later cell, mix, loop kind, metric or kernel family is a new file and
a new manifest entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

PACKAGE = Path(__file__).resolve().parent
CHECKOUT = PACKAGE.parent
MANIFEST = CHECKOUT / "BENCHMARK.json"

KINDS = ("loops", "end_to_end", "layer_metrics", "work")


def load(path: Path = MANIFEST) -> dict:
  with open(path) as f:
    return json.load(f)


def workload(manifest: dict, name: str) -> dict:
  for w in manifest["workloads"]:
    if w["name"] == name:
      return w
  known = ", ".join(w["name"] for w in manifest["workloads"])
  raise KeyError(f"no workload {name!r} in the manifest ({known})")


def config(manifest: dict, name: str, root: Path = CHECKOUT) -> dict:
  for c in manifest["configs"]:
    if c["name"] == name:
      with open(root / c["file"]) as f:
        return json.load(f)
  raise KeyError(f"no configuration {name!r} in the manifest")


def _json(kind: str, name: str, package: Path) -> dict:
  path = package / kind / f"{name}.json"
  if not path.is_file():
    raise FileNotFoundError(f"no {kind} file {path}")
  with open(path) as f:
    return json.load(f)


def traffic(name: str, package: Path = PACKAGE) -> dict:
  return _json("traffic", name, package)


def limits(workload_name: str, package: Path = PACKAGE) -> dict:
  return _json("limits", workload_name, package)


def module(kind: str, name: str, package: Path = PACKAGE) -> ModuleType:
  """The module ``<kind>/<name>.py`` (a name may hold dots)."""
  if kind not in KINDS:
    raise ValueError(f"unknown kind {kind!r}")
  path = package / kind / f"{name}.py"
  if not path.is_file():
    raise FileNotFoundError(f"no {kind} module {path}")
  spec = importlib.util.spec_from_file_location(
      f"isp_bench.{kind}.{name.replace('.', '__')}", path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def modules(kind: str, package: Path = PACKAGE) -> dict[str, ModuleType]:
  """Every module of ``kind``, by name."""
  return {p.stem: module(kind, p.stem, package)
          for p in sorted((package / kind).glob("*.py"))
          if p.name != "__init__.py"}


def metrics_of(manifest: dict, section: str, workload_name: str) -> list:
  """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
  the cell reports: those that list it, and those that list no cells."""
  return [m for m in manifest[section]
          if workload_name in m.get("workloads", [workload_name])]
