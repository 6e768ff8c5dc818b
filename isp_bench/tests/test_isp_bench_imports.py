"""No module of the benchmark loads JAX or the JAX package, and the
reference, the trace slices' reader and the reader of the program's own
tracer import nothing of the program (``harness.py`` alone does). Top-level
import names are compared whole: the port's name begins with the JAX
package's."""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "taichi_image_tpu"}
PROGRAM = "taichi_image_tpu_torch"


def _imports(path: Path) -> set:
  tree = ast.parse(path.read_text(), str(path))
  names = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names.update(a.name.split(".", 1)[0] for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      names.add(node.module.split(".", 1)[0])
  return names


def _sources(sub=None):
  root = PACKAGE if sub is None else PACKAGE / sub
  return sorted(p for p in root.rglob("*.py")
                if "tests" not in p.relative_to(PACKAGE).parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(PACKAGE)))
def test_no_jax(path):
  assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference") + [
    PACKAGE / "trace.py", PACKAGE / "program_tracer.py"], ids=lambda p: str(
    p.relative_to(PACKAGE)))
def test_reference_imports_no_program(path):
  assert PROGRAM not in _imports(path)


def test_the_check_compares_whole_names(tmp_path):
  f = tmp_path / "m.py"
  f.write_text("import taichi_image_tpu_torch.ops\n"
               "from jaxlib import xla_client\nimport numpy as jax\n")
  assert _imports(f) == {"taichi_image_tpu_torch", "jaxlib", "numpy"}
