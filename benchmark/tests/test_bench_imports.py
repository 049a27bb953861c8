"""No file of the benchmark imports jax or the JAX package (top-level
module names compared whole: `cvsim_tpu_torch` is the program under
test), and the reference imports nothing of the program."""

import ast
import os
import sys

import pytest

from conftest import BENCH
from harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "cvsim_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    found = {p: sorted(set(_imports(p)) & FORBIDDEN)
             for p in _py_files(BENCH)}
    assert not {p: m for p, m in found.items() if m}


def test_reference_imports_nothing_of_the_program():
    found = {p: sorted(m for m in set(_imports(p))
                       if m.startswith("cvsim"))
             for p in _py_files(os.path.join(BENCH, "reference"))}
    assert not {p: m for p, m in found.items() if m}


def test_the_name_comparison_is_whole():
    import cvsim_tpu_torch.models.yiq  # noqa: F401  (the program)

    assert "cvsim_tpu" not in sys.modules
    assert core.forbidden_modules() == []


@pytest.mark.parametrize("name", ["jax", "cvsim_tpu.models"])
def test_a_held_module_is_named(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, sys)
    assert name.split(".")[0] in core.forbidden_modules()
