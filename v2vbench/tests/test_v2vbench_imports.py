"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared whole:
``anyv2v_torch`` begins with the letters of ``anyv2v_tpu``)."""

from __future__ import annotations

import ast
import os

from v2vbench.tests.helpers import BENCH, run_cell, tiny_copy

FORBIDDEN = {"jax", "jaxlib", "flax", "anyv2v_tpu"}


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                tops.add(arg.value.split(".")[0])
    return tops


def sources(folder: str):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        if os.path.basename(path) == "test_v2vbench_imports.py":
            continue
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        tops = imported_tops(path)
        assert "anyv2v_torch" not in tops and not tops & FORBIDDEN, path
        assert tops <= {"torch", "numpy", "math", "__future__"}, (path, tops)


def test_a_run_loads_no_jax(tmp_path):
    """The run itself refuses to print a result if ``sys.modules`` holds
    JAX or the JAX package once the window has closed."""
    root = tiny_copy(str(tmp_path))
    rc, result, err = run_cell(root, "i2vgen-tiny.invert2")
    assert rc == 0 and result is not None, err[-3000:]
