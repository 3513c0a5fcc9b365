"""Nothing the benchmark runs imports JAX or the JAX package `tron_tpu`
(top-level names compared whole: `tron_tpu_torch` is the program), and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.tests.conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "tron_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _modules():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_module_imports_jax_or_the_jax_package():
    mods = _modules()
    assert len(mods) >= 15
    for p in mods:
        for name in _imports(p):
            assert name.split(".")[0] not in FORBIDDEN, (p, name)


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        for name in _imports(p):
            assert name.split(".")[0] != "tron_tpu_torch", (p, name)
            assert not name.startswith("benchmark.") or name.startswith("benchmark.reference"), \
                (p, name)


def test_a_run_loads_no_jax(tiny_root):
    """A whole CPU run in a fresh process leaves no forbidden module loaded."""
    code = (
        "import sys, torch; sys.path.insert(0, %r); from benchmark import run, spec; "
        "cell = spec.load_cell('tiny.adjoint', __import__('pathlib').Path(%r)); "
        "r = run.run_cell(cell, 3, 0.2, False, torch.device('cpu')); "
        "print(r['correct'], run.forbidden_modules())" % (str(BENCH.parent), str(tiny_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=BENCH.parent)
    assert out.stdout.split() == ["True", "[]"], out.stderr[-2000:]
