"""Nothing the benchmark runs imports JAX, Flax or the JAX package, and the
reference imports nothing of the program either.  Top-level module names
are compared whole: ``treedetection_tpu_torch`` is not ``treedetection_tpu``."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from harness import BENCH, FORBIDDEN, ROOT

PROGRAM = "treedetection_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(skip_tests=True):
    return [p for p in BENCH.rglob("*.py") if "_cache" not in p.parts
            and not (skip_tests and "tests" in p.parts)]


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources():
        found = set(_imports(path)) & set(FORBIDDEN)
        assert not found, f"{path}: {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & (set(FORBIDDEN) | {PROGRAM}), path
        # and only the standard library, numpy and torch
        assert tops <= {"__future__", "math", "typing", "numpy", "torch"}, \
            (path, tops)


def test_a_process_that_loads_every_module_holds_no_jax():
    mods = sorted({".".join(p.relative_to(BENCH).with_suffix("").parts)
                   for p in _sources() if p.name != "__init__.py"
                   and p.name not in ("run.py", "control.py")})
    probe = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
        import importlib, runpy
        for m in {mods!r}:
            importlib.import_module(m)
        runpy.run_path({str(BENCH / "run.py")!r}, run_name="not_main")
        import treedetection_tpu_torch.prediction, treedetection_tpu_torch.detection
        tops = {{m.split(".")[0] for m in sys.modules}}
        print(sorted(t for t in {FORBIDDEN!r} if t in tops))
    ''')
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "[]"


def test_the_reference_alone_loads_nothing_of_the_program():
    probe = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(BENCH)!r}]
        import reference.maskrcnn
        tops = {{m.split(".")[0] for m in sys.modules}}
        print(sorted(t for t in {(FORBIDDEN + (PROGRAM,))!r} if t in tops))
    ''')
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, cwd=BENCH)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
