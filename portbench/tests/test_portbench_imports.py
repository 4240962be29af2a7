"""Nothing the benchmark loads is JAX or the JAX package: the top-level
name of every module (the part before the first dot) is compared whole,
since the port's name, ``repro_torch``, begins with the JAX package's."""
from __future__ import annotations

import ast
import subprocess
import sys
import types

from portbench import harness
from portbench.tests.conftest import REPO


def test_sources_import_neither_jax_nor_the_jax_package():
    found = []
    for path in sorted((REPO / "portbench").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            found += [(path.name, n) for n in names
                      if n.partition(".")[0] in harness.FORBIDDEN]
    assert found == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch.x", "reprox", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [n for n in harness.forbidden_modules()
                if n in ("repro_torch.x", "reprox", "jaxtyping")]
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in harness.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    """Both toy cells in a fresh process: after the window nothing of JAX
    or the JAX package is loaded."""
    script = f"""
import sys, time
sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]
from pathlib import Path
from portbench import harness
from portbench.tests.conftest import make_root
root = make_root(Path({str(tmp_path)!r}))
for cell in ("toy.offline", "toy.poisson"):
    run = harness.prepare(root, cell, 3, 1.0, True, "cpu", time.perf_counter())
    harness.execute(run)
print(harness.forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
