"""The port's twins of ``examples/`` (``torch_quickstart.py``,
``torch_compound_serving.py``, ``torch_train_small.py``), each run with
``--device cpu`` in a subprocess: they import only ``repro_torch`` and
print the reference examples' key lines."""
import ast
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = ("torch_quickstart.py", "torch_compound_serving.py",
            "torch_train_small.py")


def _run(name: str, *argv: str, tmp_path) -> str:
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "2"}
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), *argv],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("name", EXAMPLES)
def test_twin_imports_only_the_port(name):
    with open(os.path.join(ROOT, "examples", name)) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "repro_torch" in mods
    assert not mods & {"repro", "jax", "jaxlib"}, mods


def test_torch_quickstart(tmp_path):
    out = _run("torch_quickstart.py", "--device", "cpu", tmp_path=tmp_path)
    assert "registered 'traffic_analysis'" in out
    assert re.search(r"configuration \(\d+ chips\):", out)
    assert re.search(r"served 12s @ 60rps: \d+ completions", out)
    assert "with mid-run failure:" in out
    assert re.search(r"engine on cpu: \S+-reduced .* generated 4x8 tokens",
                     out)


def test_torch_compound_serving(tmp_path):
    out = _run("torch_compound_serving.py", "--device", "cpu",
               tmp_path=tmp_path)
    assert re.search(r"planned \d+ slices for 4 rps:", out)
    m = re.search(r"served (\d+) compound requests in .* on cpu", out)
    assert m and int(m.group(1)) > 0, out
    assert re.search(r"caption\s+gemma-2b\s+served \d+", out)


def test_torch_train_small(tmp_path):
    out = _run("torch_train_small.py", "--device", "cpu", "--steps", "8",
               tmp_path=tmp_path)
    assert "training mamba2-130m-reduced" in out and "on cpu" in out
    assert "checkpointed at step 5" in out
    assert "restarted from step 5" in out
    first = float(re.search(r"step   0  loss (\S+)", out).group(1))
    last = float(re.search(r"final loss (\S+)", out).group(1))
    assert last < first
    assert not [d for d in os.listdir(tmp_path)      # checkpoint removed
                if d.startswith("repro_torch_train_small_")]


def test_twins_default_to_the_card(tmp_path):
    """Without ``--device`` an example asks for CUDA: on a host without a
    card it raises rather than run on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "TMPDIR": str(tmp_path)}
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_train_small.py")],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
