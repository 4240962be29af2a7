"""The port's serving launcher against the JAX package's.

``python -m repro_torch.launch.serve`` and ``python -m repro.launch.serve``
run in this process on the same arguments, one app at one demand and a
short ``--trace`` run, and must print the same output except the host
time of the solve (``milp_ms``).  Both packages' ``Controller`` is
swapped for one whose planner budget binds by nodes (``bb_time_s=120``,
far above what a plan takes), so CPU load cannot change a plan.

The file also holds that the ast scan of the port's sources
(``tests/test_torch_models.py``) reaches ``gateway/`` and ``launch/``,
and that importing them loads neither ``jax`` nor ``repro``.
"""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import repro.core  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402

import repro_torch.core  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
NEW_SOURCES = ("gateway/__init__.py", "gateway/core.py", "gateway/loadgen.py",
               "gateway/server.py", "launch/serve.py")


def _binding(pkg):
    """``pkg.Controller`` with the planner's wall-clock budget raised to
    120 s, so its node budget binds."""
    base = pkg.Controller

    class Controller(base):
        def __init__(self, *args, planner_kwargs=None, **kw):
            kw["planner_kwargs"] = dict(planner_kwargs or {},
                                        bb_time_s=120.0)
            super().__init__(*args, **kw)
    return Controller


def _run(monkeypatch, capsys, mod, pkg, argv) -> str:
    monkeypatch.setattr(pkg, "Controller", _binding(pkg))
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _one_demand(out: str):
    """The JSON document without ``milp_ms``, and the placement lines."""
    doc, _, rest = out.partition("\n}\n")
    d = json.loads(doc + "\n}")
    d.pop("milp_ms")
    return d, rest.splitlines()


@pytest.mark.parametrize("argv", [
    ("--app", "traffic_analysis", "--demand", "50", "--sim-seconds", "4"),
    ("--app", "social_media", "--demand", "30", "--s-avail", "64",
     "--features", "A+T", "--sim-seconds", "4"),
])
def test_serve_one_demand_matches_jax(monkeypatch, capsys, argv):
    want = _one_demand(_run(monkeypatch, capsys, jserve, repro.core, argv))
    got = _one_demand(_run(monkeypatch, capsys, pserve, repro_torch.core,
                           argv))
    assert got == want
    doc, placed = got
    assert doc["instances_placed"] > 0 and placed


def _without_milp(out: str) -> list:
    return [re.sub(r"  milp=\s*\d+ms", "", ln) for ln in out.splitlines()]


def test_serve_trace_matches_jax(monkeypatch, capsys):
    argv = ("--app", "social_media", "--s-avail", "64", "--trace",
            "--bins", "3", "--sim-seconds", "2", "--seed", "1")
    want = _run(monkeypatch, capsys, jserve, repro.core, argv)
    got = _run(monkeypatch, capsys, pserve, repro_torch.core, argv)
    assert "milp=" in got and len(got.splitlines()) == 4
    assert _without_milp(got) == _without_milp(want)


def _scanned() -> dict:
    """The files ``test_port_sources_import_neither_jax_nor_repro`` scans
    (every ``.py`` under ``src/repro_torch``), by path in the package."""
    pkg = os.path.join(ROOT, "src", "repro_torch")
    return {os.path.relpath(os.path.join(d, f), pkg).replace(os.sep, "/"):
            os.path.join(d, f)
            for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")}


def test_import_scan_covers_gateway_and_launch():
    scanned = _scanned()
    missing = [s for s in NEW_SOURCES if s not in scanned]
    assert not missing, missing
    bad = []
    for rel in NEW_SOURCES:
        with open(scanned[rel], encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if not node.level else []
            else:
                continue
            bad += [f"{rel}:{node.lineno}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    # launch/ stays a namespace package, as in the JAX package
    assert "launch/__init__.py" not in scanned


def test_gateway_and_launch_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.gateway, repro_torch.launch.serve\n"
        "import repro_torch.gateway.server, repro_torch.gateway.loadgen\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
