"""The port's serving launcher against the JAX package's.

``python -m repro_torch.launch.serve`` and ``python -m repro.launch.serve``
run in this process on the same arguments, one app at one demand and a
short ``--trace`` run, and must print the same output except the host
time of the solve (``milp_ms``).  Both packages' ``Controller`` is
swapped for one whose planner budget binds by nodes (``bb_time_s=120``,
far above what a plan takes), so CPU load cannot change a plan.

The file also holds that the ast scan of the port's sources
(``tests/test_torch_models.py``) reaches ``gateway/``, ``launch/`` and
``training/``, and that importing them loads neither ``jax`` nor
``repro``.  ``python -m repro_torch.launch.train`` runs here on the CPU
(``--device cpu``): the reference's printed lines, a resumed run, and the
refusals (more than one device; no card under the default ``--device``).
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
               "gateway/server.py", "launch/serve.py", "launch/train.py",
               "training/__init__.py", "training/data.py",
               "training/optimizer.py", "training/compression.py",
               "training/train_step.py", "training/checkpoint.py")


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
        "import repro_torch.launch.train, repro_torch.training.train_step\n"
        "import repro_torch.training.checkpoint\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# python -m repro_torch.launch.train
# The reference's line: f"step {step:5d}  loss {loss:7.4f}  gnorm
# {gnorm:8.3f}  lr {lr:.2e}  {dt:6.1f}s" (src/repro/launch/train.py:86-89)
STEP_LINE = re.compile(r"step [ \d]{5}  loss [ \d.-]{7}  gnorm [ \d.]{8}  "
                       r"lr \d\.\d\de[-+]\d\d  [ \d.]{6}s")


def _train(*argv, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv], env=env,
        capture_output=True, text=True, timeout=timeout)


def test_train_launcher_on_the_cpu_prints_the_reference_lines(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    common = ("--arch", "mamba2-130m", "--reduced", "--device", "cpu",
              "--ckpt-dir", ckpt_dir, "--log-every", "1")
    first = _train(*common, "--steps", "4")
    assert first.returncode == 0, first.stderr
    lines = first.stdout.splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2", "3"]
    assert all(STEP_LINE.fullmatch(ln) for ln in lines[:-1]), lines
    assert lines[-1] == "done."
    assert open(os.path.join(ckpt_dir, "LATEST")).read() == "step_00000004"
    # --resume picks up at the saved step, with the state it saved
    again = _train(*common, "--steps", "6", "--resume")
    assert again.returncode == 0, again.stderr
    lines = again.stdout.splitlines()
    assert lines[0] == "resumed from step 4"
    assert [ln.split()[1] for ln in lines[1:-1]] == ["4", "5"]
    assert all(STEP_LINE.fullmatch(ln) for ln in lines[1:-1])
    assert open(os.path.join(ckpt_dir, "LATEST")).read() == "step_00000006"


def test_train_launcher_refuses_more_than_one_device_and_no_card():
    many = _train("--arch", "gemma-2b", "--reduced", "--device", "cpu",
                  "--steps", "2", "--model-parallel", "2")
    assert many.returncode != 0
    assert "sharding slice" in many.stderr
    if not _has_card():
        none = _train("--arch", "gemma-2b", "--reduced", "--steps", "2")
        assert none.returncode != 0
        assert "no CUDA device" in none.stderr


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()


@pytest.fixture
def cpu_train_phase(monkeypatch):
    """``chip_smoke.phase_train`` on the CPU: every arch it names reduced,
    CUDA devices resolved to the CPU, the card's memory calls stubbed, and
    tensors taken for CUDA ones by the kernel wrappers (so the refusal is
    exercised)."""
    import torch

    import chip_smoke
    import repro_torch.configs as configs
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_mod
    full = configs.get_arch
    monkeypatch.setattr(configs, "get_arch", lambda n: full(n).reduced())
    monkeypatch.setattr(model_mod, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield lambda: chip_smoke.phase_train(torch, {"nvidia_smi": "cpu"}, 0)
    torch.set_num_threads(n)


def test_chip_smoke_train_phase_rehearsal(cpu_train_phase, capsys,
                                          monkeypatch):
    """The train phase passes on reduced CPU models, and fails when the
    kernel wrappers accept autograd or a restore loads nothing."""
    from repro_torch.kernels import ops
    cpu_train_phase()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    by = {d["phase"]: d for d in lines}
    assert set(by) == {"train_checks", "train", "train_restart",
                       "train_phase"}
    assert "no backward" in by["train_checks"]["kernel_refusal"]
    assert by["train"]["optimizer_step"] == 12
    assert by["train"]["kernel_launches"] == dict.fromkeys(
        ("flash_attention", "decode_attention", "ssd_scan", "quant_matmul"),
        0)
    assert by["train_restart"]["resumed_from"] == 3
    assert by["train_restart"]["abs_diff"] == 0.0
    monkeypatch.setattr(ops, "_kernel_path", lambda name, *t: False)
    with pytest.raises(AssertionError, match="did not refuse"):
        cpu_train_phase()
    monkeypatch.undo()


def test_chip_smoke_train_phase_catches_a_lost_restore(cpu_train_phase,
                                                       monkeypatch):
    from repro_torch.training import train_step
    monkeypatch.setattr(train_step, "load_state_tree",
                        lambda model, state, tree: state)
    with pytest.raises(AssertionError, match="restart"):
        cpu_train_phase()


# ---------------------------------------------------------------------------
# the sharding substrate: the launcher on a mesh, the import scan
SHARDING_SOURCES = ("sharding/policy.py", "launch/mesh.py",
                    "training/elastic.py")


@pytest.mark.parametrize("rel", SHARDING_SOURCES)
def test_import_scan_covers_the_sharding_substrate(rel):
    scanned = _scanned()
    assert rel in scanned
    with open(scanned[rel], encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=rel)
    bad = []
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


def test_sharding_substrate_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.sharding.policy, repro_torch.launch.mesh\n"
        "import repro_torch.training.elastic, repro_torch.launch.train\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_ranks(n: int, *argv, timeout=120):
    """``python -m repro_torch.launch.train`` as ``n`` ranks of one gloo
    group, torchrun's environment set by hand (a free port on 127.0.0.1)
    -> each rank's finished process."""
    port = str(_free_port())
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_train_launcher_on_two_gloo_ranks_prints_the_reference_lines(
        tmp_path):
    """--model-parallel 2 on two ranks: a (1, 2) mesh, the training
    policy, rank 0 alone prints, and the losses are the one-device run's
    (printed to 4 decimals); a checkpoint it writes resumes."""
    common = ("--arch", "granite-3-2b", "--reduced", "--device", "cpu",
              "--seq-len", "32", "--global-batch", "4", "--log-every", "1")
    ckpt_dir = str(tmp_path / "ckpt")
    ranks = _train_ranks(2, *common, "--model-parallel", "2", "--steps", "3",
                         "--ckpt-dir", ckpt_dir)
    for rc, _, err in ranks:
        assert rc == 0, err
    lines = ranks[0][1].splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2"]
    assert all(STEP_LINE.fullmatch(ln) for ln in lines[:-1]), lines
    assert lines[-1] == "done."
    assert ranks[1][1] == ""
    one = _train(*common, "--steps", "3")
    assert one.returncode == 0, one.stderr
    loss = [ln.split()[3] for ln in one.stdout.splitlines()[:-1]]
    assert [ln.split()[3] for ln in lines[:-1]] == loss
    assert open(os.path.join(ckpt_dir, "LATEST")).read() == "step_00000003"
    again = _train_ranks(2, *common, "--model-parallel", "2", "--steps", "4",
                         "--ckpt-dir", ckpt_dir, "--resume")
    for rc, _, err in again:
        assert rc == 0, err
    lines = again[0][1].splitlines()
    assert lines[0] == "resumed from step 3"
    assert [ln.split()[1] for ln in lines[1:-1]] == ["3"]


def test_train_launcher_compresses_int8_on_two_gloo_ranks():
    """--model-parallel 2 --grad-compression int8 on two ranks: int8 error
    feedback under the mesh prints the reference's lines, with the
    one-device int8 run's losses (to 4 decimals)."""
    common = ("--arch", "granite-3-2b", "--reduced", "--device", "cpu",
              "--seq-len", "32", "--global-batch", "4", "--log-every", "1",
              "--grad-compression", "int8", "--steps", "3")
    ranks = _train_ranks(2, *common, "--model-parallel", "2")
    for rc, _, err in ranks:
        assert rc == 0, err
    lines = ranks[0][1].splitlines()
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1", "2"]
    assert all(STEP_LINE.fullmatch(ln) for ln in lines[:-1]), lines
    assert lines[-1] == "done."
    assert ranks[1][1] == ""
    one = _train(*common)
    assert one.returncode == 0, one.stderr
    loss = [ln.split()[3] for ln in one.stdout.splitlines()[:-1]]
    assert [ln.split()[3] for ln in lines[:-1]] == loss


def test_train_launcher_builds_no_mesh_on_one_device():
    import torch.distributed as dist

    from repro_torch.launch import train as ptrain
    args = ptrain.parse_args(["--arch", "granite-3-2b", "--reduced",
                              "--device", "cpu", "--steps", "1"])
    model = ptrain.setup(args)[0]
    assert model.policy.mesh is None and not model.sharded
    assert not dist.is_initialized()
