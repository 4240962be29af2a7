"""Whole runs of toy cells on the CPU: a cell made of new files only, the
result line, the metrics each run reports, and the faults that must make
``correct`` false."""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.tests.conftest import REPO, make_root, run_cell


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


# a second model family as a new file only: the ``qwen2`` family's
# functions re-exported, each call counted
TOYFAM = '''"""The toy family: the qwen2 family's functions, each call counted."""
import collections
from pathlib import Path

from portbench import harness

_dense = harness.family(Path(__file__).resolve().parents[2], "qwen2")
CALLS = collections.Counter()


def _counted(name):
    inner = getattr(_dense, name)

    def counted(*args, **kwargs):
        CALLS[name] += 1
        return inner(*args, **kwargs)
    return counted


build, layout, logits, sequence_flops, kernel_work = (
    _counted(n) for n in harness.FAMILY_API)
'''


def _add_family_cell(root: Path) -> None:
    """``toyfam.offline``: the toy model under ``model_type`` ``toyfam``,
    as ``portbench/arch/toyfam.py``, a configuration, a limits file and
    new entries in ``BENCHMARK.json``."""
    pb = root / "portbench"
    (pb / "arch/toyfam.py").write_text(TOYFAM)
    cfg = json.loads((pb / "configs/toy.json").read_text())
    cfg.update(name="toyfam", model_type="toyfam")
    (pb / "configs/toyfam.json").write_text(json.dumps(cfg))
    (pb / "limits/toyfam.offline.json").write_text(
        (pb / "limits/toy.offline.json").read_text())
    spec = harness.load_spec(root)
    spec["configs"].append({"name": "toyfam", "source": "toy",
                            "file": "portbench/configs/toyfam.json",
                            "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "toyfam.offline", "config": "toyfam",
                              "traffic": "toy-offline", "chips": 1,
                              "why": "toy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "toy.offline" in m.get("workloads", ()):
            m["workloads"].append("toyfam.offline")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_new_cell_of_new_files_runs_without_editing_any(tmp_path):
    """``toy.offline``, ``toy.poisson`` and ``toyfam.offline`` (a model
    family of its own) are only new files and new entries: each runs, the
    new family's file is the one that builds, counts and judges its model,
    and no file the benchmark already had changes."""
    before = _digest(REPO / "portbench")
    root = make_root(tmp_path)
    _add_family_cell(root)
    shipped = {k: v for k, v in _digest(root / "portbench").items()
               if k in before}
    assert shipped == {k: before[k] for k in shipped}
    for cell, seconds in (("toy.offline", 1.5), ("toy.poisson", 3.0)):
        run, out = run_cell(root, cell, seed=2 ** 31 + 3, seconds=seconds)
        assert out["correct"], (run.errors, out["checks"])
        assert run.attempted > 0
        assert set(run.families) == {"qwen2"}
    run, out = run_cell(root, "toyfam.offline", seed=2 ** 31 + 3,
                        seconds=1.5, trace=True)
    assert out["correct"], (run.errors, out["checks"])
    assert set(run.families) == {"toyfam"}
    calls = run.families["toyfam"].CALLS
    # one model built, its layout read for the reference's weights, every
    # request of every batch counted, the traced batch's kernel work, and
    # the reference run once over the sample
    assert calls["build"] == 1 and calls["layout"] == 1
    assert calls["sequence_flops"] == sum(b["B"] for b in run.batches)
    assert calls["kernel_work"] == 1 and calls["logits"] == 1
    assert run.traced_work["decode"]
    assert {k: v for k, v in _digest(root / "portbench").items()
            if k in shipped} == shipped


def test_an_unknown_model_type_names_the_file_it_looked_for(toy_root):
    path = toy_root / "portbench/configs/toy.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    model_type="nosuch")))
    with pytest.raises(FileNotFoundError, match=r"portbench/arch/nosuch\.py"):
        run_cell(toy_root, "toy.offline", seconds=0.5)
    with pytest.raises(ValueError, match="model_type"):
        harness.family(toy_root, "../qwen2")


def test_result_line_keys_and_checks_last(toy_root):
    run, out = run_cell(toy_root, "toy.offline", seconds=0.5)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"requests_per_s", "setup_s"}
    assert out["checks"]["logit_gap"]["limit"] == 1e-3
    json.dumps(out)


def test_traced_run_reports_the_cell_s_per_layer_metrics(toy_root):
    run, out = run_cell(toy_root, "toy.offline", seconds=0.5, trace=True)
    # the CPU has no device trace, kernel times or peak: those readers
    # return nothing rather than 0
    assert set(out["metrics"]) == {"batcher.pad_pct", "engine.prefill_ms",
                                   "engine.decode_step_ms"}
    assert "breakdown" in out and out["device"]["busy_s"] == 0.0
    run, out = run_cell(toy_root, "toy.poisson", seconds=1.5, trace=True)
    assert {"gateway.loop_blocked_pct", "dispatch.queue_wait_p90_ms",
            "engine.service_ms.compound"} <= set(out["metrics"])


def test_metric_entries_follow_workloads_and_moves(toy_root):
    spec = harness.load_spec(toy_root)
    dh = {m["name"] for m in harness.metric_entries(
        spec, "qwen2-7b.decode-heavy", False)}
    assert dh == {"requests_per_s", "peak_mem_gib", "setup_s"}
    ta = {m["name"] for m in harness.metric_entries(
        spec, "toy.poisson", True)}
    assert "gateway.loop_blocked_pct" in ta and "batcher.pad_pct" not in ta
    spec["per_layer"].append({"name": "x", "moves": "e2e_p90_ms"})
    assert "x" in {m["name"] for m in harness.metric_entries(
        spec, "toy.poisson", True)}
    assert "x" not in {m["name"] for m in harness.metric_entries(
        spec, "qwen2-7b.decode-heavy", True)}


def test_e2e_p90_counts_every_root_sent():
    """A root that did not come back ``ok`` counts as infinitely late: more
    drops never read as a shorter tail, and where misses reach the
    percentile there is no reading."""
    read = harness.reader(REPO, "e2e_p90_ms")

    class R:
        requests = [{"outcome": "ok", "latency_ms": float(i)}
                    for i in range(1, 19)]
    R.requests += [{"outcome": "dropped", "latency_ms": 5.0}] * 2
    assert read(R) == 18.0
    R.requests += [{"outcome": "refused", "latency_ms": 1.0}]
    assert read(R) is None


def test_percentile_is_nearest_rank():
    assert harness.percentile(range(1, 11), 90.0) == 9
    assert harness.percentile([5.0], 90.0) == 5.0
    assert harness.percentile([], 90.0) is None


# --- faults of the timed path: each must make ``correct`` false --------


def _alter_token(monkeypatch):
    from repro_torch.serving import engine as eng
    inner = eng.Engine.generate

    def generate(self, prompts, max_new=16, eos_id=None):
        out = inner(self, prompts, max_new, eos_id)
        out[:, -1] = (out[:, -1] + 1) % self.model.arch.vocab_size
        return out
    monkeypatch.setattr(eng.Engine, "generate", generate)


def _half_batch(monkeypatch):
    """Half of each batch left out: its rows come back as the first row's
    tokens instead of their own."""
    from repro_torch.serving import engine as eng
    inner = eng.Engine.generate

    def generate(self, prompts, max_new=16, eos_id=None):
        keep = max(len(prompts) // 2, 1)
        out = inner(self, prompts[:keep], max_new, eos_id)
        return np.concatenate([out, np.repeat(out[:1], len(prompts) - keep,
                                              0)])
    monkeypatch.setattr(eng.Engine, "generate", generate)


def _state_unchanged(monkeypatch):
    """A decode step that leaves the KV cache as it was."""
    from repro_torch.models import transformer as tfm
    inner = tfm.decode_qkv

    def decode_qkv(h, p, arch, k_cache, v_cache, pos, index, policy=None):
        return inner(h, p, arch, k_cache.clone(), v_cache.clone(), pos,
                     index, policy)
    monkeypatch.setattr(tfm, "decode_qkv", decode_qkv)


def _fan_out(monkeypatch):
    """Each detection fans out one hop too many."""
    from repro_torch.core import taskgraph
    inner = taskgraph.TaskGraph.factor
    monkeypatch.setattr(taskgraph.TaskGraph, "factor",
                        lambda self, *a: inner(self, *a) + 1.0)


@pytest.mark.parametrize("cell,fault", [
    ("toy.offline", _alter_token), ("toy.offline", _half_batch),
    ("toy.offline", _state_unchanged), ("toy.poisson", _alter_token),
    ("toy.poisson", _state_unchanged), ("toy.poisson", _fan_out)])
def test_a_broken_timed_path_is_not_correct(toy_root, monkeypatch, cell,
                                            fault):
    fault(monkeypatch)
    run, out = run_cell(toy_root, cell, seed=11, seconds=1.5)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell,seconds", [("toy.offline", 0.5),
                                          ("toy.poisson", 1.5)])
def test_the_control_in_the_program_s_place_is_not_correct(toy_root, cell,
                                                           seconds):
    """The fp8 control, judged by the same limits in the program's place,
    makes ``correct`` false where the program's own tokens pass them."""
    run, out = run_cell(toy_root, cell, seconds=seconds, control=True)
    assert out["correct"] is False, out["checks"]
    assert not run.errors
    program = {k.partition(".")[2]: v for k, v in run.notes.items()
               if k.startswith("program.")}
    assert set(program) == set(out["checks"])
    for name, c in out["checks"].items():
        assert program[name] <= c["limit"] < c["value"]


CARD_TOY = {"hidden_size": 256, "intermediate_size": 512, "head_dim": 64,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "torch_dtype": "bfloat16"}
# the offline toy on the card generates 32 tokens a request (room for them
# in its cache), so its sample of 4 requests judges 128 tokens: at 8 tokens
# (32 judged) the control's widest gap read 0.150-0.641 over eight seeds and
# is, at that count, a draw of too few near-ties to sit safely above a limit
CARD_OFFLINE = {"new_tokens": 32}
CARD_MAX_SEQ = 96
# the offline toy on an H100 at 32 tokens, eight seeds: the program's widest
# gap 0-0.0365, the fp8 control's 0.337-0.524; the limit sits 2.7x above the
# one and 3.4x below the other
CARD_LIMIT = 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("cell,cfg_file", [("toy.offline", "toy.json"),
                                           ("toy.poisson", "toyapp.json")])
def test_toy_cells_on_the_card(toy_root, cuda, cell, cfg_file):
    """The toy cells at a head size the kernels take, in bf16, through the
    port's kernels and graphed decode: correct within a bf16 limit, and not
    correct with the fp8 control in the program's place."""
    path = toy_root / "portbench/configs" / cfg_file
    cfg = json.loads(path.read_text())
    for m in [cfg] + list(cfg.get("models", {}).values()):
        m.update(CARD_TOY)
    if "serving" in cfg:
        cfg["serving"]["max_seq"] = CARD_MAX_SEQ
        mix = toy_root / "portbench/traffic/toy-offline.json"
        mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                       **CARD_OFFLINE)))
    path.write_text(json.dumps(cfg))
    lim = toy_root / "portbench/limits" / f"{cell}.json"
    lim.write_text(json.dumps({k: CARD_LIMIT
                               for k in json.loads(lim.read_text())}))
    run, out = run_cell(toy_root, cell, seconds=1.5, device=cuda)
    print(out["checks"])
    assert out["correct"], (run.errors, out["checks"])
    run, out = run_cell(toy_root, cell, seconds=1.5, device=cuda,
                        control=True)
    print(out["checks"])
    assert out["correct"] is False, out["checks"]
    assert not run.errors


def test_run_refuses_without_a_card_and_prints_nothing():
    """Here (no card) the command exits non-zero with no result line."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "qwen2-7b.decode-heavy", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_in_a_folder_of_the_benchmark_alone(tmp_path):
    import shutil
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "qwen2-7b.decode-heavy", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
