"""Shared set-up of the benchmark's CPU tests: the repository's ``src`` on
the path, and a scratch checkout holding the benchmark plus toy cells that
consist only of new files and new ``BENCHMARK.json`` entries.

Run: ``python -m pytest -q portbench/tests`` from the repository root.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# a dense model of the ``qwen2`` family (``portbench/arch/qwen2.py``); the
# toy app's two models are of it too
TOY_MODEL = {
    "name": "toy", "kind": "model", "source": "toy", "model_type": "qwen2",
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_hidden_layers": 2,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": False,
    "torch_dtype": "float32", "vocab_size": 512, "head_dim": 16,
    "attention_bias": True, "serving": {"max_batch": 4, "max_seq": 48}}
TOY_OFFLINE = {"kind": "offline", "prompt": {"median": 16, "sigma": 0.5,
                                             "min": 8, "max": 32},
               "pool": 16, "strata": 4, "new_tokens": 8}
TOY_POISSON = {"kind": "gateway_http", "rate": 3.0, "drain_s": 30.0,
               "trace_s": 1.0}
# fp32 on the CPU agrees with the fp32 reference to rounding; the fp8
# control reads ~0.1 at these sizes
TOY_LIMIT = 1e-3


def _toy_model(name: str, tied: bool, bias: bool, max_seq: int) -> dict:
    return dict(TOY_MODEL, name=name, tie_word_embeddings=tied,
                attention_bias=bias, serving_max_seq=max_seq)


def toy_app() -> dict:
    """A depth-2 app in the shape of the paper's ``traffic_analysis``: a
    ``detect`` task fanning out 1.5 and 2.0 to two attribute tasks, served
    by toy models under the port's arch names (its planner's cost model
    reads them)."""
    def task(arch, acc, seq, gen):
        return [{"name": arch, "arch": arch, "accuracy": acc, "quant": "bf16",
                 "seq_len": seq, "gen_len": gen}]
    return {
        "name": "toyapp", "kind": "app", "source": "toy",
        "app": "traffic_analysis",
        "tasks": {"detect": task("qwen2-7b", 0.902, 512, 16),
                  "vehicle_attrs": task("granite-3-2b", 0.871, 128, 8),
                  "person_attrs": task("granite-3-2b", 0.845, 128, 8)},
        "edges": [["detect", "vehicle_attrs"], ["detect", "person_attrs"]],
        "mult": [{"task": "detect", "variant": "qwen2-7b",
                  "next": "vehicle_attrs", "factor": 1.5},
                 {"task": "detect", "variant": "qwen2-7b",
                  "next": "person_attrs", "factor": 2.0}],
        "slo_latency_ms": 1300.0, "slo_accuracy": 0.9,
        "path_fractions": {"detect>vehicle_attrs": 0.5,
                           "detect>person_attrs": 0.5},
        "engine": {"max_batch": 8},
        "planner": {"batches": [1, 2, 4, 8], "max_tuples_per_task": 32,
                    "bb_nodes": 8, "bb_time_s": 120.0},
        "models": {"qwen2-7b": _toy_model("qwen2-7b", False, True, 544),
                   "granite-3-2b": _toy_model("granite-3-2b", True, False,
                                              144)}}


# the gateway cell's metrics: no cell of BENCHMARK.json serves a compound
# app yet, so the toy cell brings its own entries
TOY_POISSON_E2E = [
    {"name": "e2e_p90_ms", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock"},
    {"name": "slo_attainment_pct", "unit": "%", "better": "higher",
     "bound": 0.25, "source": "host_clock"}]
TOY_POISSON_LAYERS = ["gateway.loop_blocked_pct", "dispatch.queue_wait_p90_ms",
                      "engine.service_ms.compound", "mfu.compound",
                      "device.idle_pct.compound"]


def make_root(tmp: Path) -> Path:
    """A checkout with the repository's benchmark and two toy cells added
    as new files and new entries only: ``toy.offline`` and
    ``toy.poisson``."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    (pb / "configs/toy.json").write_text(json.dumps(TOY_MODEL))
    (pb / "configs/toyapp.json").write_text(json.dumps(toy_app()))
    (pb / "traffic/toy-offline.json").write_text(json.dumps(TOY_OFFLINE))
    (pb / "traffic/toy-poisson.json").write_text(json.dumps(TOY_POISSON))
    (pb / "limits/toy.offline.json").write_text(
        json.dumps({"logit_gap": TOY_LIMIT}))
    (pb / "limits/toy.poisson.json").write_text(json.dumps(
        {"logit_gap.qwen2-7b": TOY_LIMIT, "logit_gap.granite-3-2b": TOY_LIMIT}))
    spec["configs"] += [
        {"name": "toy", "source": "toy", "file": "portbench/configs/toy.json",
         "reduced": [], "why": "toy"},
        {"name": "toyapp", "source": "toy",
         "file": "portbench/configs/toyapp.json", "reduced": [], "why": "toy"}]
    spec["workloads"] += [
        {"name": "toy.offline", "config": "toy", "traffic": "toy-offline",
         "chips": 1, "why": "toy"},
        {"name": "toy.poisson", "config": "toyapp", "traffic": "toy-poisson",
         "chips": 1, "why": "toy"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        ws = m.get("workloads")
        if ws is not None and "qwen2-7b.decode-heavy" in ws:
            ws.append("toy.offline")
    spec["end_to_end"] += [dict(m, workloads=["toy.poisson"])
                           for m in TOY_POISSON_E2E]
    spec["per_layer"] += [{"name": n, "unit": "x", "better": "lower",
                           "source": "program_span", "layer": "toy",
                           "moves": "e2e_p90_ms", "workloads": ["toy.poisson"]}
                          for n in TOY_POISSON_LAYERS]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def toy_root(tmp_path) -> Path:
    return make_root(tmp_path)


@pytest.fixture
def cuda():
    """The card, for tests marked ``gpu``; skips where there is none
    (decided here, never while a module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def qwen2():
    """The ``qwen2`` family file of the repository's benchmark."""
    from portbench import harness
    return harness.family(REPO, "qwen2")


def run_cell(root: Path, cell: str, seed: int = 7, seconds: float = 1.0,
             trace: bool = False, device: str = "cpu", control: bool = False):
    """One run of a cell without the look for a chip: (run, result)."""
    import time
    from portbench import harness
    run = harness.prepare(root, cell, seed, seconds, trace, device,
                          time.perf_counter())
    run.control = control
    harness.execute(run)
    spec = harness.load_spec(root)
    out = harness.result(run, spec, {"platform": device, "kind": device,
                                     "count": 1})
    return run, out
