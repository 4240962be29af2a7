"""The serving engine's own spans (``repro_torch.obs.Tracer.span``) inside
``Batcher``, ``Engine`` and ``GraphedDecode``, and ``tools/serve_trace.py``,
which runs a benchmark cell with them on.

On the CPU: the span tree of a batch (parents, roots, counts), the token
marks, the collector's spans, the clock shared with ``torch.profiler``, an
engine without a tracer recording nothing and serving the same tokens, and
a toy cell of the benchmark read through the engine's spans (its padding
equal to the harness's count).  On a card (``gpu`` marker) the same tokens
with graphs and kernels, the readings of the toy cell, and a kernel that
starts on the device after the span it was launched in.
"""
import gc
import itertools
import json
import math
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.graphed import GraphedDecode  # noqa: E402
from repro_torch.obs import Tracer, validate_chrome_trace  # noqa: E402
from repro_torch.serving import (Batcher, Engine, EngineConfig,  # noqa: E402
                                 ServeRequest)

CPU_READINGS = ("engine.first_token_ms", "engine.token_gap_ms",
                "engine.token_gap_p99_ms", "host.gc_pause_ms",
                "host.offcpu_pct")
READINGS = CPU_READINGS + ("graphed.capture_s",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name="qwen2-7b", device="cpu", arch=None):
    m = Model(arch or ARCHS[name].reduced(), device=device,
              dtype=torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return m.init(gen)


def _prompts(B, S, seed=0, vocab=100):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, S)).astype(np.int32)


def _children(spans, i, name):
    return [s for s in spans if s.parent == i and s.name == name]


# -- the tracer --------------------------------------------------------
def test_span_nests_on_its_clock_with_parents_roots_and_args(tmp_path):
    ticks = itertools.count()
    tr = Tracer(clock=lambda: float(next(ticks)))
    with tr.span("a", "x", app="m", B=2) as a:
        with tr.span("b", "y") as b:
            b.args["n"] = 3
        with tr.span("c", "y", root_id=99):
            pass
        a.args["done"] = True
    with tr.span("d", "x"):
        pass
    a_, b_, c_, d_ = tr.spans
    assert (a_.parent, b_.parent, c_.parent, d_.parent) == (None, 0, 0, None)
    assert a_.root_id == b_.root_id != d_.root_id and c_.root_id == 99
    assert (b_.app, c_.app, d_.app) == ("m", "m", "")
    assert a_.args == {"B": 2, "done": True} and b_.args == {"n": 3}
    assert [(s.start_s, s.end_s) for s in tr.spans] == [
        (0.0, 5.0), (1.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    tr.export(str(tmp_path / "t.json"))
    events = validate_chrome_trace(json.loads((tmp_path / "t.json")
                                              .read_text()))
    assert [e["name"] for e in events] == ["a", "b", "c", "d"]
    assert events[1]["dur"] == 1e6 and events[0]["args"]["done"] is True


def test_span_past_max_events_is_dropped_and_still_closes():
    tr = Tracer(max_events=1)
    with tr.span("a", "x") as a:
        with tr.span("b", "x") as b:
            with tr.span("c", "x"):
                pass
        b.args["k"] = 1                  # a dropped span still takes args
    assert [s.name for s in tr.spans] == ["a"] and tr.dropped == 2
    assert a.end_s >= a.start_s and not tr._open
    with tr.span("d", "x"):
        pass
    assert tr.dropped == 3


def test_default_clock_is_wall_time():
    tr = Tracer()
    t0 = time.time()
    with tr.span("a", "x"):
        pass
    s = tr.spans[0]
    assert t0 - 1e-3 <= s.start_s <= s.end_s <= time.time() + 1e-3


def test_trace_gc_records_each_collection_until_close():
    tr = Tracer()
    was = gc.isenabled()
    gc.disable()                         # no collection but the test's
    try:
        tr.trace_gc()
        tr.trace_gc()                    # hooked once
        with tr.span("outer", "x", root_id=7):
            gc.collect()
        gc.collect(1)
        tr.close()
    finally:
        if was:
            gc.enable()
    gcs = [s for s in tr.spans if s.cat == "gc"]
    assert [s.args["generation"] for s in gcs] == [2, 1]
    assert gcs[0].parent == 0 and gcs[0].root_id == 7
    assert gcs[1].parent is None and gcs[1].root_id == -1
    assert all(s.end_s >= s.start_s and s.args["collected"] >= 0
               for s in gcs)
    n = len(tr.spans)
    gc.collect()
    assert len(tr.spans) == n and tr._on_gc not in gc.callbacks
    tr.close()                           # closing twice is harmless


def test_spans_share_the_profilers_clock():
    """Under ``torch.profiler`` a product run inside a span starts and ends,
    by kineto's timestamps, within the span's bounds."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256)
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(2e-3)
        with tr.span("mm", "x"):
            time.sleep(1e-3)
            x @ x
            time.sleep(1e-3)
        time.sleep(2e-3)
    s = tr.spans[0]
    mms = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(mms) == 1
    assert s.start_s * 1e9 <= mms[0].start_ns() <= mms[0].end_ns() \
        <= s.end_s * 1e9


# -- the engine ----------------------------------------------------------
@pytest.mark.parametrize("max_new", [1, 2, 6])
def test_generate_records_one_batch_tree(max_new):
    tr = Tracer()
    eng = Engine(_model(), EngineConfig(max_batch=4, max_seq=32), tracer=tr)
    want = Engine(eng.model, EngineConfig(max_batch=4, max_seq=32)).generate(
        _prompts(3, 9), max_new=max_new)
    got = eng.generate(_prompts(3, 9), max_new=max_new)
    np.testing.assert_array_equal(got, want)
    gens = [i for i, s in enumerate(tr.spans) if s.name == "engine.generate"]
    assert len(gens) == 1 and tr.spans[gens[0]].parent is None
    g, gi = tr.spans[gens[0]], gens[0]
    assert (g.args["B"], g.args["S"], g.args["max_new"]) == (3, 9, max_new)
    prefills = _children(tr.spans, gi, "engine.prefill")
    assert len(prefills) == 1 and prefills[0].args["head"] == "upcast"
    steps = _children(tr.spans, gi, "engine.decode_step")
    assert [s.args["step"] for s in steps] == list(range(max_new - 1))
    assert all(0.0 <= s.args["cpu_s"] for s in steps)
    assert len(_children(tr.spans, gi, "engine.to_host")) == 1
    assert {s.root_id for s in tr.spans} == {g.root_id}
    assert g.args["first_token_ms"] > 0
    assert len(g.args["token_gaps_ms"]) == max_new - 1
    assert all(x > 0 for x in g.args["token_gaps_ms"])
    assert tr.dropped == 0


def test_engine_without_a_tracer_records_nothing():
    m = _model()
    plain = Engine(m, EngineConfig(max_batch=4, max_seq=32))
    assert plain.tracer is None
    tr = Tracer()
    traced = Engine(m, EngineConfig(max_batch=4, max_seq=32), tracer=tr)
    for eos in (None, 3):
        want = plain.generate(_prompts(2, 7, 1), max_new=5, eos_id=eos)
        np.testing.assert_array_equal(
            traced.generate(_prompts(2, 7, 1), max_new=5, eos_id=eos), want)
    # the eos path copies each token and has no final copy
    gen = [s for s in tr.spans if s.name == "engine.generate"]
    assert len(gen) == 2 and len(gen[1].args["token_gaps_ms"]) <= 4
    before = len(tr.spans)
    plain.generate(_prompts(2, 7, 1), max_new=5)
    assert len(tr.spans) == before


def test_batcher_pump_span_counts_its_batch():
    tr = Tracer()
    eng = Engine(_model(), EngineConfig(max_batch=3, max_seq=32), tracer=tr)
    b = Batcher(eng, timeout_ms=0.0, max_new=3, clock=lambda: 5.0)
    rng = np.random.default_rng(0)
    lens = [4, 9, 6, 5]
    for i, n in enumerate(lens):
        b.submit(ServeRequest(i, rng.integers(0, 100, n).astype(np.int32),
                              1.0 if i == 1 else 10.0, 0.0))
    assert len(b.pump()) == 3
    pumps = [i for i, s in enumerate(tr.spans) if s.name == "batcher.pump"]
    assert len(pumps) == 1
    p = tr.spans[pumps[0]]
    assert p.args == {"B": 3, "S": 6, "prompt_tokens": 15, "pad_tokens": 3,
                      "dropped": 1}
    assert p.app == eng.model.arch.name and p.parent is None
    (gen,) = _children(tr.spans, pumps[0], "engine.generate")
    assert gen.root_id == p.root_id
    # pump, generate, prefill, two steps, the copy; an empty pump adds none
    assert b.pump() == [] and len(tr.spans) == 6


def test_graphed_decode_spans_each_step():
    m = _model()
    L = m.arch.num_layers
    tr = Tracer()
    dec, plain = (GraphedDecode(m, 3, 32, tracer=tr),
                  GraphedDecode(m, 3, 32))
    toks = torch.from_numpy(_prompts(2, 6)).long()
    for d in (dec, plain):
        m.prefill(toks, into=d.rows(2))
    with tr.span("step", "x"):
        got = dec.step(6, toks[:, -1:]).clone()
    want = plain.step(6, toks[:, -1:])
    assert torch.equal(got, want)
    names = [s.name for s in tr.spans]
    assert names == ["step", "graphed.inputs"] + ["decode_attention"] * L
    assert [s.args["layer"] for s in tr.spans[2:]] == list(range(L))
    assert all(s.parent == 0 for s in tr.spans[1:])
    # no graph is captured on the CPU, so no capture span
    assert not any(s.name == "graphed.capture" for s in tr.spans)


# -- a benchmark cell through the engine's spans ---------------------------
@pytest.fixture
def toy_root(tmp_path):
    from portbench.tests.conftest import make_root
    return make_root(tmp_path)


def test_toy_cell_reads_through_the_engines_spans(toy_root):
    """The toy offline cell of the benchmark's tests, run traced with the
    engine's tracer on: nothing dropped, every batch a ``batcher.pump``
    tree, the pump spans' padding equal to the harness's count, and the
    readings the CPU can give finite."""
    from tools.serve_trace import run_cell
    run, out, tr = run_cell(toy_root, "toy.offline", 2 ** 31 + 11, 0.5, True,
                            "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    prog = out["program"]
    assert prog["dropped"] == 0 == tr.dropped
    pumps = [s for s in tr.spans if s.name == "batcher.pump"]
    assert len(pumps) == len(run.batches) >= 2
    assert [p.args["B"] for p in pumps] == [b["B"] for b in run.batches]
    pad = sum(p.args["pad_tokens"] for p in pumps)
    pos = sum(p.args["B"] * p.args["S"] for p in pumps)
    assert math.isclose(100.0 * pad / pos,
                        out["metrics"]["batcher.pad_pct"]["value"],
                        rel_tol=1e-12)
    for name in CPU_READINGS:
        assert prog[name] is not None and math.isfinite(prog[name]), name
    assert prog["graphed.capture_s"] is None    # the CPU captures no graph
    assert len(prog["batches"]) == len(run.batches) - 1   # profiled left out
    new = json.loads((toy_root / "portbench/traffic/toy-offline.json")
                     .read_text())["new_tokens"]
    assert prog["n_gaps"] == (new - 1) * len(prog["batches"])
    # the warm-up batch (no pump) is its own root; collector spans only
    # after set-up
    gens = [s for s in tr.spans if s.name == "engine.generate"]
    assert len(gens) == len(run.batches) + 1 and gens[0].parent is None
    assert all(s.start_s > gens[0].end_s for s in tr.spans if s.cat == "gc")


# -- the card -------------------------------------------------------------
@pytest.mark.gpu
def test_tracing_on_the_card(toy_root):
    """Graphed decode through the kernels: the same tokens with tracing on
    and off, capture and step spans recorded, the six readings of the toy
    cell finite, and a kernel launched inside a span starting on the device
    after the span's start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from tools.serve_trace import run_cell
    m = _model(device="cuda",
               arch=dataclasses.replace(ARCHS["qwen2-7b"], num_layers=2))
    tr = Tracer()
    traced = Engine(m, EngineConfig(max_batch=4, max_seq=64), tracer=tr)
    plain = Engine(m, EngineConfig(max_batch=4, max_seq=64))
    p = _prompts(3, 17, 2, m.arch.vocab_size)
    np.testing.assert_array_equal(traced.generate(p, max_new=6),
                                  plain.generate(p, max_new=6))
    assert traced.decode_mode == "graphed"
    caps = [s for s in tr.spans if s.name == "graphed.capture"]
    # ``max_batch`` up front, then the batch's own size when it comes
    assert [s.args["B"] for s in caps] == [4, 3]
    assert sum(s.name == "decode_attention" for s in tr.spans) == 5 * 2
    gen = next(s for s in tr.spans if s.name == "engine.generate")
    assert len(gen.args["token_gaps_ms"]) == 5
    assert gen.args["first_token_ms"] > 0

    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    t2 = Tracer()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with t2.span("mm", "x"):
            y = x @ x
        torch.cuda.synchronize()
    del y
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation()]
    assert dev and min(e.start_ns() for e in dev) >= t2.spans[0].start_s * 1e9

    path = toy_root / "portbench/configs/toy.json"
    cfg = json.loads(path.read_text())
    cfg.update({"hidden_size": 256, "intermediate_size": 512,
                "head_dim": 64, "num_attention_heads": 4,
                "num_key_value_heads": 2, "torch_dtype": "bfloat16"})
    path.write_text(json.dumps(cfg))
    (toy_root / "portbench/limits/toy.offline.json").write_text(
        json.dumps({"logit_gap": 0.1}))
    run, out, tr = run_cell(toy_root, "toy.offline", 2 ** 31 + 13, 1.5, True,
                            "cuda", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["program"]["dropped"] == 0
    for name in READINGS:
        v = out["program"][name]
        assert v is not None and math.isfinite(v), name
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert set(gaps) & {"decode_attention", "graphed.inputs",
                        "engine.decode_step", "engine.generate"}, gaps


def test_hybrid_moe_layers_record_their_spans():
    """A tiny Granite-4.0-H (``hybrid_moe``) batch with a tracer: one
    ``ssm.scan`` a Mamba2 layer at prefill, one ``ssm.step`` a Mamba2 layer
    and step, one ``moe.experts`` a layer and call (its route and routed
    rows), each under the engine's span; without a tracer, the same
    tokens and no span."""
    import _granite_tiny as tiny
    m, _ = tiny.model_and_weights(5)
    tr = Tracer()
    traced = Engine(m, EngineConfig(max_batch=4, max_seq=32), tracer=tr)
    plain = Engine(m, EngineConfig(max_batch=4, max_seq=32))
    prompts = _prompts(2, 7, 2, vocab=512)
    out = traced.generate(prompts, max_new=4)
    L, K = m.arch.num_layers, m.arch.moe.experts_per_token
    mamba = [i for i, t in enumerate(m.arch.layer_types) if t == "mamba"]
    by = {n: [s for s in tr.spans if s.name == n]
          for n in ("ssm.scan", "ssm.step", "moe.experts")}
    assert [s.args["layer"] for s in by["ssm.scan"]] == mamba
    assert [s.args["layer"] for s in by["ssm.step"]] == mamba * 3
    moe_spans = by["moe.experts"]
    assert [s.args["layer"] for s in moe_spans] == list(range(L)) * 4
    assert {s.args["route"] for s in moe_spans} == {"dropless"}
    assert [s.args["rows"] for s in moe_spans] == [2 * 7 * K] * L + \
        [2 * K] * (3 * L)
    names = {s.parent and tr.spans[s.parent].name for s in
             by["ssm.scan"] + by["ssm.step"] + moe_spans}
    assert names == {"engine.prefill", "engine.decode_step"}
    before = len(tr.spans)
    np.testing.assert_array_equal(plain.generate(prompts, max_new=4), out)
    assert len(tr.spans) == before and m.tracer is None
