"""The port's serving datapath (``repro_torch.serving``, ``repro_torch.runtime``)
on the CPU: token-exact greedy generation against ``repro.serving.Engine``,
the batcher's semantics, and the port's backends inside the JAX package's
``ClusterRuntime``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.core.milp import PlanConfig, TupleVar  # noqa: E402
from repro.core.taskgraph import Task, TaskGraph, Variant  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.runtime import (ClusterRuntime, FailureEvent, Scenario,  # noqa: E402
                           SimMetrics)
from repro.runtime.backend import ExecutionBackend  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.sharding.policy import ShardingPolicy  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.runtime import EngineBackend, SimBackend  # noqa: E402
from repro_torch.serving import (Batcher, Engine, EngineConfig,  # noqa: E402
                                 ServeRequest)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread is enough, and keeps
    this file from crowding the tests that run beside it in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """Reduced granite in fp32: the JAX engine and the port's engine on the
    same weights."""
    jm = JaxModel(JAX_ARCHS["granite-3-2b"].reduced(),
                  ShardingPolicy(mesh=None), param_dtype=jnp.float32)
    params = jm.init(jax.random.key(0))
    arch = ARCHS["granite-3-2b"].reduced()
    m = Model(arch, device="cpu", dtype=torch.float32)
    m.load_state_dict(from_jax_params(arch, jax.tree.map(np.asarray, params)))
    cfg = dict(max_batch=4, max_seq=64)
    return (arch, JaxEngine(jm, params, JaxEngineConfig(**cfg)),
            Engine(m, EngineConfig(**cfg)))


def test_generate_token_exact_vs_jax(engines):
    arch, jeng, eng = engines
    prompts = np.random.default_rng(1).integers(
        0, arch.vocab_size, size=(3, 12)).astype(np.int32)
    want = jeng.generate(prompts, max_new=8)
    got = eng.generate(prompts, max_new=8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    assert np.array_equal(got, want)
    # with an eos id that the greedy stream hits, rows stop alike
    eos = int(want[0, 2])
    assert np.array_equal(eng.generate(prompts, max_new=8, eos_id=eos),
                          jeng.generate(prompts, max_new=8, eos_id=eos))


def test_generate_rejects_oversize_batches(engines):
    _, _, eng = engines
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate(np.zeros((5, 4), np.int32))
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(np.zeros((1, 64), np.int32))


def test_batcher_launches_on_full_batch(engines):
    _, _, eng = engines
    clock = [0.0]
    b = Batcher(eng, timeout_ms=1e9, max_new=3, clock=lambda: clock[0])
    for i in range(4):
        b.submit(ServeRequest(i, np.arange(5, dtype=np.int32) + i,
                              deadline_s=10.0, submitted_s=0.0))
    done = b.pump()
    assert len(done) == 4
    assert all(r.result is not None and r.result.shape == (3,)
               for r in done)


def test_batcher_timeout_partial_launch(engines):
    _, _, eng = engines
    clock = [0.0]
    b = Batcher(eng, timeout_ms=50.0, max_new=2, clock=lambda: clock[0])
    b.submit(ServeRequest(0, np.arange(4, dtype=np.int32),
                          deadline_s=10.0, submitted_s=0.0))
    assert b.pump() == []          # not full, not timed out
    clock[0] = 0.2                 # 200 ms later
    done = b.pump()
    assert len(done) == 1


def test_batcher_drops_past_deadline(engines):
    _, _, eng = engines
    clock = [5.0]
    b = Batcher(eng, timeout_ms=10.0, clock=lambda: clock[0])
    b.submit(ServeRequest(0, np.arange(4, dtype=np.int32),
                          deadline_s=1.0, submitted_s=0.0))
    assert b.pump() == []
    assert b.dropped == 1


def test_batcher_left_pads_like_reference(engines):
    """Ragged prompts are left-padded with token 0 and no mask: a batch's
    results equal the engine run on the padded array."""
    _, _, eng = engines
    clock = [0.0]
    b = Batcher(eng, timeout_ms=50.0, max_new=4, clock=lambda: clock[0])
    prompts = [np.arange(3, dtype=np.int32) + 7,
               np.arange(6, dtype=np.int32) + 1]
    for i, p in enumerate(prompts):
        b.submit(ServeRequest(i, p, deadline_s=10.0, submitted_s=0.0))
    clock[0] = 0.2                 # past the batch-formation timeout
    done = b.pump()
    padded = np.zeros((2, 6), np.int32)
    padded[0, 3:] = prompts[0]
    padded[1] = prompts[1]
    want = eng.generate(padded, max_new=4)
    assert np.array_equal(np.stack([r.result for r in done]), want)


@pytest.fixture(scope="module")
def tiny():
    """One-task graph + hand-built PlanConfig (as tests/test_runtime.py)."""
    g = TaskGraph(
        name="tiny",
        tasks={"gen": Task("gen", (
            Variant("gemma-2b", "gemma-2b", accuracy=0.8,
                    seq_len=16, gen_len=4),))},
        edges=[], slo_latency_ms=4000.0)
    key = ("gen", "gemma-2b", "1x1s1", 4)
    tup = TupleVar("gen", "gemma-2b", "1x1s1", 4, latency_ms=120.0,
                   throughput=30.0, cost=1, accuracy=0.8)
    cfg = PlanConfig(graph=g, counts={key: 2}, tuples={key: tup},
                     demand={"gen": 4.0})
    return g, cfg


def test_port_backends_drive_cluster_runtime(tiny):
    """The port's backends satisfy ExecutionBackend structurally and give
    ClusterRuntime the same SimMetrics schema (test_runtime.py:179-197)."""
    g, cfg = tiny
    scn = Scenario.diurnal(5.0, duration_s=4.0, warmup_s=0.5,
                           seed=2).with_failures(
        FailureEvent(at_s=2.0, count=1, task="gen"))
    backends = {"sim": SimBackend(),
                "engine": EngineBackend(max_new=2, prompt_len=6,
                                        device="cpu")}
    results = {}
    for name, be in backends.items():
        assert isinstance(be, ExecutionBackend)
        m = ClusterRuntime(g, cfg, be, seed=3).run(scn)
        assert isinstance(m, SimMetrics)
        assert m.completions > 0
        results[name] = m
    assert set(backends["engine"]._engines) == {"gemma-2b"}
    f_sim = {f.name: type(getattr(results["sim"], f.name))
             for f in dataclasses.fields(SimMetrics)}
    f_eng = {f.name: type(getattr(results["engine"], f.name))
             for f in dataclasses.fields(SimMetrics)}
    assert f_sim == f_eng
    for m in results.values():
        assert 0.0 <= m.violation_rate <= 1.0
        assert m.p99_ms >= 0.0
        assert 0.0 < m.realized_a_obj(g) <= 1.0 + 1e-9
