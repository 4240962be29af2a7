"""The port's sharding substrate (``repro_torch.sharding.policy``,
``repro_torch.launch.mesh``, the models' spec functions and pins) against
the JAX package's.

Policies and specs are metadata: the port's side runs on ``DeviceMesh``es
over the ``fake`` process group (512 ranks in this process, destroyed
after each test), the reference's on its test's ``FakeMesh``
(``tests/test_sharding.py``).  Numerics need real ranks: 4 spawned gloo
ranks on a 2x2 ``("data", "model")`` mesh run the reduced models under
their policies (one spawn for every case) and are held against the JAX
package's ``mesh=None`` results at the parity tests' tolerances.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import _torch_ranks  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import applicable  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.sharding.policy import ShardingPolicy as JaxPolicy  # noqa: E402
from repro.sharding.policy import make_policy as jax_make_policy  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.sharding.policy import (NULL_POLICY,  # noqa: E402
                                         PartitionSpec, ShardingPolicy,
                                         make_policy)
from repro_torch.training import train_step as tts  # noqa: E402
from test_sharding import MULTIPOD, POD  # noqa: E402

REL_TOL = 1e-4          # as tests/test_models_smoke.py:84
MESHES = {"pod": ((16, 16), ("data", "model"), POD),
          "multipod": ((2, 16, 16), ("pod", "data", "model"), MULTIPOD)}


@pytest.fixture
def fake_world():
    """A 512-rank ``fake`` default group in this process (no processes,
    no collectives), destroyed when the test ends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(name: str):
    shape, names, _ = MESHES[name]
    return tmesh.make_host_mesh(list(zip(names, shape)), device_type="cpu")


def _cells():
    for a in JAX_ARCHS.values():
        for s in JAX_SHAPES.values():
            if applicable(a, s):
                yield a.name, s.name


def _same_policy(mine, want) -> None:
    assert mine.rules == want.rules
    assert mine.attn_mode == want.attn_mode
    assert mine.notes == want.notes


# ---------------------------------------------------------------------------
# make_policy, field by field
@pytest.mark.parametrize("fsdp", [None, True, False])
@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_policy_matches_reference_in_every_cell(fake_world, mesh_name, fsdp):
    mesh = _device_mesh(mesh_name)
    fake = MESHES[mesh_name][2]
    n = 0
    for arch_name, shape_name in _cells():
        training = SHAPES[shape_name].kind == "train"
        mine = make_policy(ARCHS[arch_name], SHAPES[shape_name], mesh,
                           training=training, fsdp=fsdp)
        want = jax_make_policy(JAX_ARCHS[arch_name], JAX_SHAPES[shape_name],
                               fake, training=training, fsdp=fsdp)
        _same_policy(mine, want)
        assert mine.tp == want.tp
        assert mine.seq_shards == want.seq_shards
        assert mine.data_parallel == want.data_parallel
        n += 1
    assert n == 32


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_every_cell_has_divisible_rules(fake_world, mesh_name):
    """tests/test_sharding.py's divisibility check on the port's rules."""
    from test_sharding import _logical_dim
    mesh = _device_mesh(mesh_name)
    extent = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for arch_name, shape_name in _cells():
        arch, shape = ARCHS[arch_name], SHAPES[shape_name]
        pol = make_policy(arch, shape, mesh, training=shape.kind == "train")
        for logical, axes in pol.rules.items():
            if axes is None:
                continue
            size = int(np.prod([extent[a] for a in axes]))
            dim = _logical_dim(arch, shape, logical)
            if dim is not None:
                assert dim % size == 0, (arch.name, shape.name, logical)


def test_stand_in_mesh_reads_like_a_device_mesh(fake_world):
    """The policy reads only axis names and extents: a stand-in with
    ``mesh_dim_names`` and ``shape`` gives the DeviceMesh's policy."""
    mesh = _device_mesh("multipod")
    stand_in = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                               shape=(2, 16, 16))
    for arch_name, shape_name in _cells():
        a = make_policy(ARCHS[arch_name], SHAPES[shape_name], mesh)
        b = make_policy(ARCHS[arch_name], SHAPES[shape_name], stand_in)
        _same_policy(a, b)


def test_spec_deduplicates_mesh_axes():
    pol = ShardingPolicy(mesh=SimpleNamespace(mesh_dim_names=("data", "model"),
                                              shape=(16, 16)),
                         rules={"seq": ("model",), "ff": ("model",),
                                "batch": ("data",)})
    want = JaxPolicy(mesh=POD, rules=pol.rules).spec("batch", "seq", "ff")
    assert pol.spec("batch", "seq", "ff") == tuple(want) == (
        "data", "model", None)


def test_null_policy_is_identity():
    x = torch.ones(4, 4)
    assert NULL_POLICY.pin(x, "batch", "ff") is x
    assert ShardingPolicy(mesh=None).pin(x, "batch") is x
    assert NULL_POLICY.spec("batch") == PartitionSpec(None) == (None,)
    assert make_policy(ARCHS["qwen2-7b"], SHAPES["train_4k"],
                       None) == ShardingPolicy(mesh=None)
    with pytest.raises(ValueError, match="no mesh"):
        NULL_POLICY.placements("batch")


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_attention_mode_selection(fake_world, mesh_name):
    mesh = _device_mesh(mesh_name)
    s = SHAPES["train_4k"]
    assert make_policy(ARCHS["qwen2-7b"], s, mesh).attn_mode == "context"
    assert make_policy(ARCHS["deepseek-67b"], s, mesh).attn_mode == "head_tp"


def test_moe_expert_parallelism_over_data_axes(fake_world):
    pol = make_policy(ARCHS["llama4-maverick-400b-a17b"], SHAPES["train_4k"],
                      _device_mesh("multipod"), training=True)
    assert pol.rules["experts"] is not None
    assert set(pol.rules["experts"]).issubset({"pod", "data"})
    assert pol.rules["expert_ff"] == ("model",)


def test_big_dense_serving_gets_weight_storage_sharding(fake_world):
    """The reference's 12 GiB budget (sized for a 16 GiB v5e) is kept."""
    mesh = _device_mesh("pod")
    pol = make_policy(ARCHS["deepseek-67b"], SHAPES["decode_32k"], mesh)
    assert pol.rules["embed"] is not None
    pol2 = make_policy(ARCHS["gemma-2b"], SHAPES["decode_32k"], mesh)
    assert pol2.rules["embed"] is None


def test_segment_and_production_meshes(fake_world):
    assert tmesh.production_geometry() == (2, (16, 16))
    m = tmesh.make_segment_mesh(1, device_type="cpu")
    assert dict(zip(m.mesh_dim_names, m.shape)) == {"data": 1, "model": 1}
    m = tmesh.make_segment_mesh(64, device_type="cpu")
    assert dict(zip(m.mesh_dim_names, m.shape)) == {"data": 4, "model": 16}
    with pytest.raises(ValueError, match="power of two"):
        tmesh.make_segment_mesh(12, device_type="cpu")
    pod = tmesh.make_production_mesh(device_type="cpu")
    multi = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert (tuple(pod.shape), pod.mesh_dim_names) == MESHES["pod"][:2]
    assert (tuple(multi.shape), multi.mesh_dim_names) == MESHES["multipod"][:2]
    assert pod.device_type == "cpu"
    assert tmesh.device_count() == 512


def test_device_count_without_a_group():
    assert not dist.is_initialized()
    assert tmesh.device_count() == torch.cuda.device_count()


# ---------------------------------------------------------------------------
# placements
def test_placements_follow_spec_on_two_mesh_axes(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = _device_mesh("multipod")
    pol = make_policy(ARCHS["qwen2-7b"], SHAPES["decode_32k"], mesh)
    assert pol.rules["batch"] == ("pod", "data")
    assert pol.spec("batch", "cache_seq", "kvheads", None) == (
        ("pod", "data"), "model", None, None)
    assert pol.placements("batch", "cache_seq", "kvheads", None) == (
        Shard(0), Shard(0), Shard(1))
    assert pol.placements(None, "vocab") == (Replicate(), Replicate(),
                                             Shard(1))
    # a dim over two mesh axes out of mesh order would need a strided shard
    with pytest.raises(ValueError, match="mesh order"):
        pol.placements_of(PartitionSpec(("data", "pod")))


def test_placements_skip_mesh_dims_of_one_rank():
    """As :meth:`pin` does, a spec shards only over mesh dims of more than
    one rank, so on the card's 1x1 mesh every parameter is replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    pol = ShardingPolicy(mesh=SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(1, 4)))
    assert pol.placements_of(PartitionSpec("data", "model")) == (
        Replicate(), Shard(1))
    assert pol.placements_of(PartitionSpec(("data", "model"), None)) == (
        Replicate(), Shard(0))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = tmesh.make_host_mesh([("data", 1), ("model", 1)],
                                    device_type="cpu")
        arch = ARCHS["qwen2-7b"].reduced()
        pol = make_policy(arch, SHAPES["decode_32k"], mesh)
        assert pol.rules["qheads"] == ("model",)
        m = Model(arch, device="meta", policy=pol).distribute()
        placements = {tuple(p.placements) for p in m.parameters()
                      if isinstance(p, DTensor)}
        assert placements == {(Replicate(), Replicate())}
    finally:
        dist.destroy_process_group()


def test_pin_honours_only_dims_the_extent_divides(fake_world):
    mesh = _device_mesh("pod")
    pol = make_policy(ARCHS["qwen2-7b"], SHAPES["decode_32k"], mesh)
    # decode's [B,1,ff]: the size-1 seq dim cannot take the model axis
    assert pol.pin_spec((128, 1, 18944), "batch", "seq", "ff") == (
        "data", None, "model")
    assert pol.pin_spec((3, 5), "batch", "ff") == (None, None)


# ---------------------------------------------------------------------------
# spec trees against the reference's, "layers" dropped
def _drop(tree, n: int = 1):
    if isinstance(tree, dict):
        return {k: _drop(v, n) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_drop(v, n) for v in tree))
    return tuple(tree)[n:]


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree).__name__, tuple(_plain(v) for v in tree)
    return tuple(tree)


def _ref_param_specs(jm):
    specs = jm.param_specs()
    out = {k: tuple(v) for k, v in specs.items()
           if k in ("embed", "final_norm", "lm_head")}
    blocks = specs["blocks"]
    if jm.arch.family == "moe":
        out["blocks"] = {"moe": _drop(blocks["moe"])}
        if "dense" in blocks:                # [n_groups, per_group, ...]
            out["blocks"]["dense"] = _drop(blocks["dense"], 2)
    else:
        out["blocks"] = _drop(blocks)
    if "shared_attn" in specs:
        out["shared_attn"] = _drop(specs["shared_attn"])
    return out


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_spec_trees_match_reference(fake_world, arch_name, reduced):
    mesh = _device_mesh("multipod")
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        jarch, arch = JAX_ARCHS[arch_name], ARCHS[arch_name]
        if reduced:
            jarch, arch = jarch.reduced(), arch.reduced()
        shape = SHAPES[shape_name]
        training = shape.kind == "train"
        jpol = jax_make_policy(jarch, JAX_SHAPES[shape_name], MULTIPOD,
                               training=training)
        pol = make_policy(arch, shape, mesh, training=training)
        jm = JaxModel(jarch, jpol)
        m = Model(arch, device="meta", policy=pol)
        assert _plain(m.param_specs()) == _plain(_ref_param_specs(jm))
        assert _plain(m.cache_specs()) == _plain(
            _drop(jkv.cache_specs(jarch, jpol)))
        want = jts.train_state_specs(jm)
        got = tts.train_state_specs(m)
        assert _plain(got["params"]) == _plain(_ref_param_specs(jm))
        assert got["opt"]["step"] == tuple(want["opt"]["step"]) == ()
        for k in ("master", "m", "v"):
            assert _plain(got["opt"][k]) == _plain(got["params"])
        # every parameter has its spec, one entry per dim
        named = m.named_param_specs()
        assert set(named) == {n for n, _ in m.named_parameters()}
        for n, p in m.named_parameters():
            assert len(named[n]) == p.dim(), n


def test_train_state_shapes_match_reference():
    from repro.training import optimizer as jopt
    from repro_torch.training import optimizer as topt
    jm = JaxModel(JAX_ARCHS["zamba2-7b"].reduced(), JaxPolicy(mesh=None),
                  param_dtype=jnp.float32)
    want = jts.train_state_shapes(jm, jopt.AdamWConfig())
    m = Model(ARCHS["zamba2-7b"].reduced(), device="cpu",
              dtype=torch.float32)
    got = tts.train_state_shapes(m, topt.AdamWConfig())
    wl, wdef = jax.tree.flatten(want)
    from repro_torch.training.checkpoint import _leaves
    gl = _leaves(got)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


# ---------------------------------------------------------------------------
# refusals
def test_mesh_of_another_device_type_raises():
    mesh = SimpleNamespace(device_type="cuda", mesh_dim_names=("data",
                                                                "model"),
                           shape=(1, 1))
    pol = make_policy(ARCHS["qwen2-7b"].reduced(), SHAPES["decode_32k"], mesh)
    with pytest.raises(ValueError, match="mesh is on 'cuda'"):
        Model(ARCHS["qwen2-7b"].reduced(), device="cpu", policy=pol)


def test_null_policy_paths_are_unchanged():
    """policy=None and ShardingPolicy(mesh=None) give the same bits as a
    model built without one (forward, prefill, decode)."""
    arch = ARCHS["qwen2-7b"].reduced()
    g = torch.Generator().manual_seed(0)
    base = Model(arch, device="cpu", dtype=torch.float32).init(g)
    tok = torch.randint(0, arch.vocab_size, (2, 9),
                        generator=torch.Generator().manual_seed(1))
    for pol in (None, ShardingPolicy(mesh=None)):
        m = Model(arch, device="cpu", dtype=torch.float32, policy=pol)
        m.load_state_dict(base.state_dict())
        assert m.distribute() is m and not m.sharded
        assert torch.equal(m(tok), base(tok))
        (la, ca), (lb, cb) = m.prefill(tok, max_seq=12), base.prefill(
            tok, max_seq=12)
        assert torch.equal(la, lb)
        t = la[:, -1].argmax(-1, keepdim=True)
        assert torch.equal(m.decode_step(ca, 9, t)[0],
                           base.decode_step(cb, 9, t)[0])


# ---------------------------------------------------------------------------
# numerics across 4 gloo ranks
B, PROMPT, STEPS, MAX_SEQ = 4, 16, 4, 32
QWEN_MQA = {"num_kv_heads": 1}   # 2*KV*hd < d: prefill picks context mode
# context mode for scout too, and 8 rows an expert for 64 prompt tokens:
# the global dispatch drops tokens, so its token order decides which
SCOUT_DROPS = {"num_kv_heads": 1, "moe": {"capacity_factor": 0.25}}


def _jax(name: str, replace=None, dispatch: str = "auto"):
    jarch = _torch_ranks.replaced(JAX_ARCHS[name].reduced(), replace or {})
    jm = JaxModel(jarch, JaxPolicy(mesh=None), param_dtype=jnp.float32,
                  moe_dispatch=dispatch)
    params = jax.jit(jm.init)(jax.random.key(0))
    arch = _torch_ranks.replaced(ARCHS[name].reduced(), replace or {})
    weights = {k: v.clone() for k, v in from_jax_params(
        arch, jax.tree.map(np.asarray, params)).items()}
    return jm, params, weights


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


# 3 SSM heads of 32 rows: the heads do not divide the model axis, the head
# dim does, so ssm_pdim takes it (mamba2-130m's 24 heads on a pod's 16)
SSM_ODD = {"d_model": 48, "ssm": {"head_dim": 32}}
SERVE_CASES = [
    # (arch, replace, kind, forward, generate)
    ("qwen2-7b", None, "prefill", True, 0),
    ("qwen2-7b", None, "decode", False, 8),
    ("qwen2-7b", QWEN_MQA, "prefill", True, 8),
    ("zamba2-7b", None, "decode", False, 0),
    ("llama4-scout-17b-a16e", None, "decode", False, 0),
    ("llama4-scout-17b-a16e", SCOUT_DROPS, "prefill", True, 0),
    # an attention-free model takes the context rules: its sequence is
    # sharded over "model" (prefill), its head dim too where it decodes
    ("mamba2-130m", None, "prefill", True, 0),
    ("mamba2-130m", SSM_ODD, "decode", False, 0),
    # one KV head (kvheads whole) and a cache of 64 positions: the model
    # axis's second shard [32, 64) is empty through every decode step
    ("qwen2-7b", QWEN_MQA, "decode", False, 8),
]
LONG_CACHE = {("qwen2-7b", "decode", True): 64}
CONTEXT = {("qwen2-7b", "prefill", True),
           ("llama4-scout-17b-a16e", "prefill", True),
           ("mamba2-130m", "prefill", False), ("mamba2-130m", "decode", True)}
SSM_CASES = [i for i, c in enumerate(SERVE_CASES) if c[0] == "mamba2-130m"]


def _max_seq(case) -> int:
    name, replace, kind = case[:3]
    return LONG_CACHE.get((name, kind, bool(replace)), MAX_SEQ)


def _case_id(case) -> str:
    name, replace, kind = case[:3]
    tag = "oddheads-" if replace is SSM_ODD else "mqa-" if replace else ""
    return f"{name}-{tag}{kind}"


def _jax_dispatch(name: str, kind: str, replace) -> str:
    """The reference's MoE dispatch for a case: a context-mode policy
    (its seq rule set) picks the global one, which ``mesh=None`` would
    not pick of itself."""
    return "global" if (name, kind, bool(replace)) in CONTEXT else "auto"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The serve cases on 4 ranks (one spawn), with the JAX package's
    results for each, computed while the ranks run."""
    work = str(tmp_path_factory.mktemp("serve_ranks"))
    tokens = np.random.default_rng(3).integers(
        0, 512, size=(B, PROMPT + STEPS)).astype(np.int32)
    cases, models = [], []
    for case in SERVE_CASES:
        name, replace, kind, forward, generate = case
        jm, params, weights = _jax(name, replace,
                                   _jax_dispatch(name, kind, replace))
        models.append((jm, params))
        max_seq = _max_seq(case)
        cases.append({"arch": name, "replace": replace or {}, "kind": kind,
                      "seq_len": max_seq if kind == "decode" else PROMPT,
                      "weights": weights,
                      "tokens": torch.from_numpy(tokens.astype(np.int64)),
                      "prompt": PROMPT, "max_seq": max_seq, "steps": STEPS,
                      "forward": forward, "generate": generate,
                      # every case runs with F.pad refusing DTensors (the
                      # SSM's conv halo, the prefill's padded cache)
                      "guard": True})
    torch.save(cases, os.path.join(work, "serve_in.pt"))
    ranks = _torch_ranks.start(_torch_ranks.serve, work)
    want = []
    for (jm, params), case in zip(models, cases):
        w = {}
        max_seq = case["max_seq"]
        if case["forward"]:
            w["forward"] = np.asarray(jax.jit(jm.forward)(
                params, jnp.asarray(tokens)))
        prefill = jax.jit(lambda p, t: jm.prefill(p, t, max_seq=max_seq))
        decode = jax.jit(jm.decode_step)
        logits, cache = prefill(params, jnp.asarray(tokens[:, :PROMPT]))
        if "ssm" in cache:
            w["prefill_ssm"] = jax.tree.map(np.asarray, cache["ssm"])
        steps = [np.asarray(logits)]
        for i in range(STEPS):
            logits, cache = decode(
                params, cache, jnp.int32(PROMPT + i),
                jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]))
            steps.append(np.asarray(logits))
        w["steps"] = steps
        if "ssm" in cache:
            w["decode_ssm"] = jax.tree.map(np.asarray, cache["ssm"])
        if case["generate"]:
            eng = JaxEngine(jm, params, JaxEngineConfig(max_batch=B,
                                                        max_seq=max_seq))
            w["generate"] = eng.generate(tokens[:, :PROMPT],
                                         max_new=case["generate"])
        want.append(w)
    _torch_ranks.wait(ranks)
    assert not dist.is_initialized()
    return torch.load(os.path.join(work, "serve_out.pt"),
                      weights_only=False), want


@pytest.mark.parametrize("index", range(len(SERVE_CASES)),
                         ids=[_case_id(c) for c in SERVE_CASES])
def test_sharded_serving_matches_jax(served, index):
    got, want = served[0][index], served[1][index]
    name, replace, kind, forward, generate = SERVE_CASES[index]
    assert got["placed"]
    # both attention modes stay covered
    assert got["mode"] == ("context" if (name, kind, bool(replace))
                           in CONTEXT else "head_tp")
    if forward:
        assert _rel_err(got["forward"].numpy(), want["forward"]) < REL_TOL
    assert len(got["steps"]) == STEPS + 1
    for a, b in zip(got["steps"], want["steps"]):
        assert _rel_err(a.numpy(), b) < REL_TOL
    if generate:
        assert got["decode_mode"] == "eager"
        assert np.array_equal(got["generate"], want["generate"])
    # a prefill over 4 ranks moves data: its collectives were counted
    assert sum(got["prefill_comms"].values()) > 0


ATTN_CASES = [i for i, c in enumerate(SERVE_CASES)
              if c[0] != "mamba2-130m"]


@pytest.mark.parametrize("index", ATTN_CASES,
                         ids=[_case_id(SERVE_CASES[i]) for i in ATTN_CASES])
def test_sharded_decode_merges_cache_shards(served, index):
    """Every decode step ran as flash-decode over the sequence-sharded
    cache, as the reference's lowering does: each rank took its shard's
    share on its valid positions (none where the shard lies past
    ``cache_len``), no rank attended a whole cache, and no all-gather of
    the decode steps took a layer's local cache shard; the shares were
    merged with all-reduces."""
    got = served[0][index]
    case = SERVE_CASES[index]
    assert got["rules"]["cache_seq"] == ("model",)
    max_seq, model = _max_seq(case), 2
    S_local = max_seq // model
    calls = got["attention_calls"]
    layers = len(calls[0]["partial"]) // STEPS
    assert layers >= 1
    for rank, seen in enumerate(calls):
        assert seen["decode"] == []
        start = (rank % model) * S_local      # the mesh is (data, model)
        want = [(S_local, min(max(PROMPT + i + 1 - start, 0), S_local))
                for i in range(STEPS) for _ in range(layers)]
        assert seen["partial"] == want, rank
    if index == len(SERVE_CASES) - 1:      # the long cache's empty shard
        assert {v for _, v in calls[1]["partial"]} == {0}
    assert got["cache_shard"] == (B // 2, S_local) + got["cache_shard"][2:]
    assert got["cache_shard"] not in got["decode_gathered"], (
        got["decode_gathered"])
    assert got["decode_comms"].get(
        "c10d_functional.all_reduce", 0) >= 2 * layers * STEPS


@pytest.mark.parametrize("index", ATTN_CASES,
                         ids=[_case_id(SERVE_CASES[i]) for i in ATTN_CASES])
def test_context_prefill_attends_local_query_rows(served, index):
    """In context mode each rank ran its own query rows (half the
    sequence) at their global offset against the whole K/V, as the
    reference's ``flash_attention(q, kr, vr, positions, positions)`` does;
    in head_tp mode every rank ran every row."""
    got = served[0][index]
    name, replace, kind, forward = SERVE_CASES[index][:4]
    context = (name, kind, bool(replace)) in CONTEXT
    lengths = ([PROMPT + STEPS] if forward else []) + [PROMPT]
    for rank, seen in enumerate(got["attention_calls"]):
        flash = seen["flash"]
        assert flash and {(k, off) for _, k, off in flash} <= {
            (S, (rank % 2) * S // 2 if context else None) for S in lengths}
        assert all(rows == (k // 2 if context else k)
                   for rows, k, _ in flash), rank


def _assert_states_close(got, want) -> None:
    """The port's per-layer SSM states (whole) against the reference's
    stacked ones, at the serve tolerance."""
    assert len(got) == want.ssd.shape[0]
    for i, layer in enumerate(got):
        for field, (t, _) in layer.items():
            assert _rel_err(t.numpy(), getattr(want, field)[i]) < REL_TOL, (
                i, field)


@pytest.mark.parametrize("index", SSM_CASES,
                         ids=[_case_id(SERVE_CASES[i]) for i in SSM_CASES])
def test_sharded_ssm_runs_on_its_shards(served, index):
    """The Mamba2 cases ran sharded as the rules say: the prefill's causal
    conv on sequence shards (the halo; ``F.pad`` refused DTensors), and in
    the odd-heads case each decode step's SSD and out-projection on
    head-dim shards.  The states handed to decode (conv tails, SSD state)
    and those after the decode steps are the reference's."""
    got, want = served[0][index], served[1][index]
    rules = got["rules"]
    assert rules["seq"] == ("model",) and rules["batch"] == ("data",)
    layers = len(got["prefill_ssm"])
    assert got["ssm_calls"]["conv_and_tail"] == 3 * layers * (
        2 if SERVE_CASES[index][3] else 1)        # forward, then prefill
    tail = dict((f, p) for f, (_, p) in got["prefill_ssm"][0].items())
    assert tail["conv_x"] == "(Shard(dim=0), Replicate())"
    if SERVE_CASES[index][1] is SSM_ODD:
        assert rules["ssm_heads"] is None and rules["ssm_pdim"] == ("model",)
        assert got["ssm_calls"]["_out_proj_local"] == layers * STEPS
        assert dict((f, p) for f, (_, p) in got["decode_ssm"][0].items())[
            "ssd"] == "(Shard(dim=0), Shard(dim=2))"
    else:
        assert rules["ssm_heads"] == ("model",)
        assert got["ssm_calls"]["_out_proj_local"] == 0
    _assert_states_close(got["prefill_ssm"], want["prefill_ssm"])
    _assert_states_close(got["decode_ssm"], want["decode_ssm"])


def test_sharded_moe_global_dispatch_drops_tokens(served):
    """The context-mode scout case is one that capacity decides: the
    reference's forward at a capacity that drops nothing differs from its
    forward at the case's, which the port matched on 4 ranks."""
    index = SERVE_CASES.index(("llama4-scout-17b-a16e", SCOUT_DROPS,
                               "prefill", True, 0))
    assert served[0][index]["mode"] == "context"
    whole = dict(SCOUT_DROPS, moe={"capacity_factor": 8.0})
    jm, params, _ = _jax("llama4-scout-17b-a16e", whole, "global")
    tokens = np.random.default_rng(3).integers(
        0, 512, size=(B, PROMPT + STEPS)).astype(np.int32)
    undropped = np.asarray(jax.jit(jm.forward)(params, jnp.asarray(tokens)))
    assert _rel_err(undropped, served[1][index]["forward"]) > 100 * REL_TOL


def test_sharded_moe_runs_expert_parallel(served):
    """Scout's experts are sharded over the data axis and their ffn over
    the model axis (expert parallelism + expert TP)."""
    got = served[0][4]
    assert got["rules"]["experts"] == ("data",)
    assert got["rules"]["expert_ff"] == ("model",)


# ---------------------------------------------------------------------------
# training on 4 gloo ranks: the paths torch 2.11's DTensor refused
# (a sequence-sharded Mamba2, a tied embedding in context mode) and int8
# error feedback under the mesh, its err buffers through a checkpoint
TRAIN_CASES = [
    # (id, arch, replace, compression, steps, checkpoint)
    ("mamba2-seq-sharded", "mamba2-130m", None, None, 1, False),
    # 3 query heads do not divide the model axis: context mode, as
    # gemma-2b's 8 on a pod's 16, its tied table vocab-sharded
    ("gemma-context-tied", "gemma-2b", {"num_heads": 3}, None, 2, False),
    # test_torch_train_knobs.py's int8 case, on the mesh
    ("gemma-int8", "gemma-2b", None, "int8", 3, True),
]


@pytest.fixture(scope="module")
def trained_cases(tmp_path_factory):
    """The train cases on 4 ranks (one spawn) and the reference's states
    and metrics after each step at ``mesh=None`` (one step more for a case
    with a checkpoint)."""
    from repro.training import data as jdata
    from repro.training import optimizer as jopt
    from test_torch_training import B as TB
    from test_torch_training import JCFG, S as TS
    work = str(tmp_path_factory.mktemp("train_case_ranks"))
    cases, want = [], []
    for _, name, replace, compression, steps, ck in TRAIN_CASES:
        jm, params, weights = _jax(name, replace)
        cases.append({"arch": name, "replace": replace or {},
                      "compression": compression, "steps": steps,
                      "ckpt": ck, "batch": TB, "seq_len": TS,
                      "weights": weights,
                      "adamw": {"lr": JCFG.lr,
                                "warmup_steps": JCFG.warmup_steps,
                                "total_steps": JCFG.total_steps}})
        if compression:
            cases[-1]["quant"] = _quant_inputs(name, params)
        want.append((jm, params, compression, steps + ck))
    torch.save(cases, os.path.join(work, "train_cases_in.pt"))
    ranks = _torch_ranks.start(_torch_ranks.train_cases, work)
    ref = []
    for jm, params, compression, n in want:
        step = jax.jit(jts.make_train_step(jm, JCFG,
                                           grad_compression=compression))
        dcfg = jdata.for_arch(jm.arch, TS, TB)
        state = {"params": params, "opt": jopt.init_state(params)}
        metrics, states = [], []
        for i in range(n):
            batch = {k: jnp.asarray(v)
                     for k, v in jdata.batch_at_step(dcfg, i).items()}
            state, met = step(state, batch)
            metrics.append(jax.tree.map(float, met))
            states.append(jax.tree.map(np.asarray, state))
        ref.append((metrics, states))
    _torch_ranks.wait(ranks, timeout_s=2 * _torch_ranks.TIMEOUT_S)
    assert not dist.is_initialized()
    return torch.load(os.path.join(work, "train_cases_out.pt"),
                      weights_only=False), ref


def _quant_inputs(name: str, params) -> tuple:
    """Seeded gradients and error buffers of the reference tree's shapes,
    per port parameter name (the reference's stacked trees rebuild them)."""
    rng = np.random.default_rng(11)
    arch = ARCHS[name].reduced()

    def draw(scale):
        return from_jax_params(arch, jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * scale).astype(
                np.float32), params))

    return draw(1e-2), draw(1e-4)


# int8 error feedback: an element of (grad + err) within rounding of a
# quantization boundary rounds either way under another summation order
# (the quantizer's one discontinuity).  Its err then moves by one step of
# its leaf's scale (at most twice the leaf's largest |err|) and its
# parameter by at most 2 lr a step, AdamW's bound on any update.  At most
# FLIP_SHARE of the elements may be such flips; all others stay within the
# parity tolerances.
FLIP_SHARE = 1e-3


def _assert_int8_close(want, got, bound, total: int) -> None:
    """``got``'s leaves within RTOL/ATOL of ``want``'s but for int8
    rounding flips, each within ``bound(a, b)`` (a leaf pair)."""
    from test_torch_training import ATOL, RTOL, _leaves
    flips = 0
    for a, b in zip(_leaves(want), _leaves(got)):
        assert a.shape == b.shape and a.dtype == b.dtype
        off = np.abs(b - a) > ATOL + RTOL * np.abs(a)
        assert (np.abs(b - a)[off] <= bound(a, b)).all()
        flips += int(off.sum())
    assert flips <= FLIP_SHARE * total, flips


@pytest.mark.parametrize("index", range(len(TRAIN_CASES)),
                         ids=[c[0] for c in TRAIN_CASES])
def test_sharded_training_cases_match_jax(trained_cases, index):
    from test_torch_training import (GNORM_RTOL, LOSS_RTOL,
                                     _assert_params_close,
                                     _assert_trees_close)
    got = trained_cases[0][index]
    metrics, states = trained_cases[1][index]
    case_id, name, _, compression, steps, _ = TRAIN_CASES[index]
    for i in range(steps):
        np.testing.assert_allclose(got["losses"][i], metrics[i]["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["gnorms"][i],
                                   metrics[i]["grad_norm"], rtol=GNORM_RTOL)
    lr_sum = sum(m["lr"] for m in metrics[:steps])
    want = states[steps - 1]
    if compression:
        total = sum(x.size for x in jax.tree.leaves(want["params"]))
        _assert_int8_close(want["params"], got["tree"]["params"],
                           lambda a, b: 2 * lr_sum, total)
        _assert_int8_close(want["err"], got["tree"]["err"], lambda a, b: (
            2 * max(np.abs(a).max(), np.abs(b).max()) * (1 + 1e-3)), total)
        assert got["err_placements"] == got["placements"]
    else:
        _assert_params_close(want, got["tree"], lr_sum)
        # the first moments: the gradients themselves
        _assert_trees_close(want["opt"]["m"], got["tree"]["opt"]["m"])
    rules = got["rules"]
    if name == "mamba2-130m":
        # the sequence is sharded, so every causal conv ran on its shards
        assert rules["seq"] == ("model",) and rules["batch"] == ("data",)
        assert got["conv_calls"] > 0
    if case_id == "gemma-context-tied":
        assert got["mode"] == "context" and rules["vocab"] == ("model",)
        assert got["placements"]["embed"] == "(Shard(dim=1), Shard(dim=0))"
        # the tied table's two gradients were placed before they summed
        assert got["grad_placed"] >= 2 * steps


def test_sharded_int8_quantizes_as_the_reference(trained_cases):
    """On the same gradients and error buffers, the mesh's per-layer int8
    quantization (one scale per reference leaf, a collective max; each
    layer on its parameter's placements) is the reference's
    ``compressed_psum`` of the stacked trees, bit for bit."""
    from repro.training import compression as jcomp
    index = next(i for i, c in enumerate(TRAIN_CASES) if c[3])
    got = trained_cases[0][index]["quant"]
    name = TRAIN_CASES[index][1]
    arch = ARCHS[name].reduced()
    from repro_torch.models.convert import to_jax_params
    grads, errs = (to_jax_params(arch, t) for t in _quant_inputs(
        name, jax.tree.map(np.asarray, _jax(name)[1])))
    want = jcomp.compressed_psum(jax.tree.map(jnp.asarray, grads),
                                 jax.tree.map(jnp.asarray, errs), None)
    for w, g in zip(want, got):
        wl, gl = jax.tree.leaves(w), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), g))
        assert len(wl) == len(gl)
        for a, b in zip(wl, gl):
            assert np.array_equal(np.asarray(a), b)


def test_sharded_int8_err_survives_a_checkpoint(trained_cases):
    """The err buffers of the int8 case, saved unsharded and restored onto
    the mesh with placements, are the saved ones leaf for leaf, and the
    next step from them is the next step of the run that saved them (and
    the reference's)."""
    from test_torch_training import LOSS_RTOL, _assert_trees_close
    index = next(i for i, c in enumerate(TRAIN_CASES) if c[5])
    got = trained_cases[0][index]
    metrics = trained_cases[1][index][0]
    steps = TRAIN_CASES[index][4]
    assert got["restored_err_placed"] == "(Shard(dim=1), Shard(dim=0))"
    _assert_trees_close(got["tree"], got["restored_tree"], rtol=0, atol=0)
    assert got["restored_next_loss"] == got["next_loss"]
    _assert_trees_close(got["next_tree"]["err"],
                        got["restored_next_tree"]["err"], rtol=0, atol=0)
    np.testing.assert_allclose(got["next_loss"], metrics[steps]["loss"],
                               rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# chip_smoke.phase_shard, rehearsed on the CPU
def _counting(mod, plain):
    def launch(*args, **kw):
        mod.launches += 1
        return plain(*args, **kw)
    return launch


@pytest.fixture
def shard_phase(monkeypatch):
    """``chip_smoke.phase_shard`` on the CPU: reduced fp32 models, a gloo
    group and a cpu mesh, the kernel wrappers replaced by counting plain
    versions (``ops._on_cuda`` forced, so the wrappers are reached), the
    card's memory calls stubbed."""
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    import repro_torch.configs as configs
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ssd_scan as smod

    def reduced(torch_, name, num_layers=None, dtype=None, seed=0):
        return Model(ARCHS[name].reduced(), device="cpu",
                     dtype=torch.float32).init(
            torch.Generator().manual_seed(seed))

    full = configs.get_arch
    monkeypatch.setattr(configs, "get_arch", lambda n: full(n).reduced())
    monkeypatch.setattr(chip_smoke, "_model", reduced)
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(fmod, "flash_attention",
                        _counting(fmod, ref.flash_attention_ref))
    monkeypatch.setattr(dmod, "decode_attention",
                        _counting(dmod, ref.decode_attention_ref))
    monkeypatch.setattr(smod, "ssd_scan", _counting(
        smod, lambda *a, init_state=None: ref.ssd_scan_ref(
            *a, init_state=init_state)))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **kw: 0)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield lambda: chip_smoke.phase_shard(
        torch, {"nvidia_smi": "cpu rehearsal"}, 0, device="cpu",
        backend="gloo", busy_of=lambda prof: 0.0)
    torch.set_num_threads(n)
    assert not dist.is_initialized()


def test_chip_smoke_shard_phase_rehearsal(shard_phase, capsys):
    import json
    launches = shard_phase()
    by = {}
    for ln in capsys.readouterr().out.splitlines():
        if ln.startswith("{"):
            d = json.loads(ln)
            by.setdefault(d["phase"], []).append(d)
    assert [d["arch"] for d in by["shard_serve"]] == [
        "qwen2-7b-reduced", "mamba2-130m-reduced"]
    for d in by["shard_serve"]:
        assert d["tokens_identical"] and not d["failures"]
        assert d["plain"]["decode_mode"] == d["sharded"]["decode_mode"]
    assert launches["qwen2-7b"]["flash_attention"] == 2
    assert launches["qwen2-7b"]["decode_attention"] == 2 * 15
    assert launches["mamba2-130m"]["ssd_scan"] == 2
    train = by["shard_train"][0]
    assert train["max_loss_rel_diff"] <= 1e-3
    assert train["rules"]["embed"] == ["data"]
    int8 = by["shard_train_int8"][0]
    assert int8["layers"] == 8 and int8["max_loss_rel_diff"] <= 1e-3
    assert int8["max_err_abs_diff"] <= int8["err_atol"] == 1e-6
    assert by["shard_phase"][0]["failures"] == []


def test_chip_smoke_shard_phase_fails_on_a_per_layer_scale(shard_phase,
                                                          monkeypatch):
    """int8 under the mesh with one scale a layer, not one a reference
    leaf, must fail the phase's err check."""
    from repro_torch.training import compression as comp
    whole = comp.quantize_layers

    def per_layer(grads, errs):
        outs = [whole([g], [e]) for g, e in zip(grads, errs)]
        return [o[0][0] for o in outs], [o[1][0] for o in outs]

    monkeypatch.setattr(comp, "quantize_layers", per_layer)
    with pytest.raises(AssertionError, match="shard: .*err buffers"):
        shard_phase()


def test_chip_smoke_shard_phase_fails_on_a_wrong_pin(shard_phase,
                                                     monkeypatch):
    """A pin that changes values under the mesh must fail the phase."""
    pin = ShardingPolicy.pin

    def wrong(self, x, *logical):
        out = pin(self, x, *logical)
        return out * 1.5 if self.mesh is not None else out

    monkeypatch.setattr(ShardingPolicy, "pin", wrong)
    with pytest.raises(AssertionError, match="shard: .*(tokens|logits)"):
        shard_phase()
