"""The port's MoE family (``repro_torch.models.moe``, the llama4 configs)
against the JAX package, on the CPU in fp32 with converted weights: each
layer's routes, keeps and slots exactly, its output within 1e-4; whole
models (``moe_every`` 1 and 2) through forward, prefill and decode; greedy
serving token for token on left-padded prompts; the full-width models on
the meta device."""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models.moe as jmoe  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.kvcache import cache_bytes as jax_cache_bytes  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.sharding.policy import ShardingPolicy  # noqa: E402
import repro_torch.configs as pconfigs  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.kvcache import cache_bytes  # noqa: E402
from repro_torch.serving import Batcher, Engine, EngineConfig, ServeRequest  # noqa: E402

SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
NEW_ARCHS = (SCOUT, MAVERICK, "deepseek-67b")
REL_TOL = 1e-4          # as tests/test_models_smoke.py:84
POLICY = ShardingPolicy(mesh=None)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread is enough, and keeps
    this file from crowding the tests that run beside it in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _arch(pkg_archs, variant: str, **moe_kw):
    """A reduced MoE config of either package: ``"scout"`` (every layer
    MoE) or ``"interleave"`` (maverick with ``moe_every=2`` over two
    groups: dense, MoE, dense, MoE); ``moe_kw`` replaces MoE fields."""
    if variant == "scout":
        arch = pkg_archs[SCOUT].reduced()
    else:
        arch = pkg_archs[MAVERICK].reduced()
        arch = dataclasses.replace(arch, num_layers=4)
        moe_kw = {"moe_every": 2, **moe_kw}
    return dataclasses.replace(arch, moe=dataclasses.replace(arch.moe,
                                                             **moe_kw))


def _pair(variant: str, seed: int = 0, **moe_kw):
    """(jax model, jax params, port model) on the same weights, the MoE
    norms made non-zero so that their scale is exercised."""
    jm = JaxModel(_arch(jconfigs.ARCHS, variant, **moe_kw), POLICY,
                  param_dtype=jnp.float32)
    params = jm.init(jax.random.key(seed))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    norm = params["blocks"]["moe"]["moe_norm"]
    params["blocks"]["moe"]["moe_norm"] = (
        rng.standard_normal(norm.shape) * 0.2).astype(np.float32)
    arch = _arch(ARCHS, variant, **moe_kw)
    m = Model(arch, device="cpu", dtype=torch.float32)
    m.load_state_dict(from_jax_params(arch, params))
    return jm, params, m


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(variant):
        if variant not in cache:
            cache[variant] = _pair(variant)
        return cache[variant]
    return get


def _jax_routes(monkeypatch, h, p, arch, dispatch):
    """The reference's ``moe_mlp`` output and its routes: ``idx`` from
    ``repro.models.moe._route`` and ``keep``/``slot`` read off the capacity
    buffer that its ``_expert_ffn`` receives.  Each buffer row is a copy of
    one token's normed input, so matching rows exactly names the (token,
    expert, rank) the reference chose; groups as the port's ``Routes``
    (one group when the dispatch is global)."""
    m = arch.moe
    E, K = m.num_experts, m.experts_per_token
    seen = []
    ffn = jmoe._expert_ffn

    def spy(xb, *args):
        seen.append(np.asarray(xb))
        return ffn(xb, *args)

    monkeypatch.setattr(jmoe, "_expert_ffn", spy)
    y = np.asarray(jmoe.moe_mlp(jnp.asarray(h), p, arch, POLICY,
                                dispatch=dispatch))
    monkeypatch.setattr(jmoe, "_expert_ffn", ffn)
    B, S, d = h.shape
    hn = np.asarray(jlayers.rms_norm(jnp.asarray(h), p["moe_norm"],
                                     arch.norm_eps))
    buf = seen[0]
    if buf.ndim == 3:                               # global: one group
        hn, buf = hn.reshape(1, B * S, d), buf[:, None]
    G, N = hn.shape[:2]
    _, idx = jmoe._route(jnp.asarray(hn), p, m)
    idx = np.asarray(idx)
    cap = buf.shape[2]
    keep = np.zeros((G, N * K), bool)
    slot = np.full((G, N * K), E * cap)
    for e, g, c in zip(*np.nonzero(np.abs(buf).sum(-1))):
        (n,) = np.nonzero((hn[g] == buf[e, g, c]).all(-1))[0]
        (k,) = np.nonzero(idx[g, n] == e)[0]
        keep[g, n * K + k] = True
        slot[g, n * K + k] = e * cap + c
    return y, idx, keep, slot


def _check_layer(monkeypatch, jm, params, m, h, dispatch):
    """The port's ``moe_mlp`` on MoE layer 0 against the reference's:
    routes exactly, output within REL_TOL; returns the drops."""
    p = jax.tree.map(lambda x: jnp.asarray(x[0]), params["blocks"]["moe"])
    blk = next(b for b in m.blocks if isinstance(b, moe.MoEBlock))
    want, idx, keep, slot = _jax_routes(monkeypatch, h, p, jm.arch, dispatch)
    routes = []
    got = moe.moe_mlp(torch.from_numpy(h), blk, m.arch, dispatch, routes)
    (r,) = routes
    assert np.array_equal(r.idx.numpy(), idx)
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(r.slot.numpy(), slot)
    assert _rel_err(got.numpy(), want) < REL_TOL
    return int((~keep).sum())


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_moe_mlp_matches_jax(monkeypatch, dispatch, k, shared):
    jm, params, m = _pair("scout", seed=k, experts_per_token=k,
                          shared_expert=shared)
    h = np.random.default_rng(7).standard_normal((3, 40, 64)).astype(
        np.float32)
    _check_layer(monkeypatch, jm, params, m, h, dispatch)


@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_capacity_drops_match_jax(monkeypatch, dispatch):
    """At capacity factor 0.25 (tests/test_models_smoke.py:106-121) tokens
    drop, and the same ones as in the reference."""
    jm, params, m = _pair("scout", capacity_factor=0.25)
    h = np.random.default_rng(3).standard_normal((3, 64, 64)).astype(
        np.float32)
    assert _check_layer(monkeypatch, jm, params, m, h, dispatch) > 0


@pytest.mark.parametrize("B", [1, 3])
def test_auto_dispatch_resolves_like_jax(monkeypatch, pairs, B):
    """``"auto"`` is grouped on one device, and a batch of one dispatches
    globally (one group of all its tokens)."""
    jm, params, m = pairs("scout")
    h = np.random.default_rng(B).standard_normal((B, 24, 64)).astype(
        np.float32)
    _check_layer(monkeypatch, jm, params, m, h, "auto")
    routes = []
    moe.moe_mlp(torch.from_numpy(h), m.blocks[0], m.arch, "auto", routes)
    assert routes[0].keep.shape == (B, 24)


def _tokens(arch, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, arch.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("variant", ["scout", "interleave"])
def test_forward_matches_jax(pairs, variant):
    jm, params, m = pairs(variant)
    if variant == "interleave":
        assert [type(b).__name__ for b in m.blocks] == [
            "DenseBlock", "MoEBlock", "DenseBlock", "MoEBlock"]
    tokens = _tokens(m.arch, 2, 24, seed=5)
    want = np.asarray(jm.forward(params, jnp.asarray(tokens)))
    got = m.forward(torch.from_numpy(tokens).long()).numpy()
    assert got.shape == want.shape
    assert _rel_err(got, want) < REL_TOL


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("variant", ["scout", "interleave"])
def test_prefill_and_decode_match_jax(pairs, variant, B):
    """Prefill, then decode steps against the KV caches (their layer index
    the model's), each step's logits and the caches within 1e-4."""
    jm, params, m = pairs(variant)
    S, extra, max_seq = 16, 4, 24
    tokens = _tokens(m.arch, B, S + extra, seed=B)
    jl, jc = jm.prefill(params, jnp.asarray(tokens[:, :S]), max_seq=max_seq)
    tl, tc = m.prefill(torch.from_numpy(tokens[:, :S]).long(),
                       max_seq=max_seq)
    assert _rel_err(tl.numpy(), jl) < REL_TOL
    assert len(tc["k"]) == m.arch.num_layers
    for i in range(extra):
        step = tokens[:, S + i:S + i + 1]
        jl, jc = jm.decode_step(params, jc, jnp.int32(S + i),
                                jnp.asarray(step))
        tl, tc = m.decode_step(tc, S + i, torch.from_numpy(step).long())
        assert _rel_err(tl.numpy(), jl) < REL_TOL
    for name in ("k", "v"):
        got = np.stack([c.numpy() for c in tc[name]])
        assert _rel_err(got, jc[name]) < REL_TOL


def _left_padded(arch, lens, seed=0):
    """Prompts of unequal lengths, left-padded with token 0 as the batcher
    pads them: the pads route (all alike) and fill one expert past its
    capacity."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, arch.vocab_size, size=n).astype(np.int32)
               for n in lens]
    S = max(lens)
    toks = np.zeros((len(lens), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    return prompts, toks


@pytest.mark.parametrize("variant", ["scout", "interleave"])
def test_engine_generate_token_exact_vs_jax(monkeypatch, pairs, variant):
    jm, params, m = pairs(variant)
    cfg = dict(max_batch=4, max_seq=48)
    jeng = JaxEngine(jm, params, JaxEngineConfig(**cfg))
    eng = Engine(m, EngineConfig(**cfg))
    prompts, toks = _left_padded(m.arch, (3, 30, 11))
    want = jeng.generate(toks, max_new=6)
    assert np.array_equal(eng.generate(toks, max_new=6), want)
    # the 27 pads of the shortest prompt route alike in the first MoE
    # layer: ranks 0..26 at one expert of capacity 16, so 11 drop
    log, mlp = [], moe.moe_mlp
    monkeypatch.setattr(moe, "moe_mlp", lambda h, blk, arch, dispatch:
                        mlp(h, blk, arch, dispatch, log))
    m.prefill(torch.from_numpy(toks).long())
    monkeypatch.undo()
    first = log[0]
    assert len(log) == m.moe_group[0]
    assert len(set(first.idx[0, :27, 0].tolist())) == 1
    assert int((~first.keep[0, :27]).sum()) == 11
    # the batcher forms the same batch and returns the same tokens
    b = Batcher(eng, timeout_ms=0.0, max_new=6, clock=lambda: 0.0)
    for i, p in enumerate(prompts):
        b.submit(ServeRequest(i, p, deadline_s=1.0, submitted_s=0.0))
    done = b.pump()
    assert np.array_equal(np.stack([r.result for r in done]), want)


@pytest.mark.parametrize("name,n_params", [(SCOUT, 107_769_861_120),
                                           (MAVERICK, 397_691_950_080)])
def test_full_width_on_meta_device(name, n_params):
    """The full-width models build on the meta device without allocating,
    holding exactly ``ArchConfig.param_count()`` parameters."""
    arch = get_arch(name)
    m = Model(arch, device="meta")
    assert all(p.is_meta for p in m.parameters())
    assert sum(p.numel() for p in m.parameters()) == \
        arch.param_count()[0] == n_params
    n_groups, dense_per = m.moe_group
    assert len(m.blocks) == arch.num_layers == n_groups * (dense_per + 1)
    blk = m.blocks[dense_per]
    E, fe = arch.moe.num_experts, arch.moe.d_ff_expert
    assert blk.we_g.shape == (E, 5120, fe) and blk.we_d.shape == (E, fe, 5120)
    assert blk.router.shape == (5120, E) and blk.ws_d.shape == (fe, 5120)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_arch_copy_matches_reference(name):
    assert dataclasses.asdict(ARCHS[name]) == \
        dataclasses.asdict(jconfigs.ARCHS[name])
    assert dataclasses.asdict(ARCHS[name].reduced()) == \
        dataclasses.asdict(jconfigs.ARCHS[name].reduced())
    assert ARCHS[name].param_count() == jconfigs.ARCHS[name].param_count()
    assert get_arch(name + "-reduced") == ARCHS[name].reduced()
    for batch, seq in [(8, 1024), (1, 4096)]:
        assert cache_bytes(ARCHS[name], batch, seq) == \
            jax_cache_bytes(jconfigs.ARCHS[name], batch, seq)


def test_registry_and_shapes_match_reference():
    """The port's registry holds the reference's 10 archs in its order, and
    ``configs/shapes.py`` is a copy: every shape, its tokens, and every
    (arch, shape) cell's applicability and skip reason."""
    assert list(pconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert len(pconfigs.ARCHS) == 10
    assert list(pconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in jconfigs.SHAPES.items():
        got = pconfigs.get_shape(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(shape)
        assert got.tokens == shape.tokens
    cells = [(a.name, s.name, ok, why)
             for a, s, ok, why in jconfigs.all_cells()]
    assert [(a.name, s.name, ok, why)
            for a, s, ok, why in pconfigs.all_cells()] == cells
    assert sum(not ok for _, _, ok, _ in cells) == 8
    with pytest.raises(KeyError, match="unknown shape"):
        pconfigs.get_shape("train_8k")


def test_init_draws_reference_scales():
    """``Model.init`` on an MoE model: the reference's scales (router and
    expert up-projections d^-0.5, down-projections fe^-0.5, norms zero),
    each expert drawn on its own."""
    arch = _arch(ARCHS, "interleave", d_ff_expert=256)
    m = Model(arch, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))
    blk = m.blocks[1]
    d, fe = arch.d_model, arch.moe.d_ff_expert
    for name, want in (("router", d ** -0.5), ("we_g", d ** -0.5),
                       ("we_u", d ** -0.5), ("we_d", fe ** -0.5),
                       ("ws_g", d ** -0.5), ("ws_d", fe ** -0.5),
                       ("wq", d ** -0.5)):
        std = float(getattr(blk, name).std())
        assert abs(std / want - 1) < 0.05, name
    assert not blk.moe_norm.any() and not blk.attn_norm.any()
    assert not torch.equal(blk.we_g[0], blk.we_g[1])
    assert float(m.blocks[0].wd.std()) == pytest.approx(
        arch.d_ff ** -0.5, rel=0.05)


def test_model_refuses_unknown_dispatch():
    with pytest.raises(ValueError, match="moe_dispatch"):
        Model(ARCHS[SCOUT].reduced(), device="cpu", moe_dispatch="sorted")


# ---------------------------------------------------------------------------
# chip_smoke.py's moe phase, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _routes(idx, keep, probs_top):
    """moe.Routes of one layer for B rows of S tokens, K = 1, E = 2: expert
    ``idx``, ``keep``, and the top probability (the other takes the
    rest)."""
    idx = torch.tensor(idx)[..., None]
    p = torch.tensor(probs_top, dtype=torch.float32)
    probs = torch.stack([p, 1 - p], -1)
    probs = torch.where(idx == 0, probs, probs.flip(-1))
    keep = torch.tensor(keep).reshape(idx.shape[0], -1)
    return moe.Routes(probs, idx, keep, torch.zeros_like(keep, dtype=torch.long))


def test_route_diff_classifies_flips():
    """A flip is primary only where every token up to it in its row agreed
    in every earlier layer; a token agrees while nothing up to it in its
    row differed in any layer."""
    chip_smoke = _chip_smoke()
    ones = [[True] * 4] * 2
    plain = [_routes([[0, 0, 1, 1], [1, 1, 0, 0]], ones,
                     [[.9, .6, .8, .505], [.7, .9, .9, .52]]),
             _routes([[0, 1, 0, 1], [1, 0, 1, 0]], ones,
                     [[.9, .95, .6, .501], [.8, .8, .7, .9]])]
    kernel = [_routes([[0, 0, 1, 0], [1, 1, 0, 0]], ones,
                      [[.9, .6, .8, .51], [.7, .9, .9, .52]]),
              _routes([[0, 1, 1, 0], [1, 0, 1, 0]],
                      [[True] * 4, [True, True, False, True]],
                      [[.9, .95, .6, .5], [.8, .8, .7, .9]])]
    diff = chip_smoke._route_diff(torch, kernel, plain, 2)
    layers = diff["layers"]
    # layer 0: row 0 token 3 flips (margin .01), primary
    assert [(f["row"], f["token"]) for f in layers[0]["primary_flips"]] == \
        [(0, 3)]
    assert layers[0]["primary_flips"][0]["margin"] == pytest.approx(0.01,
                                                                abs=1e-6)
    # layer 1: row 0 token 2 (before row 0's first difference) is primary,
    # token 3 is not; row 1's keep differs at token 2
    assert [(f["row"], f["token"]) for f in layers[1]["primary_flips"]] == \
        [(0, 2)]
    assert layers[1]["other_flip_margins"] == pytest.approx([0.002], abs=1e-6)
    assert layers[1]["keeps_differ"] == 1
    assert diff["primary_margin_max"] == pytest.approx(0.2, abs=1e-6)
    assert diff["agree"].tolist() == [[True, True, False, False],
                                      [True, True, False, False]]


def _counting(mod, plain):
    def launch(*args, **kw):
        mod.launches += 1
        return plain(*args, **kw)
    return launch


@pytest.mark.parametrize("fault,fails_on", [
    (None, None),
    ("flash_not_causal", "fp32 teacher-forced"),
    ("decode_uncounted", "launch counts")])
def test_chip_smoke_moe_phase_rehearsal(monkeypatch, capsys, fault,
                                        fails_on):
    """``chip_smoke.phase_moe`` on reduced CPU models (maverick with
    ``moe_every=2``), the kernel wrappers replaced by counting plain
    versions: it passes, and a wrong attention kernel or a decode launch
    that is not counted fails it."""
    chip_smoke = _chip_smoke()
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rms_norm as nmod

    def reduced(torch_, name, num_layers=None, dtype=None, seed=0):
        arch = _arch(ARCHS, "scout" if name == SCOUT else "interleave")
        if num_layers is not None and name == SCOUT:
            arch = arch.scaled(num_layers=num_layers)
        return Model(arch, device="cpu", dtype=dtype or torch.float32).init(
            torch.Generator().manual_seed(seed))

    flash = ref.flash_attention_ref
    if fault == "flash_not_causal":
        def flash(q, k, v, **kw):
            return ref.flash_attention_ref(q, k, v, causal=False)
    monkeypatch.setattr(chip_smoke, "_model", reduced)
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(nmod, "rms_norm", _counting(nmod, ref.rms_norm_ref))
    monkeypatch.setattr(fmod, "flash_attention", _counting(fmod, flash))
    monkeypatch.setattr(dmod, "decode_attention", ref.decode_attention_ref
                        if fault == "decode_uncounted"
                        else _counting(dmod, ref.decode_attention_ref))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **kw: 0)
    card = {"nvidia_smi": "cpu rehearsal"}
    if fails_on is not None:
        with pytest.raises(AssertionError, match=fails_on):
            chip_smoke.phase_moe(torch, card, 0)
        return
    launches = chip_smoke.phase_moe(torch, card, 0)
    assert launches[SCOUT]["flash_attention"] == \
        chip_smoke.MOE_LAYERS[SCOUT]
    assert launches[SCOUT]["decode_attention"] == \
        chip_smoke.MOE_LAYERS[SCOUT] * (chip_smoke.SERVE_NEW - 1)
    assert launches[MAVERICK] == {"flash_attention": 4, "decode_attention":
                                  4 * (chip_smoke.SERVE_NEW - 1),
                                  "ssd_scan": 0, "quant_matmul": 0,
                                  "ssd_step": 0, "rms_norm":
                                  (2 * 4 + 1) * chip_smoke.SERVE_NEW}
    out = capsys.readouterr().out
    for phase in ("moe_prefill", "moe_serve_drops", "profile_regions",
                  "moe"):
        assert f'"phase": "{phase}"' in out
