"""Sequence-parallel attention of the port against the JAX package's.

The flash-decode of a sequence-sharded cache (each shard's share,
``ref.decode_attention_partial_ref``, merged by ``ref.merge_partials`` as
``ops`` merges the ranks' shares with all-reduces) against the whole-cache
decode of both packages; the context-parallel prefill's rows at a global
offset (``ref.flash_attention_ref(q_offset=)``) against the whole causal
attention and the reference's ``layers.flash_attention`` with positions;
and the dry-run of the two reduced cells these paths change on a 2x4 mesh
of a ``fake`` group, against closed forms and against the reference's
compiled HLO of the same cells.  Inputs are made with numpy from seeds.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
# as tests/test_kernels.py:14-15
TOLS = {torch.float32: dict(rtol=2e-5, atol=2e-5),
        torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# shard boundaries of a 100-position cache: ragged lengths, none a
# multiple of another
BOUNDS = {2: (0, 37, 100), 3: (0, 30, 64, 100), 4: (0, 20, 45, 71, 100)}
KIB64 = 64 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, dtype, *shapes):
    """Torch tensors of ``dtype`` and the JAX arrays of the same values."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
          for s in shapes]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ts, [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


def _shares(q, k, v, cache_len, bounds):
    """Each shard's share of a decode step over ``cache_len`` positions."""
    return [ref.decode_attention_partial_ref(
        q, k[:, lo:hi], v[:, lo:hi], min(max(cache_len - lo, 0), hi - lo))
        for lo, hi in zip(bounds, bounds[1:])]


@pytest.mark.parametrize("G", (1, 5, 8))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("n", (2, 3, 4))
def test_merged_shares_equal_whole_cache_decode(n, dtype, G):
    """The shards' shares merged equal the whole-cache decode of the port
    and of the JAX package at every ``cache_len`` tried: in the first
    shard (the others empty), at a shard's last and first position, and
    mid-shard."""
    B, S, KV, hd = 2, 100, 2, 16
    bounds = BOUNDS[n]
    (q, k, v), (jq, jk, jv) = _inputs(n * 10 + G, dtype, (B, 1, KV * G, hd),
                                      (B, S, KV, hd), (B, S, KV, hd))
    lens = sorted({1, 7, S - 1, S} | {b for b in bounds[1:-1]}
                  | {b + 1 for b in bounds[1:-1]})
    for cache_len in lens:
        shares = _shares(q, k, v, cache_len, bounds)
        got = ref.merge_partials(torch.stack([o for o, _ in shares]),
                                 torch.stack([lse for _, lse in shares]))
        assert got.dtype == torch.float32
        got = got.to(dtype)
        mine = ref.decode_attention_ref(q, k, v, cache_len)
        theirs = jref.decode_attention_ref(jq, jk, jv, cache_len)
        np.testing.assert_allclose(_np(got), _np(mine), **TOLS[dtype])
        np.testing.assert_allclose(_np(got), _np(theirs), **TOLS[dtype])
        for (lo, hi), (o, lse) in zip(zip(bounds, bounds[1:]), shares):
            if cache_len <= lo:                    # an empty shard
                assert torch.equal(o, torch.zeros_like(o))
                assert torch.isneginf(lse).all()


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("fp32", "bf16"))
def test_share_lse_is_the_shards_log_sum_exp(dtype):
    """A share's ``lse`` is the log-sum-exp of the scaled scores over the
    shard's valid positions, and its ``o`` the softmax over them alone."""
    B, S, KV, G, hd = 3, 40, 2, 4, 16
    (q, k, v), _ = _inputs(7, dtype, (B, 1, KV * G, hd), (B, S, KV, hd),
                           (B, S, KV, hd))
    for valid in (1, 17, 40):
        o, lse = ref.decode_attention_partial_ref(q, k, v, valid)
        qf = q.float()[:, 0].reshape(B, KV, G, hd) * hd ** -0.5
        s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()[:, :valid])
        np.testing.assert_allclose(lse.numpy(),
                                   torch.logsumexp(s, -1).reshape(B, -1),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            o.numpy(), ref.decode_attention_ref(
                q.float(), k.float(), v.float(), valid).numpy(),
            rtol=1e-6, atol=1e-6)


def test_merge_of_empty_shares_is_zero_not_nan():
    """``exp(-inf - (-inf))`` does not arise: a row whose every shard is
    empty merges to 0, and an empty shard beside a full one weighs 0."""
    o = torch.randn(3, 2, 1, 4, 8)
    lse = torch.full((3, 2, 4), -float("inf"))
    assert torch.equal(ref.merge_partials(o * 0, lse),
                       torch.zeros(2, 1, 4, 8))
    lse[1] = 0.5
    got = ref.merge_partials(torch.cat([o[:1] * 0, o[1:2], o[2:] * 0]), lse)
    np.testing.assert_allclose(got.numpy(), o[1].numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("fp32", "bf16"))
@pytest.mark.parametrize("n", (2, 4))
def test_rows_at_offset_equal_rows_of_whole_attention(n, dtype):
    """Each block of query rows at its global offset against the whole
    K/V (a rank of a context-parallel prefill) equals those rows of the
    whole causal attention, of the port's and of the reference's
    ``layers.flash_attention(q, kr, vr, positions, positions)``; the CPU
    path of ``ops.flash_attention`` takes the offset too."""
    B, S, H, KV, hd = 2, 64, 8, 2, 16
    (q, k, v), (jq, jk, jv) = _inputs(n, dtype, (B, S, H, hd),
                                      (B, S, KV, hd), (B, S, KV, hd))
    whole = ref.flash_attention_ref(q, k, v)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    theirs = jlayers.flash_attention(
        jq, jlayers.repeat_kv(jk, H // KV), jlayers.repeat_kv(jv, H // KV),
        pos, pos, causal=True)
    rows = S // n
    for r in range(n):
        lo, hi = r * rows, (r + 1) * rows
        got = ref.flash_attention_ref(q[:, lo:hi], k, v, q_offset=lo)
        assert torch.equal(got, whole[:, lo:hi])
        np.testing.assert_allclose(_np(got), _np(theirs[:, lo:hi]),
                                   **TOLS[dtype])
        assert torch.equal(ops.flash_attention(q[:, lo:hi], k, v,
                                               q_offset=lo), got)
    assert torch.equal(ref.flash_attention_ref(q, k, v, q_offset=0), whole)


def test_partial_wrapper_on_the_cpu():
    """``ops.decode_attention_partial`` runs the plain share on CPU
    tensors; the CUDA wrapper refuses them, before anything is built."""
    (q, k, v), _ = _inputs(3, torch.float32, (2, 1, 4, 64), (2, 32, 2, 64),
                           (2, 32, 2, 64))
    for valid in (0, 9):
        got = ops.decode_attention_partial(q, k, v, valid)
        want = ref.decode_attention_partial_ref(q, k, v, valid)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="one CUDA device"):
        dmod.decode_attention_partial(q, k, v, 9)


# ---------------------------------------------------------------------------
# the dry-run of the two reduced cells on a 2x4 mesh
MESH = (("data", 2), ("model", 4))
CELLS = {"qwen2-7b": ShapeConfig("d", 64, 8, "decode"),
         "gemma-2b": ShapeConfig("p", 64, 8, "prefill")}


def _count(name: str, gathered: bool = False, monkeypatch=None):
    """The port's per-rank count of a reduced cell; ``gathered`` counts
    the path that gathers the sequence instead (the port before its
    sequence-parallel attention)."""
    if gathered:
        monkeypatch.setattr(ops, "_seq_dims", lambda *a: ())
    arch = ARCHS[name].reduced()
    with dryrun.fake_world(8):
        fn, args, policy = dryrun.build_step(
            arch, CELLS[name], make_host_mesh(MESH, device_type="cuda"))
        counted = dryrun.count_step(fn, args)
    if gathered:
        monkeypatch.undo()
    return arch, policy, counted


def test_reduced_decode_moves_no_cache(monkeypatch):
    """Reduced qwen2-7b decode (S 64, B 8) on 2x4: the cache's sequence
    is sharded four ways and no all-gather of the step comes near one
    layer's gathered cache; the all-reduces are the gathering path's plus
    the merge's closed form: per layer, the max of the log-sum-exps [B_l,
    H] and one sum of the weights and weighted outputs [B_l, H, hd + 1],
    fp32, each counted at twice its operand."""
    arch, policy, seq = _count("qwen2-7b")
    _, _, gathered = _count("qwen2-7b", True, monkeypatch)
    assert policy.rules["cache_seq"] == ("model",)
    L, H, KV, hd = (arch.num_layers, arch.num_heads, arch.num_kv_heads,
                    arch.head_dim)
    B_l, S = 8 // 2, 64
    layer_cache = B_l * S * KV * hd * 2           # one of K, V; bf16
    assert seq["collectives"]["all-gather"] < layer_cache
    assert gathered["collectives"]["all-gather"] >= 2 * L * layer_cache
    merge = L * 2 * 4 * (B_l * H + B_l * H * (hd + 1))
    assert seq["collectives"]["all-reduce"] == \
        gathered["collectives"]["all-reduce"] + merge
    # each rank scores its quarter of the cache
    S_l = S // 4
    assert seq["flops"] == gathered["flops"] - L * 4 * B_l * H * hd * (S - S_l)


def test_reduced_context_prefill_counts_local_rows(monkeypatch):
    """Reduced gemma-2b prefill (S 64, B 8) on 2x4, context mode: every
    rank attends its S_l = 16 query rows against all 64 keys.  The plain
    count holds S_l x S score pairs a rank (the gathering path's S x S
    less the rest), and the kernel path the busiest rank's causal pairs,
    the last shard's S_l (S - S_l) + S_l (S_l + 1) / 2."""
    from repro_torch.kernels import ref as tref
    calls = []
    plain = tref.flash_attention_ref

    def record(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("q_offset")))
        return plain(q, k, v, **kw)

    record.__name__ = plain.__name__
    monkeypatch.setattr(tref, "flash_attention_ref", record)
    arch, policy, seq = _count("gemma-2b")
    monkeypatch.setattr(tref, "flash_attention_ref", plain)
    _, _, gathered = _count("gemma-2b", True, monkeypatch)
    assert policy.attn_mode == "context"
    L, H, hd = arch.num_layers, arch.num_heads, arch.head_dim
    B_l, S, S_l = 8 // 2, 64, 64 // 4
    assert calls == [(S_l, S, 0)] * L               # rank 0's rows
    per_pair = 4 * B_l * H * hd * L
    assert seq["flops"] == gathered["flops"] - per_pair * (S - S_l) * S
    busiest = S_l * (S - S_l) + S_l * (S_l + 1) // 2
    assert seq["kernel_path"]["flops"] == gathered["kernel_path"][
        "flops"] - per_pair * (S * (S + 1) // 2 - busiest)
    assert seq["memory"]["peak_memory_in_bytes"] < \
        gathered["memory"]["peak_memory_in_bytes"]


REFERENCE = """
    import json
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.configs.shapes import ShapeConfig
    from repro.launch.dryrun import build_step, parse_collective_bytes
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for name, shape in (("qwen2-7b", ShapeConfig("d", 64, 8, "decode")),
                        ("gemma-2b", ShapeConfig("p", 64, 8, "prefill"))):
        fn, args, _ = build_step(get_arch(name).reduced(), shape, mesh)
        out[name] = parse_collective_bytes(fn.lower(*args).compile().as_text())
    print("RESULT" + json.dumps(out))
"""


def test_reduced_cells_move_what_the_reference_moves():
    """The reference's same two cells, compiled on 8 host devices (its
    axes ``Auto``: jax's default explicit axes refuse its sharding
    constraints), against the port's count: every kind of collective
    either within 4x of the reference's bytes or at most 64 KiB (the
    gemma cell's all-reduce is the embedding lookup's pending sum over
    the vocab shards, 2 x 32 KiB, where XLA gathers the 64 KiB table)."""
    env = {**os.environ, "PYTHONPATH": SRC,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("RESULT"))
    theirs = json.loads(line[len("RESULT"):])
    for name in CELLS:
        mine = _count(name)[2]["collectives"]
        for kind in set(mine) | set(theirs[name]):
            got, want = mine.get(kind, 0.0), theirs[name].get(kind, 0.0)
            assert got <= KIB64 or want / 4 <= got <= 4 * want, (
                name, kind, got, want)


# ---------------------------------------------------------------------------
# chip_smoke's seqpar phase, rehearsed on the CPU
@pytest.fixture
def seqpar_phase(monkeypatch):
    """``chip_smoke.phase_seqpar`` on a reduced qwen2-7b on the CPU: the
    kernel wrappers replaced by counting plain versions (``ops._on_cuda``
    forced; the partial counts only a shard it launches for), the CUDA
    synchronize stubbed.  Yields a runner taking the partial's stand-in."""
    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.models import Model

    def counting(mod, attr, plain, counts=lambda *a: True):
        def launch(*args, **kw):
            if counts(*args):
                setattr(mod, attr, getattr(mod, attr) + 1)
            return plain(*args, **kw)
        return launch

    def partial(plain, counts=lambda q, k, v, n: n > 0):
        return counting(dmod, "partial_launches", plain, counts)

    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(fmod, "flash_attention",
                        counting(fmod, "launches", ref.flash_attention_ref))
    monkeypatch.setattr(dmod, "decode_attention",
                        counting(dmod, "launches", ref.decode_attention_ref))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    model = Model(ARCHS["qwen2-7b"].reduced(), device="cpu",
                  dtype=torch.float32).init(torch.Generator().manual_seed(0))

    def run(share=partial(ref.decode_attention_partial_ref)):
        monkeypatch.setattr(dmod, "decode_attention_partial", share)
        return chip_smoke.phase_seqpar(
            torch, {"nvidia_smi": "cpu rehearsal"}, model)
    run.partial = partial
    return run


def test_chip_smoke_seqpar_phase_rehearsal(seqpar_phase, capsys):
    """Four shards of the 1024-position cache at cache_len 513..528:
    shards 0 and 1 full, 2 partly filled, 3 empty, so 3 partial launches
    a layer and step; 4 flash launches a layer; the logits those of the
    whole sequence."""
    got = seqpar_phase()
    layers = ARCHS["qwen2-7b"].reduced().num_layers
    assert got == {"flash_attention": 4 * layers, "decode_attention": 0,
                   "decode_attention_partial": 3 * 16 * layers}
    phase = next(r for r in map(json.loads,
                                capsys.readouterr().out.splitlines())
                 if r.get("phase") == "seqpar")
    assert phase["logits_rel_err"] < 1e-5 and phase["top1_agreement"] == 1


def test_chip_smoke_seqpar_phase_fails_on_a_wrong_share(seqpar_phase):
    """A partial kernel that counts an empty shard as a launch, and one
    whose log-sum-exp is wrong (every shard weighed alike), each fail the
    phase."""
    with pytest.raises(AssertionError, match="seqpar: launches"):
        seqpar_phase(seqpar_phase.partial(ref.decode_attention_partial_ref,
                                          lambda *a: True))

    def flat(*args, **kw):
        o, lse = ref.decode_attention_partial_ref(*args, **kw)
        return o, torch.where(torch.isinf(lse), lse, torch.zeros_like(lse))
    with pytest.raises(AssertionError, match="rel err"):
        seqpar_phase(seqpar_phase.partial(flat))
