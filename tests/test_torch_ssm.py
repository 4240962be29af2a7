"""The port's Mamba2 SSM and Zamba2 hybrid families against the JAX package.

On the CPU, in fp32, on inputs made with numpy: the SSD's plain versions
(``ref.ssd_scan_ref``, ``ref.ssd_ref``) against the JAX oracle, the JAX
dual form and the Pallas kernel in interpret mode; the Mamba2 block; the
reduced mamba2-130m and zamba2-7b models and their serving engines against
the JAX ``Model(attn_impl="pallas", ssd_impl="pallas")`` on converted
weights.  On a card (``gpu`` marker): the CUDA SSD scan and the hd-112
attention instances against their plain versions.
"""
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as smod  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

SSM_ARCHS = ["mamba2-130m", "zamba2-7b"]
SSD_TOL = dict(rtol=2e-3, atol=2e-3)     # as tests/test_kernels.py:74-77
REL_TOL = 1e-4                           # as tests/test_models_smoke.py:84


@pytest.fixture(scope="module")
def jx():
    """The JAX reference.  Imported here, not at the top, so that the
    ``gpu`` tests also run where only the card's stack (torch, no jax) is
    installed."""
    jax = pytest.importorskip("jax")
    from repro.configs import ARCHS as archs
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_scan_pallas
    from repro.models import Model as JaxModel
    from repro.models import ssm as jssm
    from repro.serving.engine import Engine as JaxEngine
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    from repro.sharding.policy import ShardingPolicy
    return SimpleNamespace(
        jax=jax, jnp=jax.numpy, ARCHS=archs, ref=jref, pallas=ssd_scan_pallas,
        ssm=jssm, Model=JaxModel, Engine=JaxEngine,
        EngineConfig=JaxEngineConfig, policy=ShardingPolicy(mesh=None))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread is enough, and keeps
    this file from crowding the tests that run beside it in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(seed, B, S, nh, hd, ds):
    """x, dt (softplus'd), A (< 0), Bm, Cm as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, nh)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk", [
    (1, 128, 2, 32, 64, 64),
    (2, 256, 3, 64, 128, 128),   # mamba2-130m geometry
    (1, 192, 4, 16, 32, 64),     # uneven chunk count
    (2, 37, 3, 16, 32, 16),      # prime S: the reference's chunk shrinks to 1
])
def test_ssd_plain_matches_jax(jx, B, S, nh, hd, ds, chunk):
    """The dual form and the sequential recurrence of the port against the
    JAX oracle, the JAX dual form and the Pallas kernel (interpret)."""
    arrs = _ssd_inputs(S, B, S, nh, hd, ds)
    want_y, want_s = jx.jax.jit(jx.ref.ssd_ref)(*arrs)
    others = [jx.jax.jit(partial(jx.ssm.ssd_chunked, chunk=chunk))(*arrs),
              jx.jax.jit(partial(jx.pallas, chunk=chunk,
                              interpret=True))(*arrs)]
    got = [ref.ssd_scan_ref(*_t(*arrs), chunk=chunk), ref.ssd_ref(*_t(*arrs)),
           ops.ssd_scan(*_t(*arrs), chunk=chunk)]
    for y, s in got:
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **SSD_TOL)
    for y, s in others:     # the port's dual form vs the JAX package's
        np.testing.assert_allclose(got[0][0].numpy(), np.asarray(y),
                                   **SSD_TOL)
        np.testing.assert_allclose(got[0][1].numpy(), np.asarray(s),
                                   **SSD_TOL)


def test_ssd_plain_carries_init_state(jx):
    """One scan split in two with the state carried == the whole scan, and
    == the Pallas kernel's split (tests/test_kernels.py:81-100)."""
    B, S, nh, hd, ds = 1, 128, 2, 16, 32
    arrs = _ssd_inputs(3, B, S, nh, hd, ds)
    x, dt, A, Bm, Cm = _t(*arrs)
    want_y, want_s = jx.jax.jit(jx.ref.ssd_ref)(*arrs)
    half = S // 2
    for plain in (ref.ssd_scan_ref, ref.ssd_ref):
        kw = {"chunk": 32} if plain is ref.ssd_scan_ref else {}
        y1, s1 = plain(x[:, :half], dt[:, :half], A, Bm[:, :half],
                       Cm[:, :half], **kw)
        y2, s2 = plain(x[:, half:], dt[:, half:], A, Bm[:, half:],
                       Cm[:, half:], init_state=s1, **kw)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                                   np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(s2.numpy(), np.asarray(want_s), **SSD_TOL)
    p1 = jx.jax.jit(partial(jx.pallas, chunk=32, interpret=True))(
        *(a[:, :half] if a.ndim > 1 else a for a in arrs))[1]
    np.testing.assert_allclose(s1.numpy(), np.asarray(p1), **SSD_TOL)


def _model_like_ssd(seed, B, S, nh, hd, ds):
    """float64 SSD inputs as a Mamba2 layer makes them: SiLU'd x, B, C;
    dt = softplus(N(0, 1)); A from -1 to -16 over the heads."""
    rng = np.random.default_rng(seed)
    silu = lambda a: a / (1 + np.exp(-a))                     # noqa: E731
    x = silu(rng.standard_normal((B, S, nh, hd)))
    dt = np.logaddexp(rng.standard_normal((B, S, nh)), 0)
    A = -np.linspace(1.0, 16.0, nh)
    Bm, Cm = (silu(rng.standard_normal((B, S, ds))) for _ in range(2))
    return [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_dual_form_matches_float64_recurrence(chunk):
    """With A down to -16 the cumulative log-decay of a chunk reaches
    about -1000; summed in fp32 its rounding alone leaves y ~1e-5 of its
    largest value off.  The dual form sums it in float64 and lands where
    an fp32 recurrence does (~1e-7)."""
    args64 = _model_like_ssd(9, 1, 256, 8, 16, 32)
    want = ref.ssd_ref(*args64)
    for got in (ref.ssd_scan_ref(*(a.float() for a in args64), chunk=chunk),
                ops.ssd_scan(*(a.float() for a in args64), chunk=chunk)):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            err = float((g.double() - w).abs().max() / w.abs().max())
            assert err < 1e-6, err


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_hd_slices_concatenate_to_whole(with_init):
    """y[..., p] and the state's row p depend on x[..., p] only (C B^T and
    L are shared by every p): the plain dual form run on slices of hd, as
    the kernel's blocks split it, and concatenated equals the whole run,
    for y and the final state, with and without an initial state."""
    B, S, nh, hd, ds = 2, 200, 3, 64, 32
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(12, B, S, nh, hd, ds))
    s0 = (torch.from_numpy(np.random.default_rng(13).standard_normal(
        (B, nh, hd, ds)).astype(np.float32)) if with_init else None)
    want_y, want_s = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=64,
                                      init_state=s0)
    for P in (16, 32):
        parts = [ref.ssd_scan_ref(
            x[..., p:p + P].contiguous(), dt, A, Bm, Cm, chunk=64,
            init_state=None if s0 is None else s0[:, :, p:p + P].contiguous())
            for p in range(0, hd, P)]
        assert torch.equal(torch.cat([y for y, _ in parts], -1), want_y)
        assert torch.equal(torch.cat([st for _, st in parts], 2), want_s)


def test_slice_plan():
    """The wrapper's hd slices: at least 16 wide, dividing hd, split only
    while the blocks are fewer than BLOCKS_PER_SM per SM."""
    sms = 132
    assert smod.slice_plan(8, 24, 64, 128, sms) == 32      # mamba2-130m: 384 blocks
    assert smod.slice_plan(8, 112, 64, 64, sms) == 64     # zamba2-7b: 896 blocks
    assert smod.slice_plan(1, 4, 64, 64, sms) == 16
    assert smod.slice_plan(1, 4, 16, 128, sms) == 16
    for B, nh, hd in ((1, 1, 32), (2, 3, 64), (8, 200, 16), (16, 8, 64)):
        P = smod.slice_plan(B, nh, hd, 64, sms)
        assert P >= smod.MIN_SLICE and hd % P == 0
        if P < hd:
            assert B * nh * (hd // P) // 2 < smod.BLOCKS_PER_SM * sms
    # ds 128: at most 32 wide whatever the block count (shared memory)
    assert smod.slice_plan(32, 24, 64, 128, sms) == smod.MAX_SLICE_DS128
    assert smod.slice_plan(32, 24, 64, 64, sms) == 64
    with pytest.raises(ValueError):
        smod.slice_plan(0, 4, 64, 64, sms)


SSD_F64_TOL = 2e-6     # chip_smoke.py: the SSD against float64, relative


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernel's cvt.rna.tf32.f32 rounds."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel forms it: hi.hi + (hi.lo + lo.hi), each operand
    split into hi = tf32(v) and lo = tf32(v - hi); lo.lo is dropped."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _ssd_chunks(x, dt, A, Bm, Cm, mm, Q=64):
    """The kernel's decomposition in plain fp32 with its four products
    through ``mm``: 64-row chunks (the ragged last one shorter), cs summed
    in float64, G = (C B^T) o L, y = G (x dt) + exp(cs) (C state^T), state =
    exp(cs_last) state + (x dt w)^T B with w = exp(cs_last - cs)."""
    B_, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    state = torch.zeros(B_, nh, hd, ds)
    ys = []
    for c0 in range(0, S, Q):
        r = min(Q, S - c0)
        xc, dtc = x[:, c0:c0 + r], dt[:, c0:c0 + r]
        Bc, Cc = Bm[:, c0:c0 + r], Cm[:, c0:c0 + r]
        cs = torch.cumsum(dtc.double() * A.double(), 1).movedim(1, 2)
        diff = cs[..., :, None] - cs[..., None, :]           # [B,nh,r,r]
        L = torch.where(torch.ones(r, r, dtype=torch.bool).tril(),
                        torch.exp(diff.float()), torch.zeros(()))
        G = mm(Cc, Bc.transpose(1, 2))[:, None] * L
        xdt = (xc * dtc[..., None]).movedim(1, 2)             # [B,nh,r,hd]
        y = (mm(G, xdt) + torch.exp(cs.float())[..., None]
             * mm(Cc[:, None], state.transpose(2, 3)))
        ys.append(y.movedim(2, 1))
        w = torch.exp((cs[..., -1:] - cs).float()) * dtc.movedim(1, 2)
        state = (state * torch.exp(cs[..., -1].float())[..., None, None]
                 + mm((xc.movedim(1, 2) * w[..., None]).transpose(2, 3),
                      Bc[:, None]))
    return torch.cat(ys, 1), state


def test_ssd_3xtf32_meets_the_float64_limit_where_tf32_does_not():
    """Why the kernel takes three TF32 passes a product: its decomposition
    with 3xTF32 products stays within 2e-6 (relative to the largest value)
    of the float64 recurrence, as with exact fp32 products; one TF32 pass
    (10 mantissa bits, ~5e-4) reads far above that limit."""
    args64 = _model_like_ssd(14, 1, 200, 4, 16, 32)
    want = ref.ssd_ref(*args64)
    args = [a.float() for a in args64]

    def rel(got):
        return max(float((g.double() - w).abs().max() / w.abs().max())
                   for g, w in zip(got, want))

    exact = rel(_ssd_chunks(*args, mm=torch.matmul))
    three = rel(_ssd_chunks(*args, mm=_mm_3xtf32))
    one = rel(_ssd_chunks(*args, mm=_mm_1xtf32))
    assert exact < SSD_F64_TOL and three < SSD_F64_TOL, (exact, three)
    assert one > 10 * SSD_F64_TOL, one
    v = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11)])
    assert _tf32(v).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -9,
                                 -(1.0 + 2 ** -10)]


def test_ssd_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; only ``ops`` picks the plain
    version, and only for a CPU tensor."""
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(4, 1, 8, 2, 16, 16))
    before = smod.launches
    with pytest.raises(ValueError, match="CUDA"):
        smod.ssd_scan(x, dt, A, Bm, Cm)
    with pytest.raises(TypeError, match="float32"):
        smod.ssd_scan(x.double(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="head_dim"):
        smod.ssd_scan(x[..., :8], dt, A, Bm, Cm)
    assert smod.launches == before
    with pytest.raises(ValueError, match="no kernel path"):
        ops.ssd_scan(*(t.to("meta") for t in (x, dt, A, Bm, Cm)))


# ---------------------------------------------------------------------------
def _numpy_params(jx, jm, seed):
    """The JAX model's parameter tree (its shapes and dtypes) filled from a
    numpy generator, which costs none of the seconds of compilation that
    ``jm.init`` takes per arch: fan-in scaled normals for projections and
    convs, small noise on norms, biases and ``D - 1``, and ``A_log`` around
    the reference's log-spaced init."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        per = shape[1:] if path[0].key in ("blocks", "shared_attn") else shape
        x = rng.standard_normal(shape)
        if name == "embed":
            x *= 0.02
        elif name in ("wo", "wd"):
            x *= (np.prod(per) / per[-1]) ** -0.5
        elif len(per) >= 2:
            x *= per[0] ** -0.5
        else:
            x *= 0.1
        if name == "A_log":
            x += np.log(np.linspace(1.0, 16.0, per[-1]))
        elif name == "D":
            x += 1.0
        return x.astype(leaf.dtype)

    return jx.jax.tree_util.tree_map_with_path(
        fill, jx.jax.eval_shape(jm.init, jx.jax.random.key(0)))


@pytest.fixture(scope="module")
def converted(jx):
    """name -> (JAX model on the Pallas kernels, its params, the port's
    model with the same weights); reduced archs in fp32."""
    cache = {}

    def get(name):
        if name not in cache:
            jm = jx.Model(jx.ARCHS[name].reduced(), jx.policy,
                          param_dtype=jx.jnp.float32, attn_impl="pallas",
                          ssd_impl="pallas")
            params = _numpy_params(jx, jm, 0)
            arch = ARCHS[name].reduced()
            m = Model(arch, device="cpu", dtype=torch.float32)
            m.load_state_dict(from_jax_params(arch, params))
            cache[name] = (jm, params, m)
        return cache[name]
    return get


def _tokens(arch, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, arch.vocab_size, size=(B, S)).astype(np.int32)


def test_ssm_block_matches_jax(jx, converted):
    """One Mamba2 block, full sequence then one decode step, on layer 1's
    weights: output, SSD state and the pre-activation conv tails."""
    jm, params, m = converted("mamba2-130m")
    arch, jarch = m.arch, jm.arch
    p_j = jx.jax.tree.map(lambda a: a[1], params["blocks"])
    full = jx.jax.jit(lambda h, p: jx.ssm.ssm_block_full(h, p, jarch,
                                                          jm.policy))
    decode = jx.jax.jit(lambda h, p, st: jx.ssm.ssm_block_decode(
        h, p, jarch, jm.policy, st))
    rng = np.random.default_rng(5)
    for S in (9, 2):                  # S < cw - 1 left-pads the tails
        h = rng.standard_normal((2, S, arch.d_model)).astype(np.float32)
        step = rng.standard_normal((2, 1, arch.d_model)).astype(np.float32)
        out_j, st_j = full(jx.jnp.asarray(h), p_j)
        out, st = tssm.ssm_block_full(torch.from_numpy(h), m.blocks[1], arch)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **SSD_TOL)
        for a, b in zip(st, st_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **SSD_TOL)
        dout_j, dst_j = decode(jx.jnp.asarray(step), p_j, st_j)
        dout, dst = tssm.ssm_block_decode(torch.from_numpy(step),
                                          m.blocks[1], arch, st)
        np.testing.assert_allclose(dout.numpy(), np.asarray(dout_j),
                                   **SSD_TOL)
        for a, b in zip(dst, dst_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **SSD_TOL)


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_forward_prefill_decode_match_jax(jx, name, converted):
    """forward, prefill (with the KV caches padded to max_seq) and three
    decode steps against the JAX model on its Pallas kernels."""
    jm, params, m = converted(name)
    B, S, extra = 2, 11, 3
    tokens = _tokens(m.arch, B, S + extra, seed=2)
    want = np.asarray(jx.jax.jit(jm.forward)(params, jx.jnp.asarray(tokens)))
    got = m.forward(torch.from_numpy(tokens).long()).numpy()
    assert got.shape == want.shape and _rel_err(got, want) < REL_TOL

    jl, jc = jx.jax.jit(partial(jm.prefill, max_seq=S + extra))(
        params, jx.jnp.asarray(tokens[:, :S]))
    jdecode = jx.jax.jit(jm.decode_step)
    tl, tc = m.prefill(torch.from_numpy(tokens[:, :S]).long(),
                       max_seq=S + extra)
    assert _rel_err(tl.numpy(), np.asarray(jl)) < REL_TOL
    assert len(tc["ssm"]) == m.arch.num_layers
    if name == "zamba2-7b":
        assert len(tc["k"]) == len(m.hybrid_groups) == jc["k"].shape[0]
        assert tc["k"][0].shape == tuple(jc["k"].shape[1:])
    else:
        assert "k" not in tc
    for i in range(extra):
        tok = tokens[:, S + i:S + i + 1]
        jl, jc = jdecode(params, jc, jx.jnp.int32(S + i),
                         jx.jnp.asarray(tok))
        tl, tc = m.decode_step(tc, S + i, torch.from_numpy(tok).long())
        assert _rel_err(tl[:, 0].numpy(), np.asarray(jl)[:, 0]) < REL_TOL
        assert _rel_err(tl[:, 0].numpy(), got[:, S + i]) < REL_TOL
    for st, layer in ((tc["ssm"][0], 0), (tc["ssm"][-1], -1)):
        np.testing.assert_allclose(st.ssd.numpy(),
                                   np.asarray(jc["ssm"].ssd[layer]),
                                   **SSD_TOL)


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_generate_token_exact_vs_jax(jx, name, converted):
    """Greedy tokens equal the JAX engine's on prompts of unequal length,
    left-padded with token 0 as the Batcher pads them (the SSM state
    integrates the pads in both)."""
    jm, params, m = converted(name)
    cfg = dict(max_batch=4, max_seq=32)
    lens = (5, 12, 9)
    prompts = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        prompts[i, max(lens) - n:] = _tokens(m.arch, 1, n, seed=10 + i)[0]
    want = jx.Engine(jm, params, jx.EngineConfig(**cfg)).generate(
        prompts, max_new=6)
    got = Engine(m, EngineConfig(**cfg)).generate(prompts, max_new=6)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_from_jax_params_round_trips(jx, name):
    """bf16 JAX params (the dtypes ``jm.init`` gives) convert key for key
    and bit for bit, with ``A_log`` and ``dt_bias`` kept fp32; the shared
    block is ``shared_attn.*``."""
    jm = jx.Model(jx.ARCHS[name].reduced(), jx.policy,
                  param_dtype=jx.jnp.bfloat16)
    params = _numpy_params(jx, jm, 1)
    arch = ARCHS[name].reduced()
    m = Model(arch, device="cpu", dtype=torch.bfloat16)
    sd = from_jax_params(arch, params)
    m.load_state_dict(sd)                 # strict: the same keys and shapes
    assert m.blocks[0].A_log.dtype == torch.float32
    assert m.blocks[0].dt_bias.dtype == torch.float32
    assert m.blocks[0].wx.dtype == torch.bfloat16
    L = arch.num_layers
    assert np.array_equal(sd[f"blocks.{L - 1}.A_log"].numpy(),
                          params["blocks"]["A_log"][L - 1])
    assert np.array_equal(sd["blocks.0.wz"].float().numpy(),
                          params["blocks"]["wz"][0].astype(np.float32))
    if name == "zamba2-7b":
        assert np.array_equal(sd["shared_attn.wq"].float().numpy(),
                              params["shared_attn"]["wq"][0].astype(
                                  np.float32))
    else:
        assert "lm_head" not in sd        # tied to embed.T


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_full_width_on_meta_device(jx, name):
    """Full widths build on the meta device: exactly the JAX init's number
    of parameters (``ArchConfig.param_count`` counts the SSM families' norms
    more than once, in both packages), fp32 ``A_log``, and zamba2's 14
    shared-attention groups of 6 layers (the last of 3)."""
    arch = get_arch(name)
    m = Model(arch, device="meta")
    jm = jx.Model(jx.ARCHS[name], jx.policy)
    want = sum(int(np.prod(x.shape)) for x in jx.jax.tree.leaves(
        jx.jax.eval_shape(jm.init, jx.jax.random.key(0))))
    assert sum(p.numel() for p in m.parameters()) == want
    assert m.blocks[0].A_log.dtype == torch.float32
    assert m.blocks[0].wx.dtype == torch.bfloat16
    if name == "zamba2-7b":
        groups = m.hybrid_groups
        assert len(groups) == 14 and groups[0] == (0, 6)
        assert groups[-1] == (78, 81)
        assert m.shared_attn.wq.shape == (3584, 32, 112)
    else:
        assert m.blocks[0].wx.shape == (768, 24, 64)


def test_init_sets_reference_constants():
    """Random init keeps the reference's A_log, D and dt_bias."""
    m = Model(ARCHS["mamba2-130m"].reduced(), device="cpu",
              dtype=torch.float32).init(torch.Generator().manual_seed(0))
    blk = m.blocks[0]
    nh = blk.A_log.shape[0]
    np.testing.assert_allclose(blk.A_log.numpy(),
                               np.log(np.linspace(1.0, 16.0, nh)), rtol=1e-6)
    assert torch.equal(blk.D, torch.ones(nh))
    assert torch.equal(blk.dt_bias, torch.zeros(nh))
    assert blk.wx.std() > 0 and torch.equal(blk.ssm_norm,
                                            torch.zeros_like(blk.ssm_norm))


# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ssd_kernel_matches_plain_on_gpu():
    dev = _cuda()
    for (B, S, nh, hd, ds) in [(2, 474, 4, 64, 64), (1, 37, 3, 16, 128),
                               (2, 257, 2, 64, 128), (1, 64, 2, 32, 16)]:
        x, dt, A, Bm, Cm = (t.to(dev) for t in _t(*_ssd_inputs(
            6, B, S, nh, hd, ds)))
        n = smod.launches
        y, fin = smod.ssd_scan(x, dt, A, Bm, Cm)
        assert smod.launches == n + 1
        for want_y, want_s in (ref.ssd_scan_ref(x, dt, A, Bm, Cm),
                               ref.ssd_ref(x, dt, A, Bm, Cm)):
            np.testing.assert_allclose(y.cpu().numpy(),
                                       want_y.cpu().numpy(), **SSD_TOL)
            np.testing.assert_allclose(fin.cpu().numpy(),
                                       want_s.cpu().numpy(), **SSD_TOL)
        half = S // 2
        _, s1 = smod.ssd_scan(x[:, :half], dt[:, :half], A, Bm[:, :half],
                              Cm[:, :half])
        y2, s2 = smod.ssd_scan(x[:, half:], dt[:, half:], A, Bm[:, half:],
                               Cm[:, half:], init_state=s1)
        np.testing.assert_allclose(y2.cpu().numpy(),
                                   y[:, half:].cpu().numpy(), **SSD_TOL)
        np.testing.assert_allclose(s2.cpu().numpy(), fin.cpu().numpy(),
                                   **SSD_TOL)


@pytest.mark.gpu
def test_ssd_kernel_ragged_chunk_state_is_exact_on_gpu():
    """The state leaving a ragged last chunk (S = 4 * 64 + 44) carries no
    more rounding than a whole chunk's: its weight of the last row is
    exactly 1.  Model-like inputs (A in [-16, -1]); the oracle is the
    recurrence in float64."""
    dev = _cuda()
    args64 = _model_like_ssd(8, 2, 300, 8, 64, 64)
    _, state = ref.ssd_ref(*args64)
    assert state.dtype == torch.float64
    _, fin = smod.ssd_scan(*(a.float().to(dev) for a in args64))
    err = (fin.cpu().double() - state).abs().max() / state.abs().max()
    assert float(err) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("S", [474, 37])
def test_ssd_kernel_matches_float64_recurrence_on_gpu(S):
    """y and the final state within 2e-6 of their largest value of the
    recurrence in float64, at the model's range of A: the kernel sums the
    cumulative log-decay in fp64 (in fp32 it read ~1e-5)."""
    dev = _cuda()
    args64 = _model_like_ssd(10, 2, S, 8, 64, 64)
    want = ref.ssd_ref(*args64)
    got = smod.ssd_scan(*(a.float().to(dev) for a in args64))
    for g, w in zip(got, want):
        err = float((g.cpu().double() - w).abs().max() / w.abs().max())
        assert err < 2e-6, err


@pytest.mark.gpu
@pytest.mark.parametrize("nh,ds", [(24, 128), (112, 64)])
def test_ssd_kernel_at_serving_head_counts_on_gpu(nh, ds):
    """mamba2-130m's and zamba2-7b's head counts and state dims (at B 2
    the wrapper's hd slices of 16 and 32), a ragged S and an initial state:
    within 2e-3 of the plain dual form and the recurrence, and within 2e-6
    (relative to the largest value) of the recurrence in float64."""
    dev = _cuda()
    B, S, hd = 2, 200, 64
    args64 = _model_like_ssd(15, B, S, nh, hd, ds)
    s0 = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (B, nh, hd, ds)) * 0.1)
    got = smod.ssd_scan(*(a.float().to(dev) for a in args64),
                        init_state=s0.float().to(dev))
    args = [a.float() for a in args64]
    for plain in (ref.ssd_scan_ref, ref.ssd_ref):
        for g, w in zip(got, plain(*args, init_state=s0.float())):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **SSD_TOL)
    for g, w in zip(got, ref.ssd_ref(*args64, init_state=s0)):
        err = float((g.cpu().double() - w).abs().max() / w.abs().max())
        assert err < SSD_F64_TOL, err


@pytest.mark.gpu
@pytest.mark.parametrize("P,ds", [(16, 128), (32, 128), (16, 64), (32, 64),
                                  (64, 64), (64, 16), (32, 32)])
def test_ssd_kernel_every_slice_width_on_gpu(monkeypatch, P, ds):
    """Each slice width of hd the kernel is built for, forced through the
    wrapper (at P <= 32 its warpgroups split y's K and add the halves, at
    P 64 they split y's columns), with a ragged S and an initial state:
    within 2e-3 of the plain dual form and 2e-6 of float64."""
    dev = _cuda()
    monkeypatch.setattr(smod, "slice_plan", lambda *args: P)
    B, S, nh, hd = 2, 200, 3, 64
    args64 = _model_like_ssd(17, B, S, nh, hd, ds)
    s0 = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (B, nh, hd, ds)) * 0.1)
    got = smod.ssd_scan(*(a.float().to(dev) for a in args64),
                        init_state=s0.float().to(dev))
    args = [a.float() for a in args64]
    for g, w in zip(got, ref.ssd_scan_ref(*args, init_state=s0.float())):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **SSD_TOL)
    for g, w in zip(got, ref.ssd_ref(*args64, init_state=s0)):
        err = float((g.cpu().double() - w).abs().max() / w.abs().max())
        assert err < SSD_F64_TOL, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_hd112_matches_plain_on_gpu(dtype):
    """zamba2's shared block: MHA (G = 1) at head_dim 112."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    rng = np.random.default_rng(7)
    B, S, H, hd = 2, 300, 4, 112
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(
        np.float32)).to(dev, dt) for _ in range(3))
    got = fmod.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
    for cl in (1, 150, S):
        got = dmod.decode_attention(q[:, :1], k, v, cl)
        want = ref.decode_attention_ref(q[:, :1], k, v, cl)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)
