"""The port's attention kernels (``repro_torch.kernels``).

On the CPU: the plain versions that ``ops`` dispatches to for CPU tensors
against the JAX package's oracles and its Pallas kernels in interpret mode,
on inputs made with numpy.  On a card (``gpu`` marker): the CUDA kernels
against their plain versions.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dmod  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)      # fp32, as tests/test_kernels.py:14
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread is enough, and keeps
    this file from crowding the tests that run beside it in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: its oracles and Pallas kernels.  Imported here,
    not at the top, so that the ``gpu`` tests also run where only the
    card's stack (torch, no jax) is installed."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.flash_attention import flash_attention_pallas
    return SimpleNamespace(jnp=jax.numpy, ref=jref,
                           flash=flash_attention_pallas,
                           decode=decode_attention_pallas)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA
    (1, 256, 8, 1, 128),    # MQA, wide head
    (2, 100, 6, 2, 64),     # ragged S, G = 3
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax(jx, B, S, H, KV, hd, causal):
    q, k, v = _normal(0, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    got = ops.flash_attention(*_t(q, k, v), causal=causal).numpy()
    want = jx.ref.flash_attention_ref(jx.jnp.asarray(q), jx.jnp.asarray(k),
                                      jx.jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(jx, causal):
    """Against the TPU kernel itself (interpret mode), GQA with ragged S."""
    q, k, v = _normal(0, (2, 100, 6, 64), (2, 100, 2, 64),
                      (2, 100, 2, 64))
    got = ops.flash_attention(*_t(q, k, v), causal=causal).numpy()
    pallas = jx.flash(jx.jnp.asarray(q), jx.jnp.asarray(k),
                      jx.jnp.asarray(v), causal=causal, block_q=128,
                      block_kv=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_flash_plain_query_offset(jx):
    """Sq < Skv: causal query rows sit at positions Skv - Sq onwards."""
    q, k, v = _normal(1, (2, 32, 4, 64), (2, 96, 2, 64), (2, 96, 2, 64))
    got = ref.flash_attention_ref(*_t(q, k, v)).numpy()
    want = jx.ref.flash_attention_ref(jx.jnp.asarray(q), jx.jnp.asarray(k),
                                      jx.jnp.asarray(v))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("B,S,KV,G,hd", [
    (2, 512, 4, 4, 64),
    (1, 1024, 1, 8, 128),   # MQA decode
    (4, 256, 8, 1, 64),     # MHA decode
    (2, 200, 4, 7, 128),    # qwen2's group of 7, ragged cache
])
@pytest.mark.parametrize("fill", [0.3, 1.0])
def test_decode_plain_matches_jax(jx, B, S, KV, G, hd, fill):
    H = KV * G
    q, kc, vc = _normal(2, (B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    cl = max(1, int(S * fill))
    got = ops.decode_attention(*_t(q, kc, vc), cl).numpy()
    want = jx.ref.decode_attention_ref(jx.jnp.asarray(q), jx.jnp.asarray(kc),
                                       jx.jnp.asarray(vc), jx.jnp.int32(cl))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("fill", [0.3, 1.0])
def test_decode_plain_matches_pallas(jx, fill):
    """Against the TPU kernel itself (interpret mode), qwen2's group of 7."""
    B, S, KV, G, hd = 2, 256, 4, 7, 128
    q, kc, vc = _normal(2, (B, 1, KV * G, hd), (B, S, KV, hd),
                        (B, S, KV, hd))
    cl = max(1, int(S * fill))
    got = ops.decode_attention(*_t(q, kc, vc), cl).numpy()
    pallas = jx.decode(jx.jnp.asarray(q), jx.jnp.asarray(kc),
                       jx.jnp.asarray(vc), jx.jnp.int32(cl), block_kv=128,
                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("B,KV", [(1, 1), (8, 1), (8, 4), (8, 8), (8, 32),
                                  (3, 2), (64, 8), (1, 300)])
def test_split_plan_covers_the_cache(B, KV):
    """The split-KV plan over every cache_len up to 1,024: splits of a
    multiple of 64 positions cover [0, cache_len) once with none empty, and
    the grid reaches 2 blocks an SM (264 on 132 SMs) wherever 64-position
    splits allow it (else every split is one tile)."""
    sm = 132
    for cl in range(1, 1025):
        split_len, n = dmod.split_plan(B, KV, cl, sm)
        assert split_len % 64 == 0 and split_len >= 64
        starts = range(0, n * split_len, split_len)
        assert (n - 1) * split_len < cl <= n * split_len, (cl, split_len, n)
        assert all(min(s + split_len, cl) > s for s in starts)
        tiles = -(-cl // 64)
        if tiles * B * KV >= 2 * sm:
            assert n * B * KV >= 2 * sm, (cl, split_len, n)
        else:
            assert split_len == 64 and n == tiles


def test_split_plan_refuses_empty_sizes():
    for args in [(0, 1, 10, 132), (1, 0, 10, 132), (1, 1, 0, 132),
                 (1, 1, 10, 0)]:
        with pytest.raises(ValueError, match="positive"):
            dmod.split_plan(*args)


@pytest.mark.parametrize("B,S,KV,G,hd,cl,sm", [
    (2, 256, 4, 7, 128, 200, 132),   # 4 splits of 64, the last of 8
    (1, 512, 1, 8, 64, 500, 132),    # MQA, 8 splits, the last of 52
    (2, 512, 2, 4, 64, 450, 4),      # 2 splits of 256, the last of 194
    (2, 512, 2, 4, 64, 300, 2),      # one split of 320 over 300
    (2, 128, 2, 4, 64, 1, 132),      # cache_len 1
    (1, 256, 2, 1, 112, 129, 132),   # MHA at hd 112, a last split of 1
])
def test_decode_split_merge_matches_jax(jx, B, S, KV, G, hd, cl, sm):
    """The split kernels' algebra (per-split partial softmax, then the
    rescaled merge) against the JAX oracle and the Pallas kernel
    (interpret mode), fp32, on the plan ``split_plan`` makes."""
    split_len, n = dmod.split_plan(B, KV, cl, sm)
    q, kc, vc = _normal(6, (B, 1, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd))
    got = ref.decode_attention_split_ref(*_t(q, kc, vc), cl,
                                         split_len).numpy()
    args = (jx.jnp.asarray(q), jx.jnp.asarray(kc), jx.jnp.asarray(vc),
            jx.jnp.int32(cl))
    np.testing.assert_allclose(got, np.asarray(jx.ref.decode_attention_ref(
        *args)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jx.decode(
        *args, block_kv=128, interpret=True)), **TOL)
    # and against the one-pass plain version the CPU path runs
    np.testing.assert_allclose(got, ops.decode_attention(
        *_t(q, kc, vc), cl).numpy(), **TOL)


@pytest.mark.parametrize("shape,view,ok", [
    ((2, 64, 4, 128), None, True),                 # contiguous
    ((1, 1, 4, 112), None, True),                  # hd 112: 224-byte rows
    ((2, 64, 4, 136), (slice(None),) * 3 + (slice(0, 128),), True),
    ((2, 64, 4, 132), (slice(None),) * 3 + (slice(0, 128),), False),
    ((2, 64, 4, 128), (slice(None), slice(None), slice(None, None, 2)),
     True),                                        # every other head
    ((2, 65, 4, 64), (slice(None), slice(1, None)), True),  # offset 512 B
    ((2, 64, 4, 65), (slice(None),) * 3 + (slice(1, 65),), False),
])
def test_flash_bf16_tma_alignment(shape, view, ok):
    """The bf16 kernel reads through TMA: a 16-byte-aligned base and
    strides of whole 16 bytes, or ``ValueError``; the stride of a size-1
    dim is never stepped and is given its contiguous value."""
    base = torch.zeros(shape, dtype=torch.bfloat16)
    t = base if view is None else base[view]
    if not ok:
        with pytest.raises(ValueError, match="16-byte"):
            fmod._tma_strides("q", t)
        return
    strides = fmod._tma_strides("q", t)
    B, S, H, hd = t.shape
    for st, n, st_t, c in zip(strides, t.shape, t.stride(),
                              (S * H * hd, H * hd, hd)):
        assert st == (st_t if n > 1 else c) and st % 8 == 0


def test_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; only ``ops`` picks the plain
    version, and only for a CPU tensor."""
    q, k, v = _t(*_normal(3, (1, 8, 2, 64), (1, 8, 2, 64), (1, 8, 2, 64)))
    before = (fmod.launches, dmod.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fmod.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        dmod.decode_attention(q[:, :1], k, v, 4)
    assert (fmod.launches, dmod.launches) == before
    with pytest.raises(ValueError, match="no kernel path"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_gpu(dtype):
    dev = _cuda()
    dt = getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    for (B, Sq, Skv, H, KV, hd) in [(2, 500, 500, 14, 2, 128),
                                    (1, 37, 101, 8, 1, 256),
                                    (2, 64, 64, 4, 4, 64),
                                    (2, 200, 333, 8, 8, 112),  # hd 112
                                    (1, 127, 127, 4, 1, 128),  # around the
                                    (1, 128, 128, 4, 1, 128),  # 128-row
                                    (1, 129, 129, 4, 1, 128),  # query tile
                                    (2, 64, 192, 8, 2, 64),    # Sq < Skv
                                    (1, 129, 300, 8, 4, 256)]:
        q, k, v = (x.to(dev, dt) for x in _t(*_normal(
            4, (B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))))
        for causal in (True, False):
            n = fmod.launches
            got = fmod.flash_attention(q, k, v, causal=causal)
            assert fmod.launches == n + 1
            want = ref.flash_attention_ref(q, k, v, causal=causal)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain_on_gpu(dtype):
    dev = _cuda()
    dt = getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for (B, S, KV, G, hd) in [(8, 1024, 4, 7, 128), (3, 1000, 1, 8, 256),
                              (2, 300, 4, 1, 64), (8, 1024, 32, 1, 112)]:
        q, kc, vc = (x.to(dev, dt) for x in _t(*_normal(
            5, (B, 1, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd))))
        sl = dmod.split_plan(B, KV, S, sm)[0]     # one split boundary
        for cl in sorted({c for c in (1, 63, 64, 65, S // 3, sl - 1, sl,
                                      sl + 1, S) if 1 <= c <= S}):
            n = dmod.launches
            got = dmod.decode_attention(q, kc, vc, cl)
            assert dmod.launches == n + 1
            want = ref.decode_attention_ref(q, kc, vc, cl)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)


@pytest.mark.gpu
def test_flash_bf16_refuses_misaligned_stride_on_gpu():
    """A bf16 view whose head stride is 136 bytes cannot feed TMA: the
    wrapper raises and counts no launch."""
    dev = _cuda()
    base = torch.zeros((1, 64, 2, 68), dtype=torch.bfloat16, device=dev)
    q = base[..., :64]
    n = fmod.launches
    with pytest.raises(ValueError, match="16-byte"):
        fmod.flash_attention(q, q, q)
    assert fmod.launches == n
    got = fmod.flash_attention(q.contiguous(), q.contiguous(), q.contiguous())
    assert fmod.launches == n + 1 and got.shape == q.shape


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_partial_kernel_matches_plain_on_gpu(dtype):
    """Each shard's share of a ragged-sharded cache through the partial
    kernel (o, lse) against the plain share, the shares merged against the
    whole-cache kernel; an empty shard launches nothing."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    bounds = (0, 256, 600, 777, 1000)
    for (B, KV, G, hd) in [(8, 4, 7, 128), (3, 1, 8, 256), (2, 4, 1, 64),
                           (8, 32, 1, 112)]:
        q, kc, vc = (x.to(dev, dt) for x in _t(*_normal(
            6, (B, 1, KV * G, hd), (B, 1000, KV, hd), (B, 1000, KV, hd))))
        for cl in (1, 255, 256, 257, 600, 777, 1000):
            shares = []
            for lo, hi in zip(bounds, bounds[1:]):
                valid = min(max(cl - lo, 0), hi - lo)
                n = dmod.partial_launches
                o, lse = dmod.decode_attention_partial(
                    q, kc[:, lo:hi], vc[:, lo:hi], valid)
                assert dmod.partial_launches == n + (valid > 0)
                po, plse = ref.decode_attention_partial_ref(
                    q, kc[:, lo:hi], vc[:, lo:hi], valid)
                np.testing.assert_allclose(o.cpu().numpy(), po.cpu().numpy(),
                                           **tol)
                np.testing.assert_allclose(lse.cpu().numpy(),
                                           plse.cpu().numpy(),
                                           rtol=1e-3, atol=1e-3)
                shares.append((o, lse))
            got = ref.merge_partials(torch.stack([o for o, _ in shares]),
                                     torch.stack([x for _, x in shares]))
            want = dmod.decode_attention(q, kc, vc, cl)
            np.testing.assert_allclose(got.to(dt).float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)


# ---------------------------------------------------------------------------
# the wrappers under DTensor (a model under a sharding policy)
@pytest.fixture
def one_rank_fake_group():
    """A one-rank ``fake`` default group, destroyed when the test ends."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_wrappers_on_a_one_by_one_cuda_mesh():
    """Each wrapper on DTensors of a 1x1 cuda mesh launches its kernel on
    the local shards and agrees with its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = make_host_mesh([("data", 1), ("model", 1)])
        g = torch.Generator(device="cuda").manual_seed(0)

        def rnd(*shape, dtype=torch.bfloat16):
            return torch.randn(shape, generator=g, device="cuda").to(dtype)

        def dt(x, *pl):
            return DTensor.from_local(x, mesh, pl, run_check=False)

        q, k, v = rnd(2, 64, 8, 128), rnd(2, 64, 2, 128), rnd(2, 64, 2, 128)
        n = fmod.launches
        out = ops.flash_attention(dt(q, Shard(0), Shard(2)),
                                  dt(k, Shard(0), Shard(2)),
                                  dt(v, Shard(0), Shard(2)), causal=True)
        assert fmod.launches == n + 1
        torch.testing.assert_close(out.full_tensor(),
                                   ref.flash_attention_ref(q, k, v),
                                   atol=2e-2, rtol=2e-2)
        n = dmod.launches
        out = ops.decode_attention(dt(q[:, :1], Shard(0), Shard(2)),
                                   dt(k, Shard(0), Shard(1)),
                                   dt(v, Shard(0), Shard(1)), 40)
        assert dmod.launches == n + 1
        torch.testing.assert_close(
            out.full_tensor(), ref.decode_attention_ref(q[:, :1], k, v, 40),
            atol=2e-2, rtol=2e-2)
        x = rnd(2, 64, 4, 64, dtype=torch.float32)
        dtv = torch.rand(2, 64, 4, device="cuda") * 0.1
        A = -torch.rand(4, device="cuda") - 0.5
        Bm, Cm = (rnd(2, 64, 128, dtype=torch.float32) for _ in range(2))
        n = smod.launches
        y, s = ops.ssd_scan(dt(x, Shard(0), Shard(2)),
                            dt(dtv, Shard(0), Shard(2)),
                            dt(A, Replicate(), Shard(0)),
                            dt(Bm, Shard(0), Replicate()),
                            dt(Cm, Shard(0), Replicate()))
        assert smod.launches == n + 1
        wy, ws = ref.ssd_scan_ref(x, dtv, A, Bm, Cm)
        torch.testing.assert_close(y.full_tensor(), wy, atol=2e-3, rtol=2e-3)
        torch.testing.assert_close(s.full_tensor(), ws, atol=2e-3, rtol=2e-3)
        xq = torch.randint(-127, 128, (64, 256), device="cuda",
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (256, 128), device="cuda",
                           dtype=torch.int8)
        xs, wsc = torch.rand(64, device="cuda"), torch.rand(128, device="cuda")
        n = qmod.launches
        out = ops.quant_matmul(dt(xq, Shard(0), Replicate()),
                               dt(wq, Replicate(), Shard(1)),
                               dt(xs, Shard(0), Replicate()),
                               dt(wsc, Replicate(), Shard(0)))
        assert qmod.launches == n + 1
        torch.testing.assert_close(out.full_tensor(),
                                   ref.quant_matmul_ref(xq, wq, xs, wsc),
                                   atol=1e-6, rtol=1e-6)
    finally:
        dist.destroy_process_group()


def test_wrappers_take_dtensors_on_the_cpu(one_rank_fake_group):
    """The same dispatch on the CPU: DTensors on a 1x1 mesh of the fake
    group reach the plain versions through the local path, placements as
    the card's path gives them (batch/heads for attention, rows and
    columns for the int8 GEMM)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh([("data", 1), ("model", 1)], device_type="cpu")
    g = torch.Generator().manual_seed(0)

    def dt(x, *pl):
        return DTensor.from_local(x, mesh, pl, run_check=False)

    q, k, v = (torch.randn(s, generator=g) for s in
               ((2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16)))
    out = ops.flash_attention(dt(q, Shard(0), Shard(2)),
                              dt(k, Shard(0), Shard(2)),
                              dt(v, Shard(0), Shard(2)))
    assert out.placements == (Shard(0), Shard(2))
    assert torch.equal(out.full_tensor(), ref.flash_attention_ref(q, k, v))
    # a sequence-sharded cache is gathered to the heads first
    out = ops.decode_attention(dt(q[:, :1], Replicate(), Shard(2)),
                               dt(k, Replicate(), Shard(1)),
                               dt(v, Replicate(), Shard(1)), 5)
    assert out.placements == (Replicate(), Shard(2))
    assert torch.equal(out.full_tensor(),
                       ref.decode_attention_ref(q[:, :1], k, v, 5))
    xq = torch.randint(-127, 128, (6, 32), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (32, 10), generator=g).to(torch.int8)
    xs, ws = torch.rand(6, generator=g), torch.rand(10, generator=g)
    out = ops.quant_matmul(dt(xq, Shard(0), Replicate()),
                           dt(wq, Replicate(), Shard(1)),
                           dt(xs, Shard(0), Replicate()),
                           dt(ws, Replicate(), Shard(0)))
    assert out.placements == (Shard(0), Shard(1))
    assert torch.equal(out.full_tensor(), ref.quant_matmul_ref(xq, wq, xs, ws))
