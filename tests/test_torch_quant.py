"""The port's int8 path (``repro_torch.kernels``: ``quantize_int8``,
``quant_matmul``, ``quant_linear``).

On the CPU: the plain versions that ``ops`` dispatches to for CPU tensors
against the JAX package's oracles and its Pallas kernel in interpret mode,
on inputs made with numpy, with w_q row-major and K-major (the kernel's
native layout), and the wrapper's choice of kernel body.  The integer product is exact, so the matmul is
held at 1e-6 (``tests/test_kernels.py:103-113``) and the quantised values
and scales must be equal.  On a card (``gpu`` marker): the CUDA kernel
against its plain version, bit for bit.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import quant_matmul as qmod  # noqa: E402

EXACT = dict(rtol=1e-6, atol=1e-6)     # tests/test_kernels.py:112
DENSE_TOL = 0.02                       # tests/test_kernels.py:125


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
    """The JAX reference, imported here so that the ``gpu`` tests also run
    where only the card's stack (torch, no jax) is installed."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.quant_matmul import quant_matmul_pallas
    return SimpleNamespace(jnp=jax.numpy, ref=jref, ops=jops,
                           pallas=quant_matmul_pallas)


def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _quantized(seed, M, K, N):
    """x [M,K] quantised per row, w [K,N] per column (as numpy)."""
    x, w = _normal(seed, (M, K), (K, N))
    xq, xs = ref.quantize_int8(torch.from_numpy(x), axis=-1)
    wq, ws = ref.quantize_int8(torch.from_numpy(w), axis=0)
    return xq, wq, xs, ws


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("shape", [(128, 256), (7, 200), (1, 33)])
def test_quantize_int8_matches_jax(jx, shape, axis):
    """Equal int8 values and equal scales, bit for bit."""
    (x,) = _normal(1, shape, scale=3.0)
    # row 0's and column 0's largest |x| is 127, so their scale is 1 and
    # these values fall exactly halfway: they round half to even
    x[0, :5] = [127.0, 2.5, -2.5, 0.5, 1.5]
    if shape[0] >= 4:
        x[1:4, 0] = [2.5, -2.5, 0.5]
    q, s = ref.quantize_int8(torch.from_numpy(x), axis=axis)
    if axis == -1:
        assert q[0, 1:5].tolist() == [2, -2, 0, 2]
    elif shape[0] >= 4:
        assert q[1:4, 0].tolist() == [2, -2, 0]
    jq, js = jx.ref.quantize_int8(jx.jnp.asarray(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert torch.equal(ops.quantize_int8(torch.from_numpy(x), axis)[0], q)


def test_quantize_int8_of_zeros_and_bf16(jx):
    """The 1e-8 floor of an all-zero row, and a bf16 input (cast to fp32
    first, as the reference does)."""
    x = np.zeros((3, 16), np.float32)
    x[1] = np.linspace(-1, 1, 16)
    q, s = ref.quantize_int8(torch.from_numpy(x))
    jq, js = jx.ref.quantize_int8(jx.jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    qb, sb = ref.quantize_int8(xb)
    jqb, jsb = jx.ref.quantize_int8(jx.jnp.asarray(x, jx.jnp.bfloat16))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))


@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (64, 512, 192),
                                   (256, 128, 64)])
def test_quant_matmul_matches_pallas(jx, M, K, N):
    """The plain version against the Pallas kernel in interpret mode at
    ``tests/test_kernels.py:103-105``'s shapes and blocks."""
    xq, wq, xs, ws = _quantized(4, M, K, N)
    got = ops.quant_matmul(xq, wq, xs, ws)
    want = jx.pallas(*(jx.jnp.asarray(t.numpy()) for t in (xq, wq, xs, ws)),
                     interpret=True, block_m=64, block_n=64, block_k=128)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


@pytest.mark.parametrize("M", [1, 8, 17])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quant_matmul_ragged_matches_jax(jx, M, out_dtype):
    """Shapes no power-of-two block divides (N 100, K 200) against the
    JAX oracle; bf16 output is the same fp32 value rounded once."""
    K, N = 200, 100
    xq, wq, xs, ws = _quantized(5 + M, M, K, N)
    got = ops.quant_matmul(xq, wq, xs, ws, out_dtype=getattr(torch,
                                                              out_dtype))
    want = jx.ref.quant_matmul_ref(
        *(jx.jnp.asarray(t.numpy()) for t in (xq, wq, xs, ws)),
        out_dtype=getattr(jx.jnp, out_dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **EXACT)


def _k_major(w):
    """The same [K,N] values with K stride 1 (the kernel's native layout)."""
    return w.t().contiguous().t()


@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (64, 512, 192),
                                   (256, 128, 64), (1, 200, 100),
                                   (8, 200, 100), (17, 200, 100)])
def test_quant_matmul_k_major_matches_row_major_and_pallas(jx, M, K, N):
    """A K-major w_q is the same function of the same [K,N] tensor: the op
    gives the row-major result and the Pallas kernel's (interpret mode),
    bit for bit, at ``tests/test_kernels.py:103-105``'s shapes and ragged
    ones."""
    xq, wq, xs, ws = _quantized(11 + M, M, K, N)
    wk = _k_major(wq)
    assert wk.stride(0) == 1 and torch.equal(wk, wq)
    got = ops.quant_matmul(xq, wk, xs, ws)
    np.testing.assert_array_equal(got.numpy(),
                                  ops.quant_matmul(xq, wq, xs, ws).numpy())
    want = jx.pallas(*(jx.jnp.asarray(t.numpy()) for t in (xq, wq, xs, ws)),
                     interpret=True, block_m=64, block_n=64, block_k=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,K,N,layout,want", [
    (8, 3584, 18944, "k", "wgmma_small"),     # decode: the operands swap
    (64, 256, 100, "k", "wgmma_small"),
    (65, 256, 100, "k", "wgmma"),
    (3792, 3584, 18944, "k", "wgmma"),        # prefill
    (8, 3584, 18944, "row", "mma_sync"),      # row-major: transposed in smem
    (3792, 3584, 256, "row", "mma_sync"),
    (17, 200, 100, "k", "mma_sync"),          # rows of 200 B: no TMA
])
def test_quant_matmul_plan_follows_layout_and_alignment(M, K, N, layout,
                                                        want):
    """The body is picked from the layout and alignment of the operands
    only: the TMA bodies need a K-major w_q and 16-byte rows."""
    xq = torch.zeros(M, K, dtype=torch.int8)
    wq = torch.zeros(K, N, dtype=torch.int8)
    w = _k_major(wq) if layout == "k" else wq
    assert qmod.w_layout(w) == (layout, w.stride(1 if layout == "k" else 0))
    assert qmod.plan(xq, w) == want


def test_quant_matmul_w_layout_refuses_other_strides():
    """A w_q with neither its K nor its N stride 1 has no body; a single
    column or row counts as row-major whatever its strides."""
    w = torch.zeros(64, 64, dtype=torch.int8)[::2, ::2]
    with pytest.raises(ValueError, match="stride"):
        qmod.w_layout(w)
    assert qmod.w_layout(torch.zeros(5, 1, dtype=torch.int8))[0] == "row"
    assert qmod.w_layout(torch.zeros(1, 6, dtype=torch.int8))[0] == "row"
    assert qmod.w_layout(_k_major(torch.zeros(7, 3, dtype=torch.int8))) \
        == ("k", 7)


def test_quant_matmul_integer_product_is_exact():
    """The float64 product is the exact integer product, at the largest
    magnitudes and a K where fp32 accumulation would round."""
    K = 18944
    xq = torch.full((2, K), 127, dtype=torch.int8)
    xq[1, ::2] = -127
    wq = torch.full((K, 3), -127, dtype=torch.int8)
    one = torch.ones(2), torch.ones(3)
    got = ref.quant_matmul_ref(xq, wq, *one, torch.float32)
    exact = (xq.long() @ wq.long()).float()
    assert torch.equal(got, exact)
    assert float(got[0, 0]) == float(np.float32(-127 * 127 * K))


@pytest.mark.parametrize("shape", [(2, 16, 128), (5, 128)])
def test_quant_linear_matches_jax_and_dense(jx, shape):
    """Equal to ``repro.kernels.ops.quant_linear`` within 1e-6 relative,
    and within 0.02 of the dense product (``tests/test_kernels.py:116-125``)."""
    K, N = shape[-1], 64
    x, w = _normal(6, shape, (K, N))
    w *= 0.1
    wq, ws = ops.quantize_int8(torch.from_numpy(w), axis=0)
    got = ops.quant_linear(torch.from_numpy(x), wq, ws)
    jwq, jws = jx.ops.quantize_int8(jx.jnp.asarray(w), axis=0)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    want = np.asarray(jx.ops.quant_linear(jx.jnp.asarray(x), jwq, jws))
    assert tuple(got.shape) == shape[:-1] + (N,) and got.dtype == torch.float32
    assert (np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
            < 1e-6)
    dense = x @ w
    rel = np.linalg.norm(got.numpy() - dense) / np.linalg.norm(dense)
    assert rel < DENSE_TOL, rel


def test_quant_linear_heavy_tailed_rows_in_both_packages(jx):
    """On SwiGLU-like rows (silu(a)·b, max |x| ~11x the row's rms) per-row
    int8 rounds coarsely enough that the dense limit no longer holds; the
    port's ``quant_linear`` equals the JAX package's there too, so both read
    above 0.02 alike."""
    a, b, w = _normal(9, (8, 4096), (8, 4096), (4096, 64))
    x = (a / (1.0 + np.exp(-a)) * b).astype(np.float32)
    peak = np.abs(x).max(-1) / np.sqrt((x ** 2).mean(-1))
    assert peak.mean() > 10.0, peak
    wq, ws = ops.quantize_int8(torch.from_numpy(w), axis=0)
    got = ops.quant_linear(torch.from_numpy(x), wq, ws).numpy()
    jwq, jws = jx.ops.quantize_int8(jx.jnp.asarray(w), axis=0)
    want = np.asarray(jx.ops.quant_linear(jx.jnp.asarray(x), jwq, jws))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6
    dense = x @ w
    rel = [np.linalg.norm(o - dense) / np.linalg.norm(dense)
           for o in (got, want)]
    assert min(rel) > DENSE_TOL, rel


def test_quant_linear_keeps_bf16():
    """A bf16 activation comes back in bf16 (the fp32 product cast once)."""
    x, w = _normal(7, (3, 4, 64), (64, 32))
    wq, ws = ops.quantize_int8(torch.from_numpy(w), axis=0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.quant_linear(xb, wq, ws)
    xq, xs = ref.quantize_int8(xb.reshape(-1, 64))
    want = ref.quant_matmul_ref(xq, wq, xs, ws).reshape(3, 4, 32)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_wrapper_refuses_cpu_tensors_and_bad_inputs():
    """The wrapper launches the kernel or raises: a CPU tensor is refused
    (``ops`` sends those to the plain version instead), as are wrong
    types and shapes, before anything is built."""
    xq, wq, xs, ws = _quantized(8, 4, 32, 8)
    n = qmod.launches
    with pytest.raises(ValueError, match="CUDA"):
        qmod.quant_matmul(xq, wq, xs, ws)
    with pytest.raises(TypeError, match="int8"):
        qmod.quant_matmul(xq.float(), wq, xs, ws)
    with pytest.raises(ValueError, match="do not match"):
        qmod.quant_matmul(xq, wq[:16], xs, ws)
    with pytest.raises(TypeError, match="out_dtype"):
        qmod.quant_matmul(xq, wq, xs, ws, out_dtype=torch.float16)
    K = qmod.K_MAX + 1            # int32 accumulation could overflow
    with pytest.raises(ValueError, match="overflow"):
        qmod.quant_matmul(torch.ones(1, K, dtype=torch.int8),
                          torch.ones(K, 1, dtype=torch.int8),
                          torch.ones(1), torch.ones(1))
    assert qmod.launches == n
    assert torch.equal(ops.quant_matmul(xq, wq, xs, ws),
                       ref.quant_matmul_ref(xq, wq, xs, ws))


# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quant_matmul_kernel_matches_plain_on_gpu(out_dtype):
    """Bit for bit: exact int32 products and the plain version's epilogue
    order, over ragged M, K and N and a strided view."""
    dev = _cuda()
    od = getattr(torch, out_dtype)
    cases = [(M, K, N) for M in (1, 8, 17, 300) for K in (32, 200, 1000)
             for N in (8, 100, 384)]
    for M, K, N in cases:
        xq, wq, xs, ws = (t.to(dev) for t in _quantized(M + K + N, M, K, N))
        n = qmod.launches
        got = qmod.quant_matmul(xq, wq, xs, ws, out_dtype=od)
        assert qmod.launches == n + 1
        assert torch.equal(got, ref.quant_matmul_ref(xq, wq, xs, ws, od)), \
            (M, K, N)
    xq, wq, xs, ws = (t.to(dev) for t in _quantized(9, 40, 210, 110))
    xv, wv = xq[:, 3:203], wq[:200, 1:101]
    got = qmod.quant_matmul(xv, wv, xs, ws[1:101].contiguous(), out_dtype=od)
    assert torch.equal(got, ref.quant_matmul_ref(xv, wv, xs,
                                                 ws[1:101].contiguous(), od))


@pytest.mark.gpu
def test_quant_matmul_both_layouts_ragged_sweep_on_gpu():
    """Both layouts of w_q over M around the decode body's widths and the
    prefill body's 128-row tiles, K past a 128-byte box and not a 16-byte
    multiple, N past a 64-column tile: every body, bit for bit."""
    dev = _cuda()
    paths = set()
    for M in (1, 8, 16, 17, 64, 65, 129):
        for K, N in ((200, 100), (3600, 300), (1024, 18950)):
            xq, wq, xs, ws = (t.to(dev) for t in _quantized(M * K % 97, M, K,
                                                             N))
            want = ref.quant_matmul_ref(xq, wq, xs, ws)
            for w in (wq, _k_major(wq)):
                paths.add(qmod.plan(xq, w))
                got = qmod.quant_matmul(xq, w, xs, ws)
                assert torch.equal(got, want), (M, K, N, w.stride())
    assert paths == {"mma_sync", "wgmma_small", "wgmma"}


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 33, 64])
def test_quant_matmul_split_k_path_on_gpu(M):
    """The decode body splits K across blocks and adds int32 partial sums
    with atomics: exact whatever the order, also with every product at
    +-127^2 over a K near K_MAX (the largest sums int32 holds here)."""
    dev = _cuda()
    K, N = 131056, 200
    xq = torch.full((M, K), 127, dtype=torch.int8, device=dev)
    wq = torch.full((K, N), 127, dtype=torch.int8, device=dev)
    wq[:, 1::2] = -127
    xs = torch.rand(M, device=dev) + 0.5
    ws = torch.rand(N, device=dev) + 0.5
    wk = _k_major(wq)
    assert qmod.plan(xq, wk) == "wgmma_small"
    for od in (torch.float32, torch.bfloat16):
        got = qmod.quant_matmul(xq, wk, xs, ws, out_dtype=od)
        assert torch.equal(got, ref.quant_matmul_ref(xq, wq, xs, ws, od))
    xq, wq, xs, ws = (t.to(dev) for t in _quantized(M, M, 3584, 18944))
    assert torch.equal(qmod.quant_matmul(xq, _k_major(wq), xs, ws),
                       ref.quant_matmul_ref(xq, wq, xs, ws))


@pytest.mark.gpu
def test_quant_linear_on_gpu_matches_cpu():
    """The op on a CUDA tensor launches the kernel once and gives what the
    CPU path gives."""
    dev = _cuda()
    x, w = _normal(10, (2, 16, 128), (128, 64))
    wq, ws = ops.quantize_int8(torch.from_numpy(w), axis=0)
    n = qmod.launches
    got = ops.quant_linear(torch.from_numpy(x).to(dev), wq.to(dev),
                           ws.to(dev))
    assert qmod.launches == n + 1
    want = ops.quant_linear(torch.from_numpy(x), wq, ws)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **EXACT)
