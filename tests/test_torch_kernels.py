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
                                    (2, 64, 64, 4, 4, 64)]:
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
    for (B, S, KV, G, hd) in [(8, 1024, 4, 7, 128), (3, 1000, 1, 8, 256),
                              (2, 300, 4, 1, 64)]:
        q, kc, vc = (x.to(dev, dt) for x in _t(*_normal(
            5, (B, 1, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd))))
        for cl in (1, S // 3, S):
            n = dmod.launches
            got = dmod.decode_attention(q, kc, vc, cl)
            assert dmod.launches == n + 1
            want = ref.decode_attention_ref(q, kc, vc, cl)
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)
