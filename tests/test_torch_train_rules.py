"""The reference's training rules (``tests/test_training.py``) on the
port alone, and what the training path owes the serving path: remat's
recomputation, the serving entry points free of autograd after a step,
the float64 yardstick the card's check uses, and the CUDA kernels
refusing autograd.  No JAX here, so the ``gpu`` case runs on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import flash_attention as fmod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rms_norm as nmod  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import data  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             make_train_step)

CFG = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
S, B = 32, 8                     # tests/test_training.py's batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _batch(arch, step: int = 0):
    return data.batch_at_step(data.for_arch(arch, S, B), step)


@pytest.mark.parametrize("remat,recomputed_mm,recomputed_bmm", [
    ("none", 0, 0), ("full", 6, 2), ("dots", 0, 2)])
def test_remat_recomputes_what_the_policy_says(remat, recomputed_mm,
                                               recomputed_bmm):
    """The backward pass's products a layer: each x @ w (mm) needs two
    (its grads by x and by w), each attention einsum (bmm) two.  "full"
    recomputes the forward's products too: 6 of the 7 mm (the recompute
    stops before the MLP down-projection, whose output the backward does
    not read) and both bmm; "dots" the bmm only
    (``dots_with_no_batch_dims_saveable``)."""
    model = Model(ARCHS["granite-3-2b"].reduced(), device="cpu",
                  dtype=torch.float32, impl="plain", remat=remat)
    model.init(torch.Generator().manual_seed(0)).requires_grad_(True)
    seen = []

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    loss = model.loss(_torch(_batch(model.arch)))
    with Count():
        torch.autograd.grad(loss, list(model.parameters()))
    L = model.arch.num_layers
    # wq wk wv wo wg wu wd; scores and P.V; the head's two mm
    assert seen.count(torch.ops.aten.mm.default) == \
        (2 * 7 + recomputed_mm) * L + 2
    assert seen.count(torch.ops.aten.bmm.default) == \
        (2 * 2 + recomputed_bmm) * L


# ---------------------------------------------------------------------------
# the reference's own rules, on the port (tests/test_training.py)
@pytest.fixture(scope="module")
def granite():
    arch = ARCHS["granite-3-2b"].reduced()
    return arch, data.for_arch(arch, seq_len=S, global_batch=B)


def _fresh(arch, **kw):
    model = Model(arch, device="cpu", dtype=torch.float32, impl="plain")
    return model, init_train_state(
        model, torch.Generator().manual_seed(0), CFG)


def test_loss_decreases(granite):
    arch, dcfg = granite
    model, state = _fresh(arch)
    step = make_train_step(model, CFG)
    losses = []
    for i in range(12):
        state, metrics = step(state, data.batch_at_step(dcfg, i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_microbatch_equivalence(granite):
    arch, dcfg = granite
    m1, s1 = _fresh(arch)
    m4, s4 = _fresh(arch)
    batch = data.batch_at_step(dcfg, 0)
    s1, r1 = make_train_step(m1, CFG, microbatches=1)(s1, batch)
    s4, r4 = make_train_step(m4, CFG, microbatches=4)(s4, batch)
    assert float(r1["loss"]) == pytest.approx(float(r4["loss"]), rel=1e-5)
    for a, b in zip(s1["params"].values(), s4["params"].values()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_compressed_training_tracks_uncompressed(granite):
    arch, dcfg = granite
    me, se = _fresh(arch)
    mc, sc = _fresh(arch)
    fe = make_train_step(me, CFG)
    fc = make_train_step(mc, CFG, grad_compression="int8")
    for i in range(8):
        batch = data.batch_at_step(dcfg, i)
        se, re_ = fe(se, batch)
        sc, rc = fc(sc, batch)
    assert abs(float(re_["loss"]) - float(rc["loss"])) < 0.12


def test_serving_outputs_carry_no_grad_after_a_step(granite):
    arch, dcfg = granite
    model, state = _fresh(arch)
    state, _ = make_train_step(model, CFG)(state, data.batch_at_step(dcfg, 0))
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.from_numpy(data.batch_at_step(dcfg, 1)["tokens"]).long()
    logits = model.forward(tokens)
    last, cache = model.prefill(tokens[:, :8], max_seq=12)
    step_logits, cache = model.decode_step(cache, 8, tokens[:, 8:9])
    for t in (logits, last, step_logits, *cache["k"], *cache["v"]):
        assert not t.requires_grad and t.grad_fn is None
    # and the step left the weights it reports in the model
    assert all(state["params"][n] is p for n, p in model.named_parameters())


def test_float64_model_is_the_yardstick_of_fp32_grads(granite):
    """The card's check on the CPU: a float64 copy of the model computes in
    float64 throughout (norms, rotary, logits), and the fp32 loss and
    gradients sit within the card's limits of it."""
    arch, dcfg = granite
    m32, _ = _fresh(arch)
    m64 = Model(arch, device="cpu", dtype=torch.float64, impl="plain")
    m64.load_state_dict({k: v.double() for k, v in m32.state_dict().items()})
    m64.requires_grad_(True)
    batch = _torch(data.batch_at_step(dcfg, 0))
    l32, l64 = m32.loss(batch), m64.loss(batch)
    assert l64.dtype == torch.float64
    assert abs(l32.item() - l64.item()) <= 1e-5 * abs(l64.item())
    g32 = torch.autograd.grad(l32, list(m32.parameters()))
    g64 = torch.autograd.grad(l64, list(m64.parameters()))
    for a, b in zip(g32, g64):
        assert float((a.double() - b).abs().max()) <= 1e-3 * float(
            b.abs().max())


def test_kernels_refuse_grad_on_the_card(monkeypatch, granite):
    """With tensors taken for CUDA ones, the kernels refuse an input that
    requires grad under grad mode (the kernel has no backward; the first
    norm refuses before any attention launches) and the attention
    launches under no_grad, as serving does (the norms' wrapper a plain
    stand-in here)."""
    arch, dcfg = granite
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    launched = []

    def kernel(q, k, v, **kw):
        launched.append(q.shape)
        return ref.flash_attention_ref(q, k, v, **kw)

    monkeypatch.setattr(fmod, "flash_attention", kernel)
    monkeypatch.setattr(nmod, "rms_norm", ref.rms_norm_ref)
    model = Model(arch, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    batch = _torch(data.batch_at_step(dcfg, 0))
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(batch).backward()
    assert not launched
    model.forward(batch["tokens"])
    assert len(launched) == arch.num_layers
    with torch.no_grad():
        model.loss(batch)
    plain = Model(arch, device="cpu", dtype=torch.float32, impl="plain")
    plain.load_state_dict(model.state_dict())
    plain.requires_grad_(True)
    plain.loss(batch).backward()      # the training path never reaches it
    assert len(launched) == 2 * arch.num_layers


@pytest.mark.gpu
def test_kernel_model_refuses_training_on_the_card():
    """On the card: a model on the kernels refuses ``loss(...).backward()``
    (the flash kernel has no backward); the plain model trains one step
    with a finite loss, and its serving outputs carry no graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    arch = ARCHS["granite-3-2b"].reduced()
    batch = _batch(arch)
    model = Model(arch, device="cuda", dtype=torch.float32)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(True)
    tensors = {k: v.cuda() for k, v in _torch(batch).items()}
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(tensors).backward()
    plain = Model(arch, device="cuda", dtype=torch.float32, impl="plain")
    plain.load_state_dict(model.state_dict())
    state = init_train_state(plain, None, CFG)
    state, met = make_train_step(plain, CFG)(state, batch)
    assert np.isfinite(float(met["loss"])) and int(state["opt"]["step"]) == 1
    assert not plain.forward(tensors["tokens"]).requires_grad
