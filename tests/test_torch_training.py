"""The port's training substrate (``repro_torch.training``, ``Model.loss``,
remat) against the JAX package's ``repro.training``, on the CPU in fp32 at
reduced sizes, with the same weights (JAX params through numpy into the
port with ``from_jax_params``) and the same batches.

Tolerances are ``tests/test_training.py``'s: loss rtol 1e-5, params and
moments rtol 1e-4 / atol 1e-5 (its lines 54-55), grad norm 1e-4; the
optimizer's arithmetic rtol 1e-6 of each tensor's scale.  Two places
where a rounding-level change of the gradient moves the result by more
are held apart, each explained where it is checked: AdamW's first steps
at a gradient element below its ``eps`` (``_assert_params_close``), and
the hybrid (zamba2-7b), whose reduced random stack amplifies rounding
about tenfold a Mamba2 layer in the backward pass
(``test_one_train_step_matches_jax``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.sharding.policy import ShardingPolicy  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.model import LOSS_IGNORE  # noqa: E402
from repro_torch.training import compression as comp  # noqa: E402
from repro_torch.training import data  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             make_train_step, state_tree)

LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
RTOL, ATOL = 1e-4, 1e-5          # tests/test_training.py:54-55
JCFG = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
CFG = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
S, B = 32, 8                     # tests/test_training.py's batch
HYBRID = "zamba2-7b"
# Per tensor max|dm| / max|m| of the port's first moment (0.1 x the clipped
# gradient) from the reference's on reduced zamba2-7b, where the
# reference's own remat="full" moves it by a few 1e-3 (asserted above
# GNORM_RTOL in the test) and the port's by about twice that.
HYBRID_GRAD_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree) -> list:
    """Leaves of a JAX or port tree as numpy, in ``jax.tree.flatten``'s
    order (a torch tensor is a leaf to it)."""
    return [x.detach().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in jax.tree.leaves(tree)]


def _assert_trees_close(want, got, rtol=RTOL, atol=ATOL):
    w, g = _leaves(want), _leaves(got)
    assert len(w) == len(g)
    for a, b in zip(w, g):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def _assert_params_close(js, tree, lr_sum: float):
    """The port's params against the reference's, at RTOL/ATOL except
    where AdamW's update is not continuous in the gradient: an element
    whose ``sqrt(v_hat)`` is below ``10 * eps`` (its gradient ~1e-9, at
    the level of the two packages' fp32 rounding) moves by
    ``lr * g / (|g| + eps)``, which a 1e-10 change of g moves by up to
    ``lr``.  Those elements (at most 1 % of the reduced models' with a
    gradient) are held to the bound of any update, ``2 * lr`` summed over
    the steps."""
    b2c = 1.0 - JCFG.b2 ** int(js["opt"]["step"])
    flat_count = 0
    for a, b, v in zip(_leaves(js["params"]), _leaves(tree["params"]),
                       _leaves(js["opt"]["v"])):
        assert a.shape == b.shape and a.dtype == b.dtype
        flat = np.sqrt(v / b2c) < 10 * JCFG.eps
        close = np.abs(b - a) <= ATOL + RTOL * np.abs(a)
        assert (close | flat).all(), np.abs(b - a)[~(close | flat)]
        assert (np.abs(b - a)[flat] <= 2 * lr_sum).all()
        flat_count += int((flat & (v > 0)).sum())
    # (a zero gradient, as an embedding row no token of the batch reads,
    # is not counted: both packages move it by weight decay alone)
    assert flat_count <= 1e-2 * sum(a.size for a in _leaves(js["params"]))


_INIT = {}


def _pair(name: str, remat: str = "none"):
    """(jax model, jax train state, port model, port train state) with the
    reference's weights in both (made once per arch)."""
    jm = JaxModel(JAX_ARCHS[name].reduced(), ShardingPolicy(mesh=None),
                  param_dtype=jnp.float32, remat=remat)
    if name not in _INIT:
        _INIT[name] = jax.jit(jm.init)(jax.random.key(0))
    params = _INIT[name]
    arch = ARCHS[name].reduced()
    model = Model(arch, device="cpu", dtype=torch.float32, impl="plain",
                  remat=remat)
    model.load_state_dict(from_jax_params(arch, _np(params)))
    return (jm, {"params": params, "opt": jopt.init_state(params)}, model,
            init_train_state(model, None, CFG))


def _batch(arch, step: int = 0, seq: int = S, batch: int = B):
    return data.batch_at_step(data.for_arch(arch, seq, batch), step)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data
@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 200),
       st.sampled_from(["granite-3-2b", "pixtral-12b", "musicgen-large"]))
def test_batches_equal_the_reference(seed, step, name):
    arch = ARCHS[name].reduced()
    want = jdata.batch_at_step(jdata.for_arch(JAX_ARCHS[name].reduced(), 16,
                                              2, seed=seed), step)
    got = data.batch_at_step(data.for_arch(arch, 16, 2, seed=seed), step)
    assert dataclasses.asdict(data.for_arch(arch, 16, 2, seed=seed)) == \
        dataclasses.asdict(jdata.for_arch(JAX_ARCHS[name].reduced(), 16, 2,
                                          seed=seed))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    if arch.frontend != "none":
        assert (got["labels"][:, :4] == LOSS_IGNORE).all()
    it = data.make_iterator(data.for_arch(arch, 16, 2, seed=seed), step)
    assert next(it)["tokens"].tobytes() == want["tokens"].tobytes()


# ---------------------------------------------------------------------------
# optimizer
def test_adamw_config_and_schedule_match_jax():
    assert dataclasses.asdict(opt.AdamWConfig()) == \
        dataclasses.asdict(jopt.AdamWConfig())
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    steps = np.arange(0, 121, dtype=np.int32)
    got = opt.schedule(cfg, torch.from_numpy(steps)).numpy()
    want = np.asarray(jopt.schedule(jcfg, jnp.asarray(steps)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the reference's rule (tests/test_training.py:98-104)
    assert got[0] < got[9] <= got[10] == pytest.approx(1e-3, rel=1e-6)
    assert got[100] == pytest.approx(1e-4, rel=1e-3)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_apply_updates_matches_jax(grad_scale):
    """Three AdamW steps on the same grads, below and above the clip."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    flat = {"a": params["a"], "b.c": params["b"]["c"]}
    state = opt.init_state({k: torch.from_numpy(v) for k, v in flat.items()})
    jstate = jopt.init_state(jax.tree.map(jnp.asarray, params))
    for i in range(3):
        grads = {k: (rng.standard_normal(v.shape) * grad_scale
                     ).astype(np.float32) for k, v in flat.items()}
        new, state = opt.apply_updates(
            CFG, state, {k: torch.from_numpy(v) for k, v in grads.items()},
            param_dtype=torch.float32)
        jnew, jstate = jopt.apply_updates(
            JCFG, jstate, {"a": grads["a"], "b": {"c": grads["b.c"]}},
            param_dtype=jnp.float32)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert state["step"].dtype == torch.int32
        for k, path in (("a", ("a",)), ("b.c", ("b", "c"))):
            def at(tree):
                for p in path:
                    tree = tree[p]
                return np.asarray(tree)
            for mine, theirs in ((new[k], jnew), (state["master"][k],
                                                  jstate["master"]),
                                 (state["m"][k], jstate["m"]),
                                 (state["v"][k], jstate["v"])):
                want = at(theirs)
                np.testing.assert_allclose(
                    mine.numpy(), want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()))
    gn = opt.global_norm({k: torch.from_numpy(v) for k, v in grads.items()})
    np.testing.assert_allclose(
        float(gn), float(jopt.global_norm(
            {"a": grads["a"], "b": {"c": grads["b.c"]}})), rtol=1e-6)


def test_grad_clip_bounds_update():
    """tests/test_training.py:109-119 on the port."""
    cfg = opt.AdamWConfig(lr=1.0, grad_clip=1e-3, warmup_steps=0,
                          total_steps=10, weight_decay=0.0)
    state = opt.init_state({"w": torch.ones(4)})
    new, _ = opt.apply_updates(cfg, state, {"w": torch.full((4,), 1e6)},
                               param_dtype=torch.float32)
    assert np.all(np.abs(new["w"].numpy() - 1.0) <= 1.0 + 1e-6)


# ---------------------------------------------------------------------------
# compression
def test_quantize_grad_matches_jax():
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((64, 64)) * 0.01).astype(np.float32)
    err = (rng.standard_normal((64, 64)) * 1e-4).astype(np.float32)
    q, scale, new_err = comp.quantize_grad(torch.from_numpy(g),
                                           torch.from_numpy(err))
    jq, jscale, jerr = jcomp.quantize_grad(jnp.asarray(g), jnp.asarray(err))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(jerr), rtol=1e-7,
                               atol=1e-7)
    # the error-feedback identity (tests/test_training.py:58-66)
    q, scale, new_err = comp.quantize_grad(torch.from_numpy(g),
                                           torch.zeros(64, 64))
    np.testing.assert_allclose(
        (comp.dequantize_grad(q, scale) + new_err).numpy(), g, rtol=1e-5,
        atol=1e-7)


def test_compressed_psum_over_a_gloo_group_equals_the_identity(tmp_path):
    """One process in a gloo group: the all-reduce path (MAX scale,
    requantize, int32 SUM) gives the no-group path's grads and errors."""
    rng = np.random.default_rng(2)
    grads = {k: torch.from_numpy((rng.standard_normal(s) * 0.01
                                  ).astype(np.float32))
             for k, s in (("w", (8, 6)), ("b", (6,)))}
    err = {k: torch.from_numpy((rng.standard_normal(g.shape) * 1e-4
                                ).astype(np.float32))
           for k, g in grads.items()}
    want = comp.compressed_psum(grads, err, group=None)
    assert dist.is_available()
    owner = not dist.is_initialized()
    if owner:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0)
    try:
        group = dist.new_group(ranks=[0], backend="gloo")
        got = comp.compressed_psum(grads, err, group=group)
    finally:
        if owner:
            dist.destroy_process_group()
    for w, g in zip(want, got):
        for k in grads:
            assert torch.equal(w[k], g[k]), k
    jmean, jerr = jcomp.compressed_psum(
        _np_dict(grads), _np_dict(err), axis_name=None)
    for k in grads:
        np.testing.assert_allclose(want[0][k].numpy(), np.asarray(jmean[k]),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(want[1][k].numpy(), np.asarray(jerr[k]),
                                   rtol=1e-7, atol=1e-9)


def _np_dict(d):
    return {k: jnp.asarray(v.numpy()) for k, v in d.items()}


# ---------------------------------------------------------------------------
# the loss
def test_loss_matches_jax_and_masks_ignored_labels():
    """On pixtral (a vision frontend, its first positions ignored), and
    with every label ignored: 0, as the reference's, where
    ``F.cross_entropy(ignore_index=-1)`` gives NaN."""
    jm, js, model, _ = _pair("pixtral-12b")
    jloss = jax.jit(jm.loss)
    batch = _batch(model.arch)
    got = model.loss(_torch(batch))
    assert got.requires_grad and got.dtype == torch.float32
    assert float(got.detach()) == pytest.approx(
        float(jloss(js["params"], _jnp(batch))), rel=LOSS_RTOL)
    batch["labels"][:] = LOSS_IGNORE
    assert float(model.loss(_torch(batch)).detach()) == 0.0 == float(
        jloss(js["params"], _jnp(batch)))


# ---------------------------------------------------------------------------
# one train step against the reference
def _step_both(name, steps=1, microbatches=1, compression=None,
               remat="none", pair=None):
    jm, js, model, state = pair or _pair(name, remat)
    jf = jax.jit(jax_step(jm, JCFG, microbatches=microbatches,
                          grad_compression=compression))
    pf = make_train_step(model, CFG, microbatches=microbatches,
                         grad_compression=compression)
    for i in range(steps):
        batch = _batch(model.arch, i)
        js, jmet = jf(js, _jnp(batch))
        state, met = pf(state, batch)
    return jm, js, jmet, model, state, met


def _grads(model, batch):
    loss = model.loss(_torch(batch))
    return [g.detach().numpy() for g in torch.autograd.grad(
        loss, list(model.parameters()))]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_one_train_step_matches_jax(name):
    jm, js, jmet, model, state, met = _step_both(name)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=LOSS_RTOL)
    assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    tree = state_tree(model, state)
    assert int(tree["opt"]["step"]) == int(js["opt"]["step"]) == 1
    if name != HYBRID:
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=GNORM_RTOL)
        _assert_params_close(js, tree, float(jmet["lr"]))
        for k in ("m", "v"):
            _assert_trees_close(js["opt"][k], tree["opt"][k])
        return
    # The hybrid: the reference's own first moment (0.1 x the clipped
    # gradient) moves by more than GNORM_RTOL when only its rounding
    # changes (its remat="full"), so the port's is held to HYBRID_GRAD_TOL
    # per tensor.
    jmr = JaxModel(JAX_ARCHS[name].reduced(), ShardingPolicy(mesh=None),
                   param_dtype=jnp.float32, remat="full")
    jsr, _ = jax.jit(jax_step(jmr, JCFG))(
        {"params": _INIT[name], "opt": jopt.init_state(_INIT[name])},
        _jnp(_batch(model.arch)))
    m, m_remat, m_port = (_leaves(t["opt"]["m"]) for t in (js, jsr, tree))
    spread = max(float(np.abs(a - b).max() / np.abs(a).max())
                 for a, b in zip(m, m_remat))
    assert spread > GNORM_RTOL
    for a, b in zip(m, m_port):
        assert np.abs(a - b).max() <= HYBRID_GRAD_TOL * np.abs(a).max()
    assert float(met["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=HYBRID_GRAD_TOL)
