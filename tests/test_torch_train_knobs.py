"""The training step's knobs against the JAX package's on the CPU in
fp32 at reduced sizes: microbatched accumulation, int8 error-feedback
compression (and how its gap from exact training grows with width in
both packages), and remat.  Helpers and tolerances are
``tests/test_torch_training.py``'s."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.sharding.policy import ShardingPolicy  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.training import data  # noqa: E402
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             make_train_step, state_tree)
from test_torch_training import (B, CFG, JCFG, LOSS_RTOL, S,  # noqa: E402
                                 _assert_params_close, _assert_trees_close,
                                 _batch, _grads, _jnp, _np, _pair,
                                 _step_both)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_microbatches_match_jax():
    """Two microbatches on a dense arch: the fp32 accumulation and the
    average of loss and grads."""
    jm, js, jmet, model, state, met = _step_both("granite-3-2b",
                                                 microbatches=2)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=LOSS_RTOL)
    tree = state_tree(model, state)
    _assert_params_close(js, tree, float(jmet["lr"]))
    _assert_trees_close(js["opt"]["m"], tree["opt"]["m"])
    _assert_trees_close(js["opt"]["v"], tree["opt"]["v"])


def test_int8_compression_matches_jax():
    """Three steps with int8 error feedback: the err buffers enter the
    state and track the reference's."""
    jm, js, jmet, model, state, met = _step_both("gemma-2b", steps=3,
                                                 compression="int8")
    assert "err" in state and "err" in js
    tree = state_tree(model, state)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=LOSS_RTOL)
    _assert_params_close(js, tree, 3 * JCFG.lr)
    _assert_trees_close(js["err"], tree["err"])


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_none_and_jax(remat):
    """The port's remat gives its own un-rematted loss and grads, and one
    step equals the reference's step under the same remat."""
    name = "qwen2-7b"
    pair = _pair(name, remat)
    model = pair[2]
    batch = _batch(model.arch, 0)
    plain = Model(model.arch, device="cpu", dtype=torch.float32,
                  impl="plain")
    plain.load_state_dict(model.state_dict())
    plain.requires_grad_(True)
    for a, b in zip(_grads(plain, batch), _grads(model, batch)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
    jm, js, jmet, model, state, met = _step_both(name, pair=pair)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                               rel=LOSS_RTOL)
    _assert_params_close(js, state_tree(model, state), float(jmet["lr"]))


@pytest.mark.parametrize("d,vocab,within_rule", [(64, 512, True),
                                                  (128, 2048, False)])
def test_int8_gap_grows_with_width_as_the_reference(d, vocab, within_rule):
    """tests/test_training.py's 0.12 (int8 against exact after 8 steps)
    holds at its reduced width (d 64, vocab 512) only: at d 128, vocab
    2,048 the reference's own gap passes it (one scale a stacked leaf
    zeroes most of a wider gradient).  At both, the port's gap is the
    reference's."""
    arch = dataclasses.replace(ARCHS["granite-3-2b"].reduced(), d_model=d,
                               vocab_size=vocab, d_ff=2 * d, head_dim=d // 4)
    jarch = dataclasses.replace(JAX_ARCHS["granite-3-2b"].reduced(),
                                d_model=d, vocab_size=vocab, d_ff=2 * d,
                                head_dim=d // 4)
    assert dataclasses.asdict(arch) == dataclasses.asdict(jarch)
    jm = JaxModel(jarch, ShardingPolicy(mesh=None), param_dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(0))
    dcfg = data.for_arch(arch, S, B)
    last = {}
    for kind in (None, "int8"):
        js = {"params": params, "opt": jopt.init_state(params)}
        jf = jax.jit(jax_step(jm, JCFG, grad_compression=kind))
        model = Model(arch, device="cpu", dtype=torch.float32, impl="plain")
        model.load_state_dict(from_jax_params(arch, _np(params)))
        state = init_train_state(model, None, CFG)
        pf = make_train_step(model, CFG, grad_compression=kind)
        for i in range(8):
            batch = data.batch_at_step(dcfg, i)
            js, jmet = jf(js, _jnp(batch))
            state, met = pf(state, batch)
        last[kind] = float(jmet["loss"]), float(met["loss"])
    jgap = abs(last[None][0] - last["int8"][0])
    pgap = abs(last[None][1] - last["int8"][1])
    assert (jgap < 0.12) == within_rule, jgap
    assert abs(pgap - jgap) < 0.01, (jgap, pgap)
    for jl, pl in last.values():
        assert pl == pytest.approx(jl, rel=1e-3)
