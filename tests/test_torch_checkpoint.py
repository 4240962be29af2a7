"""The port's checkpoints (``repro_torch.training.checkpoint``): the JAX
package's checkpoint tests on the port (round trip, ``LATEST``, an
interrupted save, mismatches, pruning, restart determinism), and
checkpoints crossing between the two packages leaf-exact, bf16 included:
the reference's ``save`` restored by the port, the port's by the
reference, and a reference train state one step in, restored into the
port and stepped once more by each package."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.sharding.policy import ShardingPolicy  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        to_jax_params)
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import data  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_step import (init_train_state,  # noqa: E402
                                             load_state_tree,
                                             make_train_step, state_tree)
from test_torch_training import (CFG, JCFG, _assert_params_close,  # noqa: E402
                                 _batch, _jnp, _pair)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}


def like(t):
    return jax.tree.map(lambda x: torch.empty_like(x, device="meta"), t)


def _raw(tree) -> list:
    """(shape, dtype name, bytes) of each leaf of a JAX or port tree, in
    ``jax.tree.flatten``'s order; bf16 from either package alike."""
    out = []
    for x in jax.tree.leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            name = str(x.dtype).replace("torch.", "")
            x = (x.view(torch.uint16) if x.dtype == torch.bfloat16
                 else x).numpy()
        else:
            x = np.asarray(x)
            name = str(x.dtype)
            if x.dtype == ml_dtypes.bfloat16:
                x = x.view(np.uint16)
        out.append((x.shape, name, x.tobytes()))
    return out


def _equal(a, b):
    ra, rb = _raw(a), _raw(b)
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert x == y


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
def test_roundtrip(tmp_path):
    d = str(tmp_path)
    t = tree()
    ckpt.save(d, 5, t)
    restored, step = ckpt.restore(d, like(t))
    assert step == 5
    _equal(t, restored)
    with open(os.path.join(d, "step_00000005", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves == [{"shape": [3, 4], "dtype": "float32"},
                      {"shape": [2, 2], "dtype": "bfloat16"},
                      {"shape": [], "dtype": "int32"}]


def test_latest_pointer_tracks_newest(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 1, tree())
    ckpt.save(d, 9, tree())
    assert ckpt.latest_step(d) == 9


def test_interrupted_save_never_corrupts(tmp_path):
    d = str(tmp_path)
    t = tree()
    ckpt.save(d, 3, t)
    broken = os.path.join(d, "step_00000004.tmp")
    os.makedirs(broken)
    with open(os.path.join(broken, "leaf_00000.npy"), "wb") as f:
        f.write(b"garbage")
    _, step = ckpt.restore(d, like(t))
    assert step == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), like(t))


def test_structure_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(d, {"only": torch.zeros(2)})


def test_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, tree())
    t2 = tree()
    t2["a"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, like(t2))


def test_prune_keeps_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, tree())
    ckpt.prune(d, keep=2)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                   if n.startswith("step_"))
    assert steps == [4, 5]
    _, step = ckpt.restore(d, like(tree()))
    assert step == 5


def test_training_restart_is_bit_deterministic(tmp_path):
    """Train 6 steps straight vs 3 + save + restore + 3 (into a fresh
    model and state): identical loss (tests/test_checkpoint.py:115)."""
    arch = ARCHS["gemma-2b"].reduced()
    dcfg = data.for_arch(arch, seq_len=32, global_batch=4)
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)

    def fresh():
        model = Model(arch, device="cpu", dtype=torch.float32, impl="plain")
        return model, init_train_state(
            model, torch.Generator().manual_seed(0), cfg)

    def run(model, state, lo, hi):
        step_fn = make_train_step(model, cfg)
        out = None
        for i in range(lo, hi):
            state, out = step_fn(state, data.batch_at_step(dcfg, i))
        return state, out

    _, m_direct = run(*fresh(), 0, 6)
    model, state = fresh()
    state, _ = run(model, state, 0, 3)
    ckpt.save(str(tmp_path), 3, state_tree(model, state, device="cpu"))
    model2, state2 = fresh()
    restored, step = ckpt.restore(str(tmp_path),
                                  state_tree(model2, state2, device="meta"))
    load_state_tree(model2, state2, restored)
    assert step == 3 and int(state2["opt"]["step"]) == 3
    _, m_resumed = run(model2, state2, 3, 6)
    assert float(m_direct["loss"]) == pytest.approx(
        float(m_resumed["loss"]), abs=1e-6)


# ---------------------------------------------------------------------------
# across the two packages
def _mixed(seed: int):
    """The same tree in both packages: fp32, bf16 (random values, so every
    byte counts) and int32 leaves, nested."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    c = rng.standard_normal((2, 6)).astype(ml_dtypes.bfloat16)
    d = np.int32(seed)
    jt = {"a": jnp.asarray(a), "b": {"c": jnp.asarray(c), "d": jnp.int32(d)}}
    pt = {"a": torch.from_numpy(a),
          "b": {"c": torch.from_numpy(c.view(np.uint16).copy()).view(
              torch.bfloat16), "d": torch.tensor(d)}}
    return jt, pt


def test_jax_save_port_restore(tmp_path):
    jt, pt = _mixed(1)
    jckpt.save(str(tmp_path), 4, jt)
    got, step = ckpt.restore(str(tmp_path), like(pt))
    assert step == 4
    _equal(jt, got)
    _equal(pt, got)


def test_port_save_jax_restore(tmp_path):
    jt, pt = _mixed(2)
    ckpt.save(str(tmp_path), 6, pt)
    got, step = jckpt.restore(str(tmp_path), jax.eval_shape(lambda: jt))
    assert step == 6
    _equal(jt, got)
    # the same tree makes the same manifest in both packages
    jckpt.save(str(tmp_path / "jax"), 6, jt)
    manifests = [json.load(open(os.path.join(p, "step_00000006",
                                             "manifest.json")))
                 for p in (str(tmp_path), str(tmp_path / "jax"))]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    assert manifests[0]["num_leaves"] == manifests[1]["num_leaves"] == 3


@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b", "zamba2-7b"])
def test_to_jax_params_inverts_from_jax_params_in_bf16(name):
    """MoE groups (dense + MoE layers) and the hybrid's shared attention:
    back to the reference's stacked tree, bit for bit, dtypes kept (the
    SSM's fp32 ``A_log``/``dt_bias`` in a bf16 model)."""
    def arch_of(archs):
        arch = archs[name].reduced()
        if arch.moe is None:
            return arch
        # two groups of a dense layer and an MoE layer
        return dataclasses.replace(arch, num_layers=4, moe=dataclasses.replace(
            arch.moe, moe_every=2))

    jm = JaxModel(arch_of(JAX_ARCHS), ShardingPolicy(mesh=None),
                  param_dtype=jnp.bfloat16)
    params = jax.jit(jm.init)(jax.random.key(0))
    arch = arch_of(ARCHS)
    model = Model(arch, device="cpu", dtype=torch.bfloat16, impl="plain")
    model.load_state_dict(from_jax_params(arch, jax.tree.map(np.asarray,
                                                             params)))
    back = to_jax_params(arch, model.state_dict())
    assert jax.tree.structure(jax.tree.map(lambda x: 0, back)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, params))
    _equal(params, back)
    if arch.ssm is not None:
        assert back["blocks"]["A_log"].dtype == torch.float32


def test_jax_train_state_continues_in_the_port(tmp_path):
    """A reference train state after one step, saved by the reference and
    restored into the port; then one more step in each package: equal at
    tests/test_training.py's limits.  The port's state after that step,
    saved by the port, restores into the reference leaf-exact."""
    jm, js, model, state = _pair("qwen2-7b")
    jf = jax.jit(jax_step(jm, JCFG))
    js, _ = jf(js, _jnp(_batch(model.arch, 0)))
    jckpt.save(str(tmp_path / "jax"), 1, js)
    tree_, step = ckpt.restore(str(tmp_path / "jax"),
                               state_tree(model, state, device="meta"))
    load_state_tree(model, state, tree_)
    assert step == 1 and int(state["opt"]["step"]) == 1
    _equal(js, state_tree(model, state))           # leaf-exact restore
    js, jmet = jf(js, _jnp(_batch(model.arch, 1)))
    state, met = make_train_step(model, CFG)(state, _batch(model.arch, 1))
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    tree_ = state_tree(model, state, device="cpu")
    _assert_params_close(js, tree_, 2 * JCFG.lr)
    ckpt.save(str(tmp_path / "port"), 2, tree_)
    back, step = jckpt.restore(str(tmp_path / "port"),
                               jax.eval_shape(lambda: js))
    assert step == 2
    _equal(back, tree_)
