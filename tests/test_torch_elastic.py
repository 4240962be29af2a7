"""The port's elastic meshes (``repro_torch.training.elastic``) and training
on a mesh, against the JAX package.

``viable_mesh_shape`` and ``reshard_plan`` are held to the reference's
(the port's meshes over the ``fake`` process group, the reference's on its
test's ``FakeMesh``).  Then reduced granite-3-2b trains 3 steps on 4
spawned gloo ranks (a 2x2 ``("data", "model")`` mesh, the training policy:
``embed`` storage-sharded over ``data``) against the reference's
``make_train_step`` at ``mesh=None``, at ``tests/test_torch_training.py``'s
tolerances, and a checkpoint of its state, saved unsharded, is restored
onto the mesh with placements and takes the next step as the state it was
saved from does.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import _torch_ranks  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.sharding.policy import ShardingPolicy  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import elastic as jel  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.training import elastic as tel  # noqa: E402
from test_sharding import FakeMesh  # noqa: E402
from test_torch_training import (B, GNORM_RTOL, JCFG, LOSS_RTOL,  # noqa: E402
                                 S, _assert_params_close)

STEPS = 3


@pytest.fixture
def fake_world():
    """A 4-rank ``fake`` default group in this process, destroyed when the
    test ends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("prefer_pods", [None, 1, 2, 3, 4])
def test_viable_mesh_shape_matches_reference(prefer_pods):
    for n in (1, 2, 3, 4, 8, 15, 16, 31, 64, 255, 256, 511, 512):
        for mp in (1, 2, 4, 8, 16, 32):
            try:
                want = jel.viable_mesh_shape(n, mp, prefer_pods)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    tel.viable_mesh_shape(n, mp, prefer_pods)
                continue
            assert tel.viable_mesh_shape(n, mp, prefer_pods) == want


def test_reshard_plan_matches_reference(fake_world):
    old = tel.make_elastic_mesh(2, device_type="cpu")
    new = tel.make_elastic_mesh(2, ranks=[0, 1], device_type="cpu")
    assert (tuple(old.shape), old.mesh_dim_names) == ((2, 2),
                                                      ("data", "model"))
    assert tuple(new.shape) == (1, 2)
    want = jel.reshard_plan(FakeMesh({"data": 2, "model": 2}),
                            FakeMesh({"data": 1, "model": 2}))
    assert tel.reshard_plan(old, new) == want
    assert want == {"old_devices": 4, "new_devices": 2, "old_dp": 2,
                    "new_dp": 1, "model_parallel_unchanged": True}


def test_elastic_mesh_prefers_pods_and_drops_stragglers(fake_world):
    m = tel.make_elastic_mesh(1, prefer_pods=2, device_type="cpu")
    assert (tuple(m.shape), m.mesh_dim_names) == ((2, 2, 1),
                                                  ("pod", "data", "model"))
    m = tel.make_elastic_mesh(2, ranks=[0, 1, 2], device_type="cpu")
    assert tuple(m.shape) == (1, 2)
    with pytest.raises(ValueError, match="cannot host"):
        tel.make_elastic_mesh(8, device_type="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Reduced granite-3-2b: the reference's state after each of 4 steps at
    ``mesh=None``, and the ranks' sharded run (one spawn)."""
    work = str(tmp_path_factory.mktemp("train_ranks"))
    name = "granite-3-2b"
    jm = JaxModel(JAX_ARCHS[name].reduced(), ShardingPolicy(mesh=None),
                  param_dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.key(0))
    arch = ARCHS[name].reduced()
    torch.save({"arch": name, "batch": B, "seq_len": S, "steps": STEPS,
                "adamw": {"lr": JCFG.lr, "warmup_steps": JCFG.warmup_steps,
                          "total_steps": JCFG.total_steps},
                "weights": {k: v.clone() for k, v in from_jax_params(
                    arch, jax.tree.map(np.asarray, params)).items()}},
               os.path.join(work, "train_in.pt"))
    ranks = _torch_ranks.start(_torch_ranks.train, work)
    step = jax.jit(jts.make_train_step(jm, JCFG))
    dcfg = jdata.for_arch(jm.arch, S, B)
    state = {"params": params, "opt": jopt.init_state(params)}
    metrics, states = [], []
    for i in range(STEPS + 1):
        batch = {k: jnp.asarray(v)
                 for k, v in jdata.batch_at_step(dcfg, i).items()}
        state, met = step(state, batch)
        metrics.append(jax.tree.map(float, met))
        states.append(jax.tree.map(np.asarray, state))
    _torch_ranks.wait(ranks)
    assert not dist.is_initialized()
    got = torch.load(os.path.join(work, "train_out.pt"), weights_only=False)
    return got, metrics, states


def test_sharded_training_matches_jax(trained):
    got, metrics, states = trained
    assert got["rules"]["embed"] == ("data",)      # storage-sharded
    assert got["embed_placements"] == ["Shard(dim=1)", "Shard(dim=0)"]
    for i in range(STEPS):
        np.testing.assert_allclose(got["losses"][i], metrics[i]["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["gnorms"][i], metrics[i]["grad_norm"],
                                   rtol=GNORM_RTOL)
    lr_sum = sum(m["lr"] for m in metrics[:STEPS])
    _assert_params_close(states[STEPS - 1], got["tree"], lr_sum)
    assert int(got["tree"]["opt"]["step"]) == STEPS


def test_restore_onto_the_mesh_continues_the_run(trained):
    got, metrics, _ = trained
    assert got["restored_at"] == STEPS
    assert got["restored_placed"] == "(Shard(dim=1), Shard(dim=0))"
    assert got["restored_loss"] == got["next_loss"]
    np.testing.assert_allclose(got["next_loss"], metrics[STEPS]["loss"],
                               rtol=LOSS_RTOL)
