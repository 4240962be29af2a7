"""The port's dense-family models (``repro_torch.models``) against the JAX
package's ``Model``, on the CPU in fp32 with converted weights."""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.kvcache import cache_bytes as jax_cache_bytes  # noqa: E402
from repro.sharding.policy import ShardingPolicy  # noqa: E402
from repro_torch.configs import ARCHS, ArchConfig, get_arch  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.kvcache import cache_bytes  # noqa: E402

DENSE = ["gemma-2b", "granite-3-2b", "musicgen-large", "pixtral-12b",
         "qwen2-7b"]
SSM = ["mamba2-130m", "zamba2-7b"]
REL_TOL = 1e-4          # as tests/test_models_smoke.py:84


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread is enough, and keeps
    this file from crowding the tests that run beside it in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.fixture(scope="module")
def converted():
    """name -> (jax model, jax params, port model with the same weights)."""
    cache = {}

    def get(name):
        if name not in cache:
            jm = JaxModel(JAX_ARCHS[name].reduced(), ShardingPolicy(mesh=None),
                          param_dtype=jnp.float32)
            params = jm.init(jax.random.key(0))
            arch = ARCHS[name].reduced()
            m = Model(arch, device="cpu", dtype=torch.float32)
            m.load_state_dict(from_jax_params(
                arch, jax.tree.map(np.asarray, params)))
            cache[name] = (jm, params, m)
        return cache[name]
    return get


def _inputs(arch, B, S, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, arch.vocab_size, size=(B, S)).astype(np.int32)
    fe = None
    if arch.frontend != "none":
        fe = (rng.standard_normal((B, 8, arch.d_model)) * 0.5
              ).astype(np.float32)
    return tokens, fe


def _torch(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("name", DENSE + SSM)
def test_arch_copy_matches_reference(name):
    assert dataclasses.asdict(ARCHS[name]) == \
        dataclasses.asdict(JAX_ARCHS[name])
    assert dataclasses.asdict(ARCHS[name].reduced()) == \
        dataclasses.asdict(JAX_ARCHS[name].reduced())
    assert ARCHS[name].param_count() == JAX_ARCHS[name].param_count()
    assert get_arch(name + "-reduced") == ARCHS[name].reduced()
    for batch, seq in [(8, 1024), (1, 4096)]:
        assert cache_bytes(ARCHS[name], batch, seq) == \
            jax_cache_bytes(JAX_ARCHS[name], batch, seq)


def test_layers_match_jax():
    """The dense pieces one by one: (1 + w) RMSNorm, split-half RoPE at
    qwen2's theta, tanh GeGLU and SwiGLU, repeat_kv, fp32 logits."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) for _ in "gu")
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    T = torch.from_numpy
    pairs = [
        (tl.rms_norm(T(x), T(w)), jl.rms_norm(x, w)),
        (tl.apply_rope(T(x), T(pos), 1e6), jl.apply_rope(x, pos, 1e6)),
        (tl.repeat_kv(T(x), 3), jl.repeat_kv(x, 3)),
        (tl.logits(T(h), T(wd.T.copy())), jl.logits(h, wd.T)),
    ] + [(tl.gated_mlp(T(h), T(wg), T(wu), T(wd), act),
          jl.gated_mlp(h, wg, wu, wd, act)) for act in ("silu", "gelu")]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["qwen2-7b", "granite-3-2b"])
def test_from_jax_params_round_trips(name, converted):
    jm, params, m = converted(name)
    sd = m.state_dict()
    want = from_jax_params(m.arch, jax.tree.map(np.asarray, params))
    assert set(sd) == set(want)
    for key, t in sd.items():
        assert tuple(t.shape) == tuple(want[key].shape), key
        assert torch.equal(t, want[key]), key
    # per-layer slices keep the JAX layouts
    L = m.arch.num_layers
    assert np.array_equal(sd[f"blocks.{L - 1}.wq"].numpy(),
                          np.asarray(params["blocks"]["wq"][L - 1]))
    assert sd["blocks.0.wo"].shape == params["blocks"]["wo"].shape[1:]


@pytest.mark.parametrize("name", DENSE)
def test_forward_matches_jax(name, converted):
    jm, params, m = converted(name)
    tokens, fe = _inputs(m.arch, 2, 24)
    want = np.asarray(jm.forward(params, jnp.asarray(tokens),
                                 None if fe is None else jnp.asarray(fe)))
    got = m.forward(torch.from_numpy(tokens).long(), _torch(fe)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel_err(got, want) < REL_TOL


def test_forward_matches_jax_pallas_attention(converted):
    """qwen2 (GQA + QKV bias) against the JAX model's Pallas attention in
    interpret mode."""
    _, params, m = converted("qwen2-7b")
    jm = JaxModel(JAX_ARCHS["qwen2-7b"].reduced(), ShardingPolicy(mesh=None),
                  param_dtype=jnp.float32, attn_impl="pallas")
    tokens, _ = _inputs(m.arch, 2, 16, seed=1)
    want = np.asarray(jm.forward(params, jnp.asarray(tokens)))
    got = m.forward(torch.from_numpy(tokens).long()).numpy()
    assert _rel_err(got, want) < REL_TOL


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_full_forward(name, converted):
    _, _, m = converted(name)
    B, S, extra = 2, 20, 3
    tokens, fe = _inputs(m.arch, B, S + extra, seed=2)
    tokens = torch.from_numpy(tokens).long()
    full = m.forward(tokens, _torch(fe)).numpy()
    logits, cache = m.prefill(tokens[:, :S], _torch(fe), max_seq=S + extra)
    assert _rel_err(logits[:, 0].numpy(), full[:, S - 1]) < REL_TOL
    assert cache["k"][0].shape == (B, S + extra, m.arch.num_kv_heads,
                                   m.arch.head_dim)
    for i in range(extra):
        dl, cache = m.decode_step(cache, S + i, tokens[:, S + i:S + i + 1])
        assert _rel_err(dl[:, 0].numpy(), full[:, S + i]) < REL_TOL


def test_full_width_qwen2_on_meta_device():
    """Full-width qwen2-7b builds on the meta device without allocating and
    holds exactly ArchConfig.param_count() parameters."""
    arch = get_arch("qwen2-7b")
    m = Model(arch, device="meta")
    assert all(p.is_meta for p in m.parameters())
    assert sum(p.numel() for p in m.parameters()) == arch.param_count()[0]
    assert m.blocks[0].wq.shape == (3584, 28, 128)
    assert m.lm_head.shape == (3584, 152064)


def test_model_refuses_unported_families_and_missing_card():
    """A family that neither package has is refused (the reference at init),
    as are an unknown ``impl`` and a missing card."""
    rnn = ArchConfig(name="rnn-x", family="rnn", num_layers=2, d_model=64,
                     num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512)
    with pytest.raises(ValueError, match="unknown family"):
        JaxModel(rnn, ShardingPolicy(mesh=None)).init(jax.random.key(0))
    with pytest.raises(ValueError, match="unknown family"):
        Model(rnn, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        Model(ARCHS["gemma-2b"].reduced(), device="cpu", impl="xla")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(ARCHS["gemma-2b"].reduced())


def test_plain_and_kernel_impls_agree_on_cpu(converted):
    """On CPU tensors both attention paths are the plain versions."""
    _, _, m = converted("granite-3-2b")
    tokens = torch.from_numpy(_inputs(m.arch, 2, 12, seed=3)[0]).long()
    plain = Model(m.arch, device="cpu", dtype=torch.float32,
                  impl="plain")
    plain.load_state_dict(m.state_dict())
    assert torch.equal(m.forward(tokens), plain.forward(tokens))


def test_port_imports_neither_jax_nor_repro():
    """The port stands alone: importing every module of it (and the chip
    smoke script) loads no ``jax`` and no ``repro`` module."""
    root = os.path.join(os.path.dirname(__file__), "..")
    code = (
        "import pkgutil, sys, repro_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "for m in ('repro_torch.models.ssm', 'repro_torch.kernels.ssd_scan',\n"
        "          'repro_torch.configs.zamba2_7b', 'repro_torch.models.moe',\n"
        "          'repro_torch.configs.shapes',\n"
        "          'repro_torch.training.train_step',\n"
        "          'repro_torch.training.checkpoint',\n"
        "          'repro_torch.configs.llama4_maverick_400b_a17b'):\n"
        "    assert m in sys.modules, m\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src"), root]))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports_of(source: str, filename: str = "<probe>"):
    """Every module an ``import`` or ``from ... import`` in ``source``
    names, wherever it stands: at the top, inside a function, under
    ``TYPE_CHECKING``.  A relative import names its package's module."""
    names = []
    for node in ast.walk(ast.parse(source, filename=filename)):
        if isinstance(node, ast.Import):
            names += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                names.append((node.lineno, "repro_torch"))
            elif node.module:
                names.append((node.lineno, node.module))
    return names


def test_port_sources_import_neither_jax_nor_repro():
    """A scan of the source of every module of the port and of the chip
    smoke script: no import of ``jax`` or of the JAX package ``repro``
    anywhere, not even one that never runs at import time."""
    root = os.path.join(os.path.dirname(__file__), "..")
    pkg = os.path.join(root, "src", "repro_torch")
    paths = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
             for f in fs if f.endswith(".py")]
    paths.append(os.path.join(root, "chip_smoke.py"))
    assert len(paths) > 40
    for module in ("models/moe.py", "configs/shapes.py",
                   "configs/llama4_scout_17b_a16e.py",
                   "configs/llama4_maverick_400b_a17b.py",
                   "configs/deepseek_67b.py", "training/__init__.py",
                   "training/data.py", "training/optimizer.py",
                   "training/compression.py", "training/train_step.py",
                   "training/checkpoint.py", "launch/train.py"):
        assert os.path.join(pkg, module) in paths, module
    bad = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            bad += [f"{os.path.relpath(p, root)}:{line}: {name}"
                    for line, name in _imports_of(f.read(), p)
                    if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    # the scan sees imports inside functions and under TYPE_CHECKING
    probe = ("from typing import TYPE_CHECKING\n"
             "if TYPE_CHECKING:\n    from repro.core.milp import PlanConfig\n"
             "def f():\n    import jax.numpy as jnp\n")
    assert [n for _, n in _imports_of(probe)][1:] == ["repro.core.milp",
                                                      "jax.numpy"]
