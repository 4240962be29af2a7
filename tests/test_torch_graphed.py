"""The port's segmented decode step (``repro_torch.models.graphed``) and the
engine that serves it on a card.

On the CPU the segments run eagerly: each step must give exactly the
logits and caches of ``Model.decode_step`` (the same ops in the same
order), for every dense arch and for batch sizes that come and go, and
for a tiny Granite-4.0-H (``hybrid_moe``: segments split at its attention
layers, Mamba2 states in static buffers, its prefill written into them).
The graphs a batch size would capture are counted on the CPU too.  On a
card (``gpu`` marker) the segments replay as CUDA graphs: the engine's
tokens equal eager decoding's, in fp32 and in bf16, and every step still
calls the decode kernel's wrapper once per layer.  Also on the card, the
logit head's in-place bf16 route (``layers.logits``) against its upcast
route at qwen2-7b's and gemma-2b's full head widths."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.graphed import GraphedDecode  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

DENSE = ["gemma-2b", "granite-3-2b", "musicgen-large", "pixtral-12b",
         "qwen2-7b"]
REL_TOL = 1e-4          # as tests/test_torch_models.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name, device="cpu", dtype=torch.float32, seed=0, arch=None):
    m = Model(arch or ARCHS[name].reduced(), device=device, dtype=dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return m.init(gen)


def _tokens(arch, B, S, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, arch.vocab_size, size=(B, S))
                            ).long()


def _rel_err(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


@pytest.mark.parametrize("name", DENSE)
def test_segments_equal_decode_step_on_cpu(name):
    m = _model(name)
    S, extra, max_seq = 10, 3, 16
    dec = GraphedDecode(m, max_batch=3, max_seq=max_seq)
    assert not dec.capture                      # no graphs on the CPU
    for B, seed in ((2, 1), (3, 2), (2, 3)):    # sizes come and go
        tokens = _tokens(m.arch, B, S + extra, seed)
        full = m.forward(tokens)
        _, want_cache = m.prefill(tokens[:, :S], max_seq=max_seq)
        cache = dec.rows(B)
        assert m.prefill(tokens[:, :S], into=cache)[1] is cache
        for i in range(extra):
            tok = tokens[:, S + i:S + i + 1]
            want, want_cache = m.decode_step(want_cache, S + i, tok)
            got = dec.step(S + i, tok)
            assert torch.equal(got, want)
            assert _rel_err(got[:, 0], full[:, S + i]) < REL_TOL
        for name_kv in ("k", "v"):
            for c, w in zip(cache[name_kv], want_cache[name_kv]):
                assert torch.equal(c[:, :S + extra], w[:, :S + extra])


def test_hybrid_moe_segments_equal_decode_step_on_cpu(monkeypatch):
    """Granite-4.0-H's segments (split at its attention layers, Mamba2
    states in static buffers) after a prefill written into the static
    caches (``Model.prefill(into=)``): each step exactly the logits of
    ``Model.decode_step`` on its own padded cache, and the states and KV
    equal after it.  The segments' Mamba2 steps write the new SSD state
    into the static one in place (``ssd_out``, same storage); the model's
    own steps return a new state."""
    import _granite_tiny as tiny
    from repro_torch.models import ssm as ssm_mod
    m, _ = tiny.model_and_weights(5)
    in_place = []
    mixer = ssm_mod.ssm_mixer_decode

    def spy(h, p, arch, state, *args, ssd_out=None, **kw):
        ptr = state.ssd.data_ptr()
        out, new = mixer(h, p, arch, state, *args, ssd_out=ssd_out, **kw)
        in_place.append((ssd_out is not None, new.ssd.data_ptr() == ptr))
        return out, new

    monkeypatch.setattr(ssm_mod, "ssm_mixer_decode", spy)
    S, extra, max_seq = 9, 3, 16
    dec = GraphedDecode(m, max_batch=3, max_seq=max_seq)
    for B, seed in ((2, 1), (3, 2)):
        tokens = _tokens(m.arch, B, S + extra, seed)
        _, want_cache = m.prefill(tokens[:, :S], max_seq=max_seq)
        cache = dec.rows(B)
        _, got_cache = m.prefill(tokens[:, :S], into=cache)
        assert got_cache is cache
        for i in range(extra):
            tok = tokens[:, S + i:S + i + 1]
            want, want_cache = m.decode_step(want_cache, S + i, tok)
            assert torch.equal(dec.step(S + i, tok), want)
        for got, want in zip(cache["ssm"], want_cache["ssm"]):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        for g, w in zip(cache["k"], want_cache["k"]):
            assert torch.equal(g[:, :S + extra], w[:, :S + extra])
    n_ssm = m.arch.layer_types.count("mamba")
    assert sorted(set(in_place)) == [(False, False), (True, True)]
    assert in_place.count((True, True)) == in_place.count((False, False)) \
        == 2 * extra * n_ssm


@pytest.mark.parametrize("name", DENSE + ["granite-tiny"])
def test_capture_layout(name):
    """The graphs a batch size captures: a dense model one a segment, its
    layers + 1; the tiny Granite-4.0-H (mamba, attention, mamba) one a
    piece of each segment that holds a Mamba2 layer: start, mamba, end
    twice, 6."""
    if name == "granite-tiny":
        import _granite_tiny as tiny
        m, want = tiny.model_and_weights(5)[0], 6
    else:
        m = _model(name)
        want = m.arch.num_layers + 1
    dec = GraphedDecode(m, max_batch=2, max_seq=16)
    assert dec._batch(2).n_graphs == want


@pytest.mark.gpu
def test_graphed_hybrid_moe_engine_matches_eager_on_gpu():
    """Granite-4.0-H at its published widths, 3 layers (mamba, attention,
    mamba), bf16: the engine's graphed steps against the model's eager
    steps, logits within 2e-2 (as the dense bf16 case) and the same greedy
    tokens, one decode-kernel launch per attention layer a step; the
    captures leave ``moe.expert_rows`` as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import _granite_tiny as tiny
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.models import moe
    cfg = json.loads((tiny.REPO / "portbench/configs/"
                      "granite-4.0-h-small.json").read_text())
    cfg.update(num_hidden_layers=3, layer_types=["mamba", "attention",
                                                 "mamba"])
    m = Model(tiny.family()._arch_config(cfg), device="cuda",
              dtype=torch.bfloat16).init(torch.Generator(
                  device="cuda").manual_seed(0))
    B, S, new = 3, 12, 6
    eng = Engine(m, EngineConfig(max_batch=4, max_seq=32))
    prompts = _tokens(m.arch, B, S, 5).cuda()
    m.prefill(prompts)                      # every layer's tally exists
    before = {k: v.clone() for k, v in moe.expert_rows.items()}
    assert eng.decode_mode == "graphed" and eng._decoder() is not None
    assert all(torch.equal(moe.expert_rows[k], v) for k, v in before.items())
    logits, cache = eng.prefill(prompts)
    want_logits, want_cache = m.prefill(prompts, max_seq=32)
    tok = want_tok = logits[:, -1].argmax(-1, keepdim=True)
    n0 = dmod.launches
    for i in range(new):
        logits, cache = eng.decode_step(cache, S + i, tok)
        want_logits, want_cache = m.decode_step(want_cache, S + i, want_tok)
        assert _rel_err(logits, want_logits) < 2e-2
        tok = logits[:, -1].argmax(-1, keepdim=True)
        want_tok = want_logits[:, -1].argmax(-1, keepdim=True)
        assert torch.equal(tok, want_tok)
    assert dmod.launches - n0 == 2 * new


def test_graphed_decode_refuses_what_it_cannot_serve():
    with pytest.raises(ValueError, match="dense"):
        GraphedDecode(_model("mamba2-130m"), max_batch=2, max_seq=16)
    dec = GraphedDecode(_model("gemma-2b"), max_batch=2, max_seq=16)
    with pytest.raises(ValueError, match="batch"):
        dec.step(4, torch.zeros((3, 1), dtype=torch.long))
    with pytest.raises(ValueError, match="cache_len"):
        dec.step(16, torch.zeros((1, 1), dtype=torch.long))


def test_engine_decodes_eagerly_on_cpu():
    """On the CPU the engine keeps the padded-cache eager path."""
    eng = Engine(_model("granite-3-2b"), EngineConfig(max_batch=2,
                                                      max_seq=16))
    logits, cache = eng.prefill(_tokens(eng.model.arch, 2, 6, 4))
    assert eng._decoder() is None
    assert cache["k"][0].shape[1] == 16


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["gemma-2b", "qwen2-7b"])
def test_graphed_engine_matches_eager_on_gpu(name, dtype):
    """The engine's graphed steps against the model's eager steps on the
    card (full widths, 2 layers: the kernels take head dims 64-256): the
    same greedy tokens, logits within 1e-5 of each other in fp32 and 2e-2
    in bf16 (the graphs' GEMMs may sum in another order, rounded to bf16
    between layers), and one decode-kernel launch per layer a step.  In
    bf16 every head, eager or captured, reads its table in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.models import layers
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    routes = dict(layers.logit_routes)
    m = _model(name, device="cuda", dtype=dtype,
               arch=dataclasses.replace(ARCHS[name], num_layers=2))
    B, S, new = 3, 12, 6
    eng = Engine(m, EngineConfig(max_batch=4, max_seq=32))
    prompts = _tokens(m.arch, B, S, 5).cuda()
    logits, cache = eng.prefill(prompts)
    want_logits, want_cache = m.prefill(prompts, max_seq=32)
    tok = want_tok = logits[:, -1].argmax(-1, keepdim=True)
    n0 = dmod.launches
    for i in range(new):
        logits, cache = eng.decode_step(cache, S + i, tok)
        want_logits, want_cache = m.decode_step(want_cache, S + i, want_tok)
        assert logits.dtype == want_logits.dtype == torch.float32
        assert _rel_err(logits, want_logits) < tol
        tok = logits[:, -1].argmax(-1, keepdim=True)
        want_tok = want_logits[:, -1].argmax(-1, keepdim=True)
        assert torch.equal(tok, want_tok)
    assert dmod.launches - n0 == 2 * new * m.arch.num_layers
    got = eng.generate(prompts.cpu().numpy().astype(np.int32), max_new=new)
    assert got.shape == (B, new)
    taken = {r: layers.logit_routes[r] - n for r, n in routes.items()}
    if dtype == torch.bfloat16:
        assert taken["upcast"] == 0 and taken["bf16"] > 0
    else:
        assert taken["bf16"] == 0


# qwen2-7b's untied head [3584, 152064] at decode batches and one prefill;
# gemma-2b's tied table [256000, 2048] read through its transposed view
HEADS = [("qwen2-7b", 1, 1), ("qwen2-7b", 8, 1), ("qwen2-7b", 32, 1),
         ("qwen2-7b", 2, 64), ("gemma-2b", 8, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,S", HEADS)
def test_logits_read_the_bf16_table_in_place_on_gpu(name, B, S):
    """``layers.logits`` on bf16 operands on the card: the in-place route
    against the upcast route (the same operands in fp32), which differ
    only in summation order: within 1e-4 of the largest |logit|, the same
    argmax on every row, and the tally shows which route ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import layers
    arch = ARCHS[name]
    d, V = arch.d_model, arch.vocab_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(B * 1000 + S)
    x = torch.randn((B, S, d), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    if arch.tie_embeddings:
        table = (torch.randn((V, d), generator=gen, device="cuda") * 0.02
                 ).to(torch.bfloat16)
        head, wide = table.T, table.float().T
    else:
        head = (torch.randn((d, V), generator=gen, device="cuda") * 0.02
                ).to(torch.bfloat16)
        wide = head.float()
    n = dict(layers.logit_routes)
    with torch.no_grad():
        got = layers.logits(x, head)
        assert layers.logit_routes["bf16"] == n["bf16"] + 1
        want = layers.logits(x.float(), wide)
        assert layers.logit_routes["upcast"] == n["upcast"] + 1
    assert got.dtype == torch.float32 and got.shape == (B, S, V)
    gap = float((got - want).abs().max())
    assert gap <= 1e-4 * float(want.abs().max()), gap
    assert torch.equal(got.argmax(-1), want.argmax(-1))
