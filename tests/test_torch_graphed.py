"""The port's segmented decode step (``repro_torch.models.graphed``) and the
engine that serves it on a card.

On the CPU the segments run eagerly: each step must give exactly the
logits and caches of ``Model.decode_step`` (the same ops in the same
order), for every dense arch and for batch sizes that come and go.  On a
card (``gpu`` marker) the segments replay as CUDA graphs: the engine's
tokens equal eager decoding's, and every step still calls the decode
kernel's wrapper once per layer."""
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
        _, cache = m.prefill(tokens[:, :S])
        cache = dec.load(cache, S)
        for i in range(extra):
            tok = tokens[:, S + i:S + i + 1]
            want, want_cache = m.decode_step(want_cache, S + i, tok)
            got = dec.step(S + i, tok)
            assert torch.equal(got, want)
            assert _rel_err(got[:, 0], full[:, S + i]) < REL_TOL
        for name_kv in ("k", "v"):
            for c, w in zip(cache[name_kv], want_cache[name_kv]):
                assert torch.equal(c[:, :S + extra], w[:, :S + extra])


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
@pytest.mark.parametrize("name", ["gemma-2b", "qwen2-7b"])
def test_graphed_engine_matches_eager_on_gpu(name):
    """The engine's graphed steps against the model's eager steps on the
    card (fp32, full widths, 2 layers: the kernels take head dims 64-256):
    the same greedy tokens, logits within 1e-5 of each other, and one
    decode-kernel launch per layer a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import decode_attention as dmod
    m = _model(name, device="cuda",
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
        assert _rel_err(logits, want_logits) < 1e-5
        tok = logits[:, -1].argmax(-1, keepdim=True)
        want_tok = want_logits[:, -1].argmax(-1, keepdim=True)
        assert torch.equal(tok, want_tok)
    assert dmod.launches - n0 == 2 * new * m.arch.num_layers
    got = eng.generate(prompts.cpu().numpy().astype(np.int32), max_new=new)
    assert got.shape == (B, new)
