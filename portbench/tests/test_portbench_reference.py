"""The ``qwen2`` family's plain float32 reference against the port at a
tiny size on the CPU, its pieces, the seeded weights, the served-token gap
and the fp8 control."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import reference, weights
from portbench.tests.conftest import TOY_MODEL, qwen2


def _cfg(**kw) -> dict:
    cfg = copy.deepcopy(TOY_MODEL)
    cfg.update(kw)
    return cfg


def _weights(cfg: dict, seed: int) -> dict:
    return weights.all_weights(qwen2().layout(cfg), seed, "cpu",
                               weights.served_dtype(cfg))


@pytest.mark.parametrize("tied,bias", [(False, True), (True, False)])
def test_reference_matches_the_port_forward(tied, bias):
    """Same seeded weights, one sequence: the reference's logits equal the
    port's plain float32 forward (which shares no code with it)."""
    cfg = _cfg(tie_word_embeddings=tied, attention_bias=bias)
    fam = qwen2()
    model = fam.build(cfg, seed=3, device="cpu")
    model.impl = "plain"
    tokens = torch.randint(0, cfg["vocab_size"], (2, 19),
                           generator=torch.Generator().manual_seed(0))
    want = model.forward(tokens)
    got = fam.logits(cfg, _weights(cfg, 3).__getitem__,
                     [tokens[0], tokens[1]], [slice(0, 19), slice(0, 19)])
    for i in range(2):
        torch.testing.assert_close(got[i], want[i], rtol=1e-4, atol=1e-4)


def test_weights_are_the_seed_s_alone():
    cfg = _cfg()
    a, b, c = _weights(cfg, 5), _weights(cfg, 5), _weights(cfg, 6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.wq"], c["blocks.0.wq"])
    # the norm weights and biases are drawn, not zero
    assert a["blocks.1.bq"].abs().sum() > 0 and a["final_norm"].abs().sum() > 0


def test_reference_copy_equals_the_program_s(monkeypatch):
    """The weights the reference makes again hold the same values as the
    model's parameters, also where a parameter spans two chunks."""
    monkeypatch.setattr(weights, "CHUNK", 1000)
    cfg = _cfg()
    model = qwen2().build(cfg, seed=9, device="cpu")
    again = _weights(cfg, 9)
    params = dict(model.named_parameters())
    assert set(params) == set(again)
    assert all(torch.equal(params[k], again[k]) for k in again)


def test_load_refuses_another_layout():
    fam = qwen2()
    model = fam.build(_cfg(), seed=1, device="cpu")
    with pytest.raises(ValueError):
        weights.load_into(model, fam.layout(_cfg(attention_bias=False)), 1)


def test_attention_is_causal_and_grouped():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(7, 4, 8, generator=g),
               torch.randn(7, 2, 8, generator=g),
               torch.randn(7, 2, 8, generator=g))
    attention = qwen2()._attention
    out = attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[5:], v2[5:] = 0.0, 0.0
    torch.testing.assert_close(attention(q, k2, v2)[:5], out[:5])
    # head h reads kv head h // 2
    one = attention(q[:, :1], k[:, :1], v[:, :1])
    torch.testing.assert_close(out[:, :1], one)
    # blocks of query rows give the rows of one block
    for rows in (1, 3, 7):
        torch.testing.assert_close(attention(q, k, v, rows=rows), out)


def test_rope_keeps_norms_and_rms_norm_scales():
    fam = qwen2()
    x = torch.randn(5, 3, 8)
    torch.testing.assert_close(fam._rope(x, 10000.0).norm(dim=-1),
                               x.norm(dim=-1))
    y = fam._rms_norm(torch.full((4,), 3.0), torch.zeros(4), 0.0)
    torch.testing.assert_close(y, torch.ones(4))


def test_served_gaps():
    rows = torch.tensor([[0.0, 2.0, 1.0], [5.0, 4.5, 0.0]])
    gaps = reference.served_gaps(rows, torch.tensor([1, 1]))
    torch.testing.assert_close(gaps, torch.tensor([0.0, 0.5]))


def test_control_departs_where_the_program_agrees():
    """At the toy size the fp32 program's greedy tokens read a gap of 0,
    the fp8 control's well above the toy limit."""
    cfg = _cfg()
    fam = qwen2()
    weight = _weights(cfg, 4).__getitem__
    g = torch.Generator().manual_seed(2)
    cases = []
    for n in (12, 20):
        prompt = torch.randint(0, cfg["vocab_size"], (n,), generator=g)
        # greedy tokens from the reference itself
        seq = prompt.clone()
        for _ in range(6):
            row = fam.logits(cfg, weight, [seq],
                             [slice(len(seq) - 1, len(seq))])[0]
            seq = torch.cat([seq, row.argmax(-1)])
        cases.append({"prompt": prompt.numpy(), "served": seq[n:].numpy()})
    got = reference.judged_sequences(fam, cfg, weight, cases, True, "cpu")
    assert got["gap"] == 0.0 and got["tokens"] == 12
    assert got["control_gap"] > 1e-2


@pytest.mark.gpu
def test_reference_on_the_card_matches_the_cpu(cuda):
    cfg = _cfg()
    fam = qwen2()
    tokens = torch.randint(0, cfg["vocab_size"], (23,))
    w = _weights(cfg, 2)
    cpu = fam.logits(cfg, w.__getitem__, [tokens], [slice(0, 23)])[0]
    dev = fam.logits(cfg, lambda n: w[n].to(cuda), [tokens.to(cuda)],
                     [slice(0, 23)])[0]
    # TF32 is off in the reference: fp32 products on both
    torch.testing.assert_close(dev.cpu(), cpu, rtol=1e-4, atol=1e-4)
