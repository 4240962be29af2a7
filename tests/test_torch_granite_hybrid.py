"""The port's ``hybrid_moe`` family (IBM Granite-4.0-H: Mamba2 and NoPE
attention mixers, each layer then a dropless MoE block) at a tiny size on
the CPU, against the benchmark's plain float32 reference
(``portbench/arch/granitemoehybrid.py``), and that reference against
``transformers``' published model.

Tolerance of the port against the reference, both fp32: the two sum in
other orders (the SSD's chunked dual form against the reference's step-by-
step recurrence, the grouped expert products against one product an
expert, the attention kernel's plain version against an einsum), which
leaves the logits ~1e-6 of their largest value apart; ``REL`` allows ten
times that.  Every knocked-out multiplier or per-head norm moves them by
1e-2 of it or more.
"""
import dataclasses

import pytest
import torch

import _granite_tiny as tiny
from repro_torch.configs.base import GraniteHybridConfig, MoEConfig
from repro_torch.models import Model, kvcache, moe
from repro_torch.serving import Engine, EngineConfig

REL = 1e-5


def _tokens(seed: int, B: int, S: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, tiny.TINY["vocab_size"], (B, S), generator=g)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |difference| over the reference's largest |logit|."""
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def built():
    return tiny.model_and_weights(5)


def test_param_count_and_caches(built):
    model, _ = built
    arch = model.arch
    assert sum(p.numel() for p in model.parameters()) == \
        arch.param_count()[0]
    assert kvcache.num_attn_applications(arch) == 1
    assert kvcache.num_ssm_layers(arch) == 2
    cache = model.init_cache(2, 16)
    assert len(cache["k"]) == 1 and len(cache["ssm"]) == 2
    assert kvcache.cache_bytes(arch, 2, 16, 4) == sum(
        t.numel() * t.element_size() for t in
        cache["k"] + cache["v"] + [x for s in cache["ssm"] for x in s])


def test_init_draws_every_parameter():
    """``Model.init`` fills the family's blocks: normals at each block
    kind's scales, zeros for norms and biases, the Mamba2 constants."""
    model = Model(tiny.family()._arch_config(tiny.TINY), device="cpu",
                  dtype=torch.float32).init(torch.Generator().manual_seed(0))
    mamba, attn = model.blocks[0], model.blocks[1]
    assert float(mamba.D.sum()) == mamba.D.numel()
    assert float(mamba.conv_x_bias.abs().sum()) == 0.0
    for blk in (mamba, attn):
        assert float(blk.we_g.std()) == pytest.approx(64 ** -0.5, rel=0.1)
        assert float(blk.ws_d.std()) == pytest.approx(48 ** -0.5, rel=0.1)
    assert torch.isfinite(model(_tokens(0, 1, 8))).all()


def test_prefill_and_decode_match_the_reference(built):
    """Full forward, and prefill then decode through the cache, against
    the reference's full forward over the same rows."""
    model, w = built
    tok = _tokens(0, 2, 24)
    ref = tiny.reference(w, [tok[0], tok[1]], [slice(0, 24)] * 2)
    full = model(tok)
    for b in range(2):
        assert _gap(full[b], ref[b]) < REL
    logits, cache = model.prefill(tok[:, :10], max_seq=32)
    steps = [logits[:, 0]]
    for t in range(10, 24):
        lg, cache = model.decode_step(cache, t, tok[:, t:t + 1])
        steps.append(lg[:, 0])
    dec = torch.stack(steps, 1)
    for b in range(2):
        assert _gap(dec[b], ref[b][9:]) < REL


def test_engine_serves_what_the_reference_puts_first(built):
    """``Engine.generate`` on left-padded prompts: every served token is
    the reference's best at its row, to rounding."""
    model, w = built
    eng = Engine(model, EngineConfig(max_batch=4, max_seq=64))
    assert eng.decode_mode == "eager"
    prompts = _tokens(1, 3, 12)
    prompts[0, :4] = 0
    out = eng.generate(prompts.numpy(), max_new=6)
    seqs = [torch.cat([prompts[b], torch.as_tensor(out[b, :-1]).long()])
            for b in range(3)]
    ref = tiny.reference(w, seqs, [slice(11, 17)] * 3)
    for b in range(3):
        best = ref[b].max(-1).values
        got = ref[b].gather(-1, torch.as_tensor(out[b]).long()[:, None])[:, 0]
        assert float((best - got).max()) <= REL * float(ref[b].abs().max())


@pytest.mark.parametrize("knock", ["embedding_multiplier",
                                   "attention_multiplier",
                                   "residual_multiplier", "logits_scaling",
                                   "gate_norm_groups"])
def test_each_multiplier_and_the_grouped_norm_are_needed(built, knock):
    """The port with one of Granite's multipliers off (1, or the default
    1/sqrt(hd) attention scale), or with the gated norm per head again,
    fails the comparison."""
    model, w = built
    tok = _tokens(2, 1, 24)
    ref = tiny.reference(w, [tok[0]], [slice(0, 24)])[0]
    off = {"attention_multiplier": 0.0, "gate_norm_groups": 0}.get(knock, 1.0)
    arch = model.arch
    try:
        model.arch = _replace(arch, **{knock: off})
        assert _gap(model(tok)[0], ref) > 100 * REL
    finally:
        model.arch = arch
    assert _gap(model(tok)[0], ref) < REL


def _replace(arch, **kw):
    """``arch`` with fields changed, past ``__post_init__``'s checks (a
    per-head norm is not a GraniteHybridConfig the family accepts)."""
    new = dataclasses.replace(arch)
    for k, v in kw.items():
        object.__setattr__(new, k, v)
    return new


def _moe_block(built):
    model, _ = built
    i = model.arch.layer_types.index("attention")
    return model.blocks[i], model.arch


def test_dropless_equals_capacity_that_drops_nothing(built):
    """At capacity factor E/K no row is dropped, and the grouped and
    global capacity dispatches give the dropless one's rows (fp32: the
    expert products summed in other orders)."""
    blk, arch = _moe_block(built)
    m = arch.moe
    roomy = dataclasses.replace(arch, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.experts_per_token))
    h = torch.randn(2, 64, arch.d_model, generator=torch.Generator()
                    .manual_seed(3))
    want = moe.moe_mlp(h, blk, arch, "dropless")
    for dispatch in ("grouped", "global"):
        got = moe.moe_mlp(h, blk, roomy, dispatch)
        assert _gap(got, want) < REL, dispatch
    # a capacity that drops rows does not
    tight = dataclasses.replace(arch, moe=dataclasses.replace(
        m, capacity_factor=0.25))
    assert _gap(moe.moe_mlp(h, blk, tight, "grouped"), want) > 100 * REL


def test_the_family_routes_dropless_and_tallies_its_rows(built, monkeypatch):
    """Every MoE call of the family takes the dropless route (``auto``);
    ``expert_rows`` sums to the routed pairs, N K, chunked or not."""
    model, _ = built
    before = dict(moe.moe_routes)
    monkeypatch.setattr(moe, "expert_rows", {})
    tok = _tokens(4, 2, 9)
    model(tok)
    L, K = model.arch.num_layers, model.arch.moe.experts_per_token
    assert moe.moe_routes["dropless"] - before["dropless"] == L
    assert moe.moe_routes["capacity"] == before["capacity"]
    assert sorted(moe.expert_rows) == list(range(L))
    for rows in moe.expert_rows.values():
        assert rows.dtype == torch.int64 and int(rows.sum()) == 2 * 9 * K
    blk, arch = _moe_block(built)
    h = torch.randn(2, 9, arch.d_model)
    whole = moe.moe_mlp(h, blk, arch, "auto", layer="x")
    monkeypatch.setattr(moe, "DROPLESS_TOKENS", 5)
    chunked = moe.moe_mlp(h, blk, arch, "auto", layer="y")
    assert _gap(chunked, whole) < REL      # products of other row blocks
    assert int(moe.expert_rows["y"].sum()) == int(
        moe.expert_rows["x"].sum()) == 18 * K


def test_config_refuses_what_the_family_does_not_run():
    kw = dict(name="g", family="hybrid_moe", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=0, vocab_size=512,
              moe=MoEConfig(8, 2, 32), ssm=tiny_ssm())
    with pytest.raises(ValueError, match="layer_types"):
        GraniteHybridConfig(**kw, layer_types=("mamba",))
    with pytest.raises(ValueError, match="layer_types"):
        GraniteHybridConfig(**kw, layer_types=("mamba", "mlp"))
    with pytest.raises(ValueError, match="hybrid_moe"):
        GraniteHybridConfig(**dict(kw, family="moe"),
                            layer_types=("mamba", "attention"))
    arch = GraniteHybridConfig(**kw, layer_types=("mamba", "attention"))
    assert not arch.rope and arch.moe_dropless
    # the JAX package has no such family: nothing converts to or from it
    from repro_torch.models import convert
    with pytest.raises(ValueError, match="unknown family"):
        convert.from_jax_params(arch, {})


def tiny_ssm():
    from repro_torch.configs.base import SSMConfig
    return SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4)


def test_reference_matches_transformers():
    """The plain reference against ``transformers``' published
    ``GraniteMoeHybridForCausalLM`` loaded with the same seeded weights,
    name by name: fp32 rounding apart (summation orders only)."""
    tr = pytest.importorskip("transformers")
    from transformers.models.granitemoehybrid import (
        GraniteMoeHybridConfig, GraniteMoeHybridForCausalLM)
    c = tiny.TINY
    hf = GraniteMoeHybridConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"],
        rms_norm_eps=c["rms_norm_eps"],
        embedding_multiplier=c["embedding_multiplier"],
        logits_scaling=c["logits_scaling"],
        residual_multiplier=c["residual_multiplier"],
        attention_multiplier=c["attention_multiplier"],
        num_local_experts=c["num_local_experts"],
        num_experts_per_tok=c["num_experts_per_tok"],
        shared_intermediate_size=c["shared_intermediate_size"],
        position_embedding_type="nope", layer_types=c["layer_types"],
        mamba_n_heads=c["mamba_n_heads"], mamba_n_groups=1,
        mamba_d_state=c["mamba_d_state"], mamba_d_head=c["mamba_d_head"],
        mamba_d_conv=c["mamba_d_conv"], mamba_expand=c["mamba_expand"],
        mamba_chunk_size=c["mamba_chunk_size"], mamba_conv_bias=True,
        mamba_proj_bias=False, attention_bias=False,
        tie_word_embeddings=True)
    hf._attn_implementation = "eager"
    ref_model = GraniteMoeHybridForCausalLM(hf).eval()
    _, w = tiny.model_and_weights(5)
    ref_model.load_state_dict(_hf_state(w, c), strict=False)
    assert ref_model.lm_head.weight.data_ptr() == \
        ref_model.model.embed_tokens.weight.data_ptr()
    tok = _tokens(6, 2, 40)
    with torch.no_grad():
        got = ref_model(tok).logits
    want = tiny.reference(w, [tok[0], tok[1]], [slice(0, 40)] * 2)
    for b in range(2):
        assert _gap(got[b], want[b]) < REL
    assert tr.__version__


def _hf_state(w: dict, c: dict) -> dict:
    """The seeded weights under ``transformers``' names and layouts."""
    d = c["hidden_size"]
    di = c["mamba_n_heads"] * c["mamba_d_head"]
    st = {"model.embed_tokens.weight": w["embed"],
          "model.norm.weight": 1 + w["final_norm"]}
    for i, kind in enumerate(c["layer_types"]):
        p, q = f"blocks.{i}.", f"model.layers.{i}."
        if kind == "mamba":
            cw = c["mamba_d_conv"]
            st[q + "input_layernorm.weight"] = 1 + w[p + "ssm_norm"]
            st[q + "mamba.in_proj.weight"] = torch.cat(
                [w[p + "wz"].reshape(d, di), w[p + "wx"].reshape(d, di),
                 w[p + "wB"], w[p + "wC"], w[p + "wdt"]], -1).t()
            st[q + "mamba.conv1d.weight"] = torch.cat(
                [w[p + "conv_x"].reshape(cw, di), w[p + "conv_B"],
                 w[p + "conv_C"]], -1).t()[:, None, :]
            st[q + "mamba.conv1d.bias"] = torch.cat(
                [w[p + "conv_x_bias"].reshape(di), w[p + "conv_B_bias"],
                 w[p + "conv_C_bias"]])
            for n in ("dt_bias", "A_log", "D"):
                st[q + "mamba." + n] = w[p + n]
            st[q + "mamba.norm.weight"] = 1 + w[p + "gate_norm"].reshape(di)
            st[q + "mamba.out_proj.weight"] = w[p + "wo"].reshape(di, d).t()
        else:
            st[q + "input_layernorm.weight"] = 1 + w[p + "attn_norm"]
            for n in ("q", "k", "v"):
                st[q + f"self_attn.{n}_proj.weight"] = \
                    w[p + f"w{n}"].reshape(d, -1).t()
            st[q + "self_attn.o_proj.weight"] = w[p + "wo"].reshape(-1, d).t()
        st[q + "post_attention_layernorm.weight"] = 1 + w[p + "moe_norm"]
        st[q + "block_sparse_moe.router.layer.weight"] = w[p + "router"].t()
        st[q + "block_sparse_moe.input_linear.weight"] = torch.cat(
            [w[p + "we_g"], w[p + "we_u"]], -1).transpose(1, 2)
        st[q + "block_sparse_moe.output_linear.weight"] = \
            w[p + "we_d"].transpose(1, 2)
        st[q + "shared_mlp.input_linear.weight"] = torch.cat(
            [w[p + "ws_g"], w[p + "ws_u"]], -1).t()
        st[q + "shared_mlp.output_linear.weight"] = w[p + "ws_d"].t()
    return {k: v.contiguous() for k, v in st.items()}
