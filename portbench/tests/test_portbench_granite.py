"""The ``granitemoehybrid`` family file and the cell
``granite-4.0-h-small.decode-heavy``: its layout, FLOPs and kernel work
pinned at the published widths, its three readers, its files found by
name, and a whole run of a tiny configuration of the family on the CPU
(the program's tokens pass the limit, the fp8 control in its place does
not)."""
from __future__ import annotations

import json
import math

import pytest

from portbench import harness
from portbench.tests.conftest import REPO, make_root, run_cell

CELL = "granite-4.0-h-small.decode-heavy"
GRANITE = json.loads(
    (REPO / "portbench/configs/granite-4.0-h-small.json").read_text())
READERS = ("moe_experts_roofline", "ssd_scan_roofline", "moe.expert_skew_pct")
# Granite-4.0-H's keys at d 64: one period of the layer pattern (mamba,
# attention, mamba), 8 experts top-2
TINY = dict(GRANITE, name="toygranite", hidden_size=64,
            num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=8,
            mamba_d_head=16, mamba_d_state=16, num_local_experts=8,
            num_experts_per_tok=2, intermediate_size=32,
            shared_intermediate_size=48, vocab_size=512,
            num_hidden_layers=3, layer_types=["mamba", "attention", "mamba"],
            attention_multiplier=0.0625, torch_dtype="float32",
            serving={"max_batch": 4, "max_seq": 48})
# fp32 on the CPU agrees with the fp32 reference to rounding (~1e-8 at
# logits of ~0.05, Granite's / 16); the fp8 control reads ~1e-3
TINY_LIMIT = 1e-4


def fam():
    return harness.family(REPO, "granitemoehybrid")


def test_layout_counts_the_published_parameters():
    """954 tensors, 32,207,337,984 parameters: embedding 0.41 B (tied),
    the MoE blocks 27.95 B, the Mamba2 mixers 3.68 B, attention 0.17 B;
    the port's count of the same configuration agrees."""
    lay = fam().layout(GRANITE)
    assert len(lay) == 954
    assert sum(math.prod(s) for _, s, _ in lay) == 32_207_337_984
    assert fam()._arch_config(GRANITE).param_count()[0] == 32_207_337_984
    names = [n for n, _, _ in lay]
    assert lay[0] == ("embed", (100352, 4096), 0.002) and "lm_head" not in names
    assert "blocks.5.wq" in names and "blocks.5.wz" not in names
    assert ("blocks.0.we_g", (72, 4096, 768), 4096 ** -0.5) in lay
    assert ("blocks.0.ws_d", (1536, 4096), 1536 ** -0.5) in lay


@pytest.mark.parametrize("prompt_len,flops", [(128, 6714239221760.0),
                                              (362, 10692562583552.0),
                                              (1024, 21966913798144.0)])
def test_sequence_flops(prompt_len, flops):
    assert fam().sequence_flops(GRANITE, prompt_len, 256) == flops


def test_kernel_work_at_batch_32_and_1024_positions():
    work = fam().kernel_work(GRANITE, 32, 1024, 256)
    assert set(work) == {"flash", "decode", "ssd_scan", "moe"}
    assert len(work["flash"]) == 4 and len(work["decode"]) == 4 * 255
    assert len(work["ssd_scan"]) == 36
    # the prefill's 32,768 tokens in 4 calls a layer, then 40 a step
    assert len(work["moe"]) == 40 * 4 + 40 * 255
    assert work["moe"][0] == (6.0 * 8192 * 10 * 4096 * 768,
                              2.0 * (72 * 3 * 4096 * 768
                                     + 2 * 81920 * 4096))
    assert work["moe"][-1] == (6.0 * 320 * 4096 * 768,
                               2.0 * (72 * 3 * 4096 * 768 + 2 * 320 * 4096))
    assert work["ssd_scan"][0] == (171798691840.0, 2332033536.0)


def test_counts_follow_the_program_s_sizes():
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import moe
    assert fam().SSD_CHUNK == ssd_scan.CHUNK
    assert fam().MOE_TOKENS == moe.DROPLESS_TOKENS


def test_the_cell_s_files_load_by_name():
    """The cell's configuration, traffic, limits, readers and family file
    are found by name with the shipped harness."""
    run = harness.prepare(REPO, CELL, 1, 1.0, True, "cpu", 0.0)
    assert run.family(run.config) is not None
    assert run.config["reduced"] == [] and run.traffic["kind"] == "offline"
    assert set(run.limits) == {"logit_gap"}
    spec = harness.load_spec(REPO)
    traced = {m["name"] for m in harness.metric_entries(spec, CELL, True)}
    assert set(READERS) <= traced
    assert {m["name"] for m in harness.metric_entries(spec, CELL, False)} \
        == {"requests_per_s", "peak_mem_gib", "setup_s"}
    for name in READERS:
        assert callable(harness.reader(REPO, name))


def test_readers_give_nothing_off_the_card(tmp_path):
    root = _root(tmp_path)
    # a window that outlasts the first batch under a loaded CPU, so the
    # second (the traced one) runs
    run, out = run_cell(root, "toygranite.offline", seconds=8.0, trace=True)
    for name in READERS:
        assert harness.reader(REPO, name)(run) is None, name
    assert out["correct"] is True, out["checks"]
    assert {"moe", "ssd_scan", "flash", "decode"} == set(run.traced_work)


def test_the_control_in_the_program_s_place_is_not_correct(tmp_path):
    run, out = run_cell(_root(tmp_path), "toygranite.offline", seconds=0.5,
                        control=True)
    assert out["correct"] is False, out["checks"]
    c = out["checks"]["logit_gap"]
    assert run.notes["program.logit_gap"] <= c["limit"] < c["value"]


def test_build_raises_at_once_on_a_port_without_the_family(monkeypatch):
    import repro_torch.configs.base as base
    monkeypatch.delattr(base, "GraniteHybridConfig")
    with pytest.raises(RuntimeError, match="no hybrid_moe family"):
        fam().build(TINY, 1, "cpu")


def _root(tmp_path):
    """A checkout with the cell ``toygranite.offline`` (the tiny
    configuration under the family, the toy offline traffic) added as new
    files and entries only."""
    root = make_root(tmp_path)
    pb = root / "portbench"
    (pb / "configs/toygranite.json").write_text(json.dumps(TINY))
    (pb / "limits/toygranite.offline.json").write_text(
        json.dumps({"logit_gap": TINY_LIMIT}))
    spec = harness.load_spec(root)
    spec["configs"].append({"name": "toygranite", "source": "toy",
                            "file": "portbench/configs/toygranite.json",
                            "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": "toygranite.offline",
                              "config": "toygranite",
                              "traffic": "toy-offline", "chips": 1,
                              "why": "toy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("toygranite.offline")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
