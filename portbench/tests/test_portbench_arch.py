"""The family files (``portbench/arch/<model_type>.py``): found by the
configuration's ``model_type``, and the ``qwen2`` family's numbers held to
the values the benchmark gave before its code moved into that file."""
from __future__ import annotations

import copy
import hashlib
import json

import pytest
import torch

from portbench import harness, reference, weights
from portbench.tests.conftest import REPO, TOY_MODEL, qwen2

QWEN2_7B = json.loads((REPO / "portbench/configs/qwen2-7b.json").read_text())


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


def test_family_files_give_the_api_and_nothing_else():
    """Every family file gives the functions the harness calls; what else
    it defines is private."""
    for path in sorted((REPO / "portbench/arch").glob("*.py")):
        fam = harness.family(REPO, path.stem)
        public = {n for n, v in vars(fam).items() if callable(v)
                  and not n.startswith("_") and v.__module__ == fam.__name__}
        assert public == set(harness.FAMILY_API), path.name
    assert qwen2().__all__ == harness.FAMILY_API


def test_a_family_file_that_lacks_a_function_is_refused(tmp_path):
    (tmp_path / "portbench/arch").mkdir(parents=True)
    (tmp_path / "portbench/arch/half.py").write_text(
        "def build(cfg, seed, device):\n    pass\n")
    with pytest.raises(AttributeError, match="layout"):
        harness.family(tmp_path, "half")


# -- qwen2-7b: the values of the benchmark's code before the move ----------
def test_qwen2_7b_layout_is_the_one_before_the_move():
    lay = qwen2().layout(QWEN2_7B)
    assert len(lay) == 339
    assert lay[:3] == [("embed", (152064, 3584), 0.02),
                       ("final_norm", (3584,), 0.1),
                       ("lm_head", (3584, 152064), 0.016703827619526525)]
    assert lay[3:15] == [
        ("blocks.0.attn_norm", (3584,), 0.1),
        ("blocks.0.wq", (3584, 28, 128), 0.016703827619526525),
        ("blocks.0.wk", (3584, 4, 128), 0.016703827619526525),
        ("blocks.0.wv", (3584, 4, 128), 0.016703827619526525),
        ("blocks.0.wo", (28, 128, 3584), 0.016703827619526525),
        ("blocks.0.bq", (28, 128), 0.1), ("blocks.0.bk", (4, 128), 0.1),
        ("blocks.0.bv", (4, 128), 0.1), ("blocks.0.mlp_norm", (3584,), 0.1),
        ("blocks.0.wg", (3584, 18944), 0.016703827619526525),
        ("blocks.0.wu", (3584, 18944), 0.016703827619526525),
        ("blocks.0.wd", (18944, 3584), 0.007265477421488705)]
    assert lay[-1] == ("blocks.27.wd", (18944, 3584), 0.007265477421488705)
    # every entry: names, shapes and scales in stream order
    assert _sha([[n, list(s), sd] for n, s, sd in lay]) == \
        "5e650dce80f920daa22894fa901694027067315584acfb6f785b55cb1a0aaa83"


@pytest.mark.parametrize("prompt_len,flops", [(128, 5306927546368.0),
                                              (362, 8407774240768.0),
                                              (1024, 17299303038976.0)])
def test_qwen2_7b_sequence_flops_are_the_ones_before_the_move(prompt_len,
                                                              flops):
    assert qwen2().sequence_flops(QWEN2_7B, prompt_len, 256) == flops


def test_qwen2_7b_kernel_work_is_the_one_before_the_move():
    work = qwen2().kernel_work(QWEN2_7B, 32, 1024, 256)
    assert set(work) == {"flash", "decode"}
    assert len(work["flash"]) == 28 and len(work["decode"]) == 255 * 28
    assert work["flash"][0] == (240753049600.0, 536870912.0)
    assert work["decode"][0] == (470220800.0, 67633152.0)
    assert work["decode"][-1] == (586743808.0, 84279296.0)
    assert _sha({k: [list(x) for x in v] for k, v in work.items()}) == \
        "0fd45bf77109882d58437de81c408a749faac4f1c0bf838237aec37ff5221357"


# -- the toy: seeded weights and reference logits before the move ----------
def test_toy_weights_and_reference_logits_are_the_ones_before_the_move():
    """The toy's seeded fp32 weights bit for bit, and its reference logits
    (plain and fp8 control) by checksum, as the code gave before it moved
    into the family file."""
    cfg, fam = copy.deepcopy(TOY_MODEL), qwen2()
    w = weights.all_weights(fam.layout(cfg), 3, "cpu", torch.float32)
    h = hashlib.sha256()
    for name, _, _ in fam.layout(cfg):
        h.update(w[name].numpy().tobytes())
    assert h.hexdigest() == \
        "4af012a591721eeb789e890a082f2bffb6e07b09003c60e7fa989430890f9cd7"
    tokens = torch.randint(0, cfg["vocab_size"], (2, 19),
                           generator=torch.Generator().manual_seed(0))
    got = fam.logits(cfg, w.__getitem__, [tokens[0], tokens[1]],
                     [slice(0, 19), slice(0, 19)])
    x = torch.cat(got).double()
    assert float(x.sum()) == pytest.approx(-658.7079207853676, rel=1e-9)
    assert float(x.abs().sum()) == pytest.approx(15860.76658405237, rel=1e-9)
    assert got[0].argmax(-1).tolist() == [505, 121, 73, 16, 121, 73, 73, 407,
                                          73, 5, 121, 126, 73, 286, 19, 110,
                                          121, 121, 73]
    assert got[1].argmax(-1).tolist() == [237, 464, 282, 8, 505, 230, 8, 124,
                                          8, 239, 3, 265, 126, 3, 3, 438,
                                          458, 212, 126]
    low = torch.cat(fam.logits(cfg, w.__getitem__, [tokens[0]],
                               [slice(0, 19)], quant="fp8")).double()
    assert float(low.sum()) == pytest.approx(-6.900268692159443, rel=1e-9)
    assert float(low.abs().sum()) == pytest.approx(7643.912630385472,
                                                   rel=1e-9)


def test_tf32_is_restored_after_the_reference():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with reference.no_tf32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
