"""The causal conv of the port's Mamba2 block on sequence shards
(``repro_torch.models.ssm.conv_and_tail``): the halo exchange that stands
in for the reference's zero pad under a mesh.

Four spawned gloo ranks on the 2x2 ``("data", "model")`` mesh of
``tests/_torch_ranks.py`` shard the sequence dim of a seeded fp32 input
over one mesh dim (2 shards) or both (4 shards), with ``F.pad`` refusing
DTensors.  The local-shard conv must give ``causal_shift_conv``'s values
on the whole tensor bit for bit (the same products and sums, in the same
order), the last shard's tail, and the same gradients of ``sum(out * g)``
for the input and the weight within ``RTOL``/``ATOL`` (the halo's
gradient and the weight's are summed across ranks in another order).  A
shard shorter than ``cw - 1`` rows raises.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import _torch_ranks  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6        # fp32 gradients summed in another order
CW = 4                         # every Mamba2 config's conv width
CASES = [
    # (id, x shape [B, S, *ch], sequence sharded over (data, model))
    ("2-shards-model", (2, 12, 3, 4), (False, True)),
    ("2-shards-data-edge", (2, 6, 5), (True, False)),    # cw - 1 rows each
    ("4-shards", (2, 16, 3, 2), (True, True)),
    ("unsharded-seq", (2, 7, 5), (False, False)),
    # a sequence shorter than cw - 1 (unsharded): the tail is left-padded
    ("unsharded-short", (2, 2, 5), (False, False)),
    ("4-shards-too-short", (2, 8, 5), (True, True)),      # 2 rows each
]


@pytest.fixture(scope="module")
def halo(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("halo_ranks"))
    rng = np.random.default_rng(7)
    cases = []
    for _, shape, seq_on in CASES:
        cases.append({
            "x": torch.from_numpy(rng.standard_normal(shape, np.float32)),
            "w": torch.from_numpy(rng.standard_normal((CW,) + shape[2:],
                                                      np.float32)),
            "g": torch.from_numpy(rng.standard_normal(shape, np.float32)),
            "seq_on": seq_on})
    torch.save(cases, os.path.join(work, "halo_in.pt"))
    ranks = _torch_ranks.start(_torch_ranks.halo, work)
    _torch_ranks.wait(ranks)
    assert not dist.is_initialized()
    return cases, torch.load(os.path.join(work, "halo_out.pt"))


def _plain(case):
    x = case["x"].clone().requires_grad_()
    w = case["w"].clone().requires_grad_()
    y = ssm.causal_shift_conv(x, w)
    (y * case["g"]).sum().backward()
    return y.detach(), x.grad, w.grad


@pytest.mark.parametrize("index", range(len(CASES) - 1),
                         ids=[c[0] for c in CASES[:-1]])
def test_halo_conv_equals_the_whole_tensor_conv(halo, index):
    case, got = halo[0][index], halo[1][index]
    y, x_grad, w_grad = _plain(case)
    assert torch.equal(got["out"], y)
    S = case["x"].shape[1]
    want_tail = torch.nn.functional.pad(
        case["x"], (0, 0) * (case["x"].dim() - 2) + (max(CW - 1 - S, 0), 0))
    assert torch.equal(got["tail"], want_tail[:, -(CW - 1):])
    np.testing.assert_allclose(got["x_grad"], x_grad, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["w_grad"], w_grad, rtol=RTOL, atol=ATOL)
    # the output keeps x's sharding; the tail is whole along the sequence
    want = tuple("Shard(dim=1)" if on else "Replicate()"
                 for on in CASES[index][2])
    assert got["out_placements"] == "(" + ", ".join(want) + ")"
    assert got["tail_placements"] == "(Replicate(), Replicate())"


def test_halo_conv_refuses_a_shard_shorter_than_the_halo(halo):
    got = halo[1][len(CASES) - 1]
    assert "at least cw - 1 = 3 rows" in got["error"]


def test_plain_tensors_keep_the_padded_conv():
    """A plain tensor never reaches the local-shard path: the conv is the
    reference's sum of zero-padded shifted copies."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 3, generator=g)
    w = torch.randn(CW, 3, generator=g)
    want = x * w[CW - 1]
    for i in range(CW - 1):
        shift = CW - 1 - i
        want = want + torch.nn.functional.pad(
            x, (0, 0, shift, 0))[:, :9] * w[i]
    assert torch.equal(ssm.causal_shift_conv(x, w), want)
