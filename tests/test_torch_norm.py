"""The port's RMSNorm: the plain chain (``ref.rms_norm_ref``), its route
(``layers.rms_norm``, ``layers.gated_rms_norm``, tallied by
``layers.norm_routes``) and the CUDA kernel (``kernels/rms_norm.py``,
``csrc/rms_norm.cu``).

On the CPU: the plain version equals, to the bit, the chain of ops the
models ran before the kernel (in bf16, fp32 and float64, plain and gated,
over the whole row, per 64-channel group and over heads), and so do both
routes of both norms; CPU tensors, float64, DTensors and autograd take
the plain route, each counted; the wrapper refuses what the kernel does
not take.  On a card (``gpu`` marker): the kernel against the chain at the
serving widths within one bf16 ulp, and graphed decode's captures reaching
every norm of a step through it.  No jax here."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rms_norm as nmod  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers  # noqa: E402

EPS = 1e-6
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32,
          "float64": torch.float64}


def _old_norm(x, weight, eps):
    """``layers.rms_norm`` as it was written before the kernel."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + weight.to(xf.dtype))).to(x.dtype)


def _old_gated(y, z, weight, eps, groups):
    """``ssm._gated_out``'s norm as it was written before the kernel: y, z
    [..., nh, hd], weight [nh, hd]; per head, or over ``groups`` groups of
    the nh * hd channels."""
    y = y * F.silu(z.to(torch.promote_types(z.dtype, torch.float32)))
    if groups:
        g = y.unflatten(-2, (groups, -1)).flatten(-2)
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
        y = g.unflatten(-1, (-1, y.shape[-1])).flatten(-3, -2)
    else:
        y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps)
    return (y * (1.0 + weight.to(y.dtype))).to(z.dtype)


def _inputs(dtype, shape, seed=0, gated=False):
    """x (fp32, or float64 in a float64 model, where gated: the SSD's
    output), weight [shape[-1]] or [nh, hd] for the gate, z of ``dtype``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape) * 3.0)
    w_shape = shape[-2:] if gated else shape[-1:]
    w = torch.from_numpy(rng.standard_normal(w_shape) * 0.3).to(dtype)
    if not gated:
        return x.to(dtype), w, None
    z = torch.from_numpy(rng.standard_normal(shape) * 2.0).to(dtype)
    xdt = torch.float64 if dtype == torch.float64 else torch.float32
    return x.to(xdt), w, z


@pytest.mark.parametrize("case", ["plain", "gated-row", "gated-64"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_is_the_old_chain(dtype, case):
    """``ref.rms_norm_ref`` on rows [rows, d]: the old chain bit for bit,
    ungated, gated over the whole row (group d) and gated per 64 channels
    (the old per-head norm on the same values seen as [rows, d/64, 64])."""
    dt = DTYPES[dtype]
    rows, d = 7, 256
    if case == "plain":
        x, w, _ = _inputs(dt, (rows, d), seed=1)
        assert torch.equal(ref.rms_norm_ref(x, w, EPS), _old_norm(x, w, EPS))
        return
    x, w, z = _inputs(dt, (rows, d // 64, 64), seed=2, gated=True)
    groups = 1 if case == "gated-row" else 0
    want = _old_gated(x, z, w, EPS, groups).flatten(-2)
    got = ref.rms_norm_ref(x.flatten(-2), w.flatten(), EPS, z=z.flatten(-2),
                           group=d if groups else 64)
    assert got.dtype == want.dtype == dt
    assert torch.equal(got, want)


def _counted(fn):
    """``fn()`` and the routes it took, by ``layers.norm_routes``."""
    before = dict(layers.norm_routes)
    out = fn()
    return out, {k: layers.norm_routes[k] - n for k, n in before.items()}


def _stand_in(monkeypatch):
    """The card stood in for: ``ops`` takes every tensor for a CUDA one and
    ``layers`` tallies it so, and the kernel wrapper's place is taken by a
    function that checks the rows it gets as the wrapper does (rank, widths
    and the 16-byte rows it reads) and computes them with the plain version
    (bit for bit the old chain's, by the test above)."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    calls = []

    def rows(x, w, eps, *, z=None, group=None):
        assert x.dim() == 2 and w.shape == (x.shape[1],)
        assert nmod.rows_aligned(x) and (z is None or z.shape == x.shape)
        calls.append((tuple(x.shape), group))
        return ref.rms_norm_ref(x, w, eps, z=z, group=group)

    monkeypatch.setattr(nmod, "rms_norm", rows)
    return calls


@pytest.mark.parametrize("groups", [0, 1, 2])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_routes_compute_the_old_chain(dtype, groups, monkeypatch):
    """On the CPU both norms compute the old chain through either ``impl``,
    counted ``plain`` (no kernel runs off the card); with the card stood
    in for (:func:`_stand_in`) ``impl="kernel"`` sends the rows through
    the kernel's place (the tensors flattened to [rows, d] and the heads to
    groups of hd, or of nh * hd / groups: no group where that is the whole
    row) and the result is the old chain's
    bits still, while ``impl="plain"`` never reaches it."""
    dt = DTYPES[dtype]
    x, w, _ = _inputs(dt, (2, 3, 96), seed=3)
    y, gw, z = _inputs(dt, (2, 3, 4, 16), seed=4, gated=True)
    want = _old_norm(x, w, EPS), _old_gated(y, z, gw, EPS, groups)

    def both(impl):
        return (layers.rms_norm(x, w, EPS, impl),
                layers.gated_rms_norm(y, z, gw, EPS, groups, impl))

    for impl in ("kernel", "plain"):
        got, taken = _counted(lambda: both(impl))
        assert taken == {"kernel": 0, "plain": 2}
        assert all(torch.equal(g, v) for g, v in zip(got, want))
    calls = _stand_in(monkeypatch)
    got = both("kernel")
    assert calls == [((6, 96), None),
                     ((6, 64), {0: 16, 1: None, 2: 32}[groups])]
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    both("plain")
    assert len(calls) == 2


@pytest.mark.parametrize("case", ["float64", "dtensor", "autograd"])
def test_kernel_route_refused_off_its_inputs(case, monkeypatch):
    """What the kernel does not take is refused on the card, not sent to
    the plain chain: float64 raises in the wrapper and autograd in
    ``ops`` (the kernel has no derivative; training runs
    ``impl="plain"``, which computes the old chain with its gradient).  A
    DTensor runs on each rank's shards (``ops.on_shards``: rows, and for a
    per-head weight its heads, split; the normalised dim gathered where it
    was split), here on the CPU through the plain version, to the old
    chain's bits."""
    x, w, _ = _inputs(torch.bfloat16, (4, 3, 64), seed=5)
    if case == "float64":
        x, w = x.double(), w.double()
        got, taken = _counted(lambda: layers.rms_norm(x, w, EPS, "plain"))
        assert taken == {"kernel": 0, "plain": 1}
        assert torch.equal(got, _old_norm(x, w, EPS))
        monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
        n = nmod.launches
        with pytest.raises(TypeError, match="rms_norm"):
            layers.rms_norm(x, w, EPS)
        assert nmod.launches == n
    elif case == "dtensor":
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch import mesh as tmesh
        y, gw, z = _inputs(torch.bfloat16, (4, 3, 4, 16), seed=6, gated=True)
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=1)
        try:
            mesh = tmesh.make_host_mesh([("model", 1)], device_type="cpu")

            def on(t, *p):
                return DTensor.from_local(t, mesh, list(p))

            with torch.no_grad():
                got, taken = _counted(lambda: (
                    layers.rms_norm(on(x, Shard(2)), on(w, Replicate()),
                                    EPS),
                    layers.gated_rms_norm(on(y, Shard(2)), on(z, Shard(2)),
                                          on(gw, Shard(0)), EPS),
                    layers.gated_rms_norm(on(y, Shard(0)), on(z, Shard(0)),
                                          on(gw, Replicate()), EPS, 2)))
        finally:
            dist.destroy_process_group()
        assert taken == {"kernel": 0, "plain": 3}
        assert [o.placements for o in got] == [(Replicate(),), (Shard(2),),
                                               (Shard(0),)]
        want = (_old_norm(x, w, EPS), _old_gated(y, z, gw, EPS, 0),
                _old_gated(y, z, gw, EPS, 2))
        assert all(torch.equal(g.full_tensor(), v)
                   for g, v in zip(got, want))
    else:
        w = w.clone().requires_grad_(True)
        got, taken = _counted(lambda: layers.rms_norm(x, w, EPS, "plain"))
        assert taken == {"kernel": 0, "plain": 1}
        got.float().sum().backward()
        assert w.grad is not None
        assert torch.equal(got.detach(), _old_norm(x, w.detach(), EPS))
        monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
        with pytest.raises(RuntimeError, match="no backward"):
            layers.rms_norm(x, w, EPS)
        with torch.no_grad():
            _stand_in(monkeypatch)
            assert torch.equal(layers.rms_norm(x, w, EPS),
                               _old_norm(x, w.detach(), EPS))


@pytest.mark.parametrize("d,group,ok", [
    (64, None, True), (72, None, True), (60, None, False),
    (128, 64, True), (128, 48, False), (128, 12, False)])
def test_kernel_route_needs_whole_chunks(d, group, ok, monkeypatch):
    """On the card the row and the group must be whole chunks of 8
    elements, the group dividing the row: anything else raises in the
    wrapper (nothing sends it to the plain chain); a shape it takes gets
    past the width checks to the next (here the device's: the tensors
    are on the CPU)."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    x = torch.zeros((2, d), dtype=torch.bfloat16)
    z = None if group is None else x
    with torch.no_grad(), pytest.raises(
            ValueError, match="one CUDA device" if ok else "multiples of"):
        ops.rms_norm(x, x[0], EPS, z=z, group=group)


def _bad(kind):
    """Wrapper arguments that break one rule each (CPU tensors: every check
    but the alignment's comes before the device's)."""
    bf = torch.bfloat16
    x, w = torch.zeros((4, 64), dtype=bf), torch.zeros(64, dtype=bf)
    return {
        "rank": ((x[None], w), {}),
        "weight rank": ((x, w[None]), {}),
        "shape": ((x, torch.zeros(32, dtype=bf)), {}),
        "gate shape": ((x, w), {"z": torch.zeros((4, 32), dtype=bf)}),
        "empty": ((x[:0], w), {}),
        "group without gate": ((x, w), {"group": 64}),
        "width": ((torch.zeros((4, 60), dtype=bf),
                   torch.zeros(60, dtype=bf)), {}),
        "group": ((x, w), {"z": x, "group": 48}),
        "too wide": ((torch.zeros((1, 2 * nmod.MAX_WIDTH), dtype=bf),
                      torch.zeros(2 * nmod.MAX_WIDTH, dtype=bf)), {}),
        "dtype": ((x.double(), w.double()), {}),
        "gate dtype": ((x, w), {"z": x.half()}),
        "device": ((x, w), {}),
    }[kind]


@pytest.mark.parametrize("kind", [
    "rank", "weight rank", "shape", "gate shape", "empty",
    "group without gate", "width", "group", "too wide", "dtype",
    "gate dtype", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind):
    args, kw = _bad(kind)
    n = nmod.launches
    err = TypeError if "dtype" in kind else ValueError
    with pytest.raises(err, match="rms_norm"):
        nmod.rms_norm(*args, EPS, **kw)
    assert nmod.launches == n


def test_rows_aligned():
    """The kernel reads rows whose last dim is contiguous and that start on
    16-byte boundaries; anything else is copied first by ``ops``."""
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    assert nmod.rows_aligned(x)
    assert nmod.rows_aligned(x[1:])                  # 128-byte rows
    assert not nmod.rows_aligned(x[:, 1:])           # starts 2 bytes in
    assert not nmod.rows_aligned(x[:, ::2])
    assert not nmod.rows_aligned(torch.zeros((4, 68), dtype=torch.bfloat16)
                                 [:, :64])           # 136-byte rows


# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ulps_apart(got, want) -> float:
    """The largest |got - want| in units of bf16's last place at
    max(|got|, |want|) (a bf16 ulp is 2^(e - 7) for a value in [2^e,
    2^(e+1)))."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


# (rows, d, group, gated): qwen2-7b's and Granite's decode rows, a
# Granite prefill, Granite's gate over all 8,192 channels and a per-head
# (64) gate as mamba2's; then ragged row counts
SHAPES = [(32, 3584, None, False), (32, 4096, None, False),
          (32768, 4096, None, False), (32, 8192, 8192, True),
          (32, 8192, 64, True), (1, 3584, None, False),
          (3, 8192, 64, True), (33, 4096, None, False),
          (33, 8192, 8192, True), (3, 768, None, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,group,gated", SHAPES)
def test_kernel_matches_chain_on_gpu(rows, d, group, gated):
    """bf16 out within one bf16 ulp of the plain chain run on the card
    (they differ in the order of the mean's sum), from bf16 rows, or for
    the gate from fp32 rows and a bf16 gate as the SSD hands them; the same
    in fp32 within 4e-6 relative; one launch a call."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(rows + d)
    x = 3.0 * torch.randn((rows, d), generator=gen, device=dev)
    w = 0.3 * torch.randn(d, generator=gen, device=dev)
    z = 2.0 * torch.randn((rows, d), generator=gen, device=dev) \
        if gated else None
    for dtype in (torch.bfloat16, torch.float32):
        xd = x if gated else x.to(dtype)
        zd = None if z is None else z.to(dtype)
        wd = w.to(dtype)
        n = nmod.launches
        got = nmod.rms_norm(xd, wd, EPS, z=zd, group=group)
        assert nmod.launches == n + 1
        want = ref.rms_norm_ref(xd, wd, EPS, z=zd, group=group)
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        if dtype == torch.bfloat16:
            assert _ulps_apart(got, want) <= 1.0
        else:
            torch.testing.assert_close(got, want, rtol=4e-6, atol=1e-6)


@pytest.mark.gpu
def test_kernel_reads_strided_rows_and_refuses_misaligned_on_gpu():
    """Rows of a wider buffer are read in place where each starts on a
    16-byte boundary; a start 2 bytes in is refused by the wrapper and
    copied by ``ops.rms_norm``."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(7)
    buf = torch.randn((5, 4096 + 64), generator=gen, device=dev).bfloat16()
    w = 0.3 * torch.randn(4096, generator=gen, device=dev).bfloat16()
    x = buf[:, :4096]
    assert _ulps_apart(nmod.rms_norm(x, w, EPS),
                       ref.rms_norm_ref(x, w, EPS)) <= 1.0
    odd = buf[:, 8:8 + 4096]
    assert nmod.rows_aligned(odd)
    odd = buf[:, 1:1 + 4096]
    with pytest.raises(ValueError, match="16-byte"):
        nmod.rms_norm(odd, w, EPS)
    assert _ulps_apart(ops.rms_norm(odd, w, EPS),
                       ref.rms_norm_ref(odd, w, EPS)) <= 1.0


def _graphed_sites(m) -> int:
    """The norms of one decode step: two a dense or attention layer (before
    the mixer and the FFN), three a Mamba2 layer (its input, its gate, its
    FFN), and the final norm."""
    from repro_torch.models.ssm import SSMBlock
    return sum(3 if isinstance(b, SSMBlock) else 2 for b in m.blocks) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-7b", "granite-4.0-h-small"])
def test_graphed_capture_takes_every_norm_through_the_kernel_on_gpu(name):
    """``GraphedDecode.capture_max_batch`` runs each segment once eagerly
    and once under capture: every norm site of a step counted twice on the
    kernel route, none on the plain one, one launch each.  qwen2-7b at full
    widths with 2 layers; Granite-4.0-H at published widths with 3 (mamba,
    attention, mamba), both bf16."""
    _cuda()
    from repro_torch.models.graphed import GraphedDecode
    if name == "qwen2-7b":
        arch = dataclasses.replace(ARCHS[name], num_layers=2)
        m = Model(arch, device="cuda", dtype=torch.bfloat16).init(
            torch.Generator(device="cuda").manual_seed(0))
    else:
        import json
        import _granite_tiny as tiny
        cfg = json.loads((tiny.REPO / "portbench/configs/"
                          "granite-4.0-h-small.json").read_text())
        cfg.update(num_hidden_layers=3,
                   layer_types=["mamba", "attention", "mamba"])
        m = Model(tiny.family()._arch_config(cfg), device="cuda",
                  dtype=torch.bfloat16).init(torch.Generator(
                      device="cuda").manual_seed(0))
    dec = GraphedDecode(m, max_batch=4, max_seq=32)
    n = nmod.launches
    _, taken = _counted(dec.capture_max_batch)
    sites = _graphed_sites(m)
    assert taken == {"kernel": 2 * sites, "plain": 0}
    assert nmod.launches - n == 2 * sites
