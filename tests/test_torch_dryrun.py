"""The port's dry-run and roofline (``repro_torch.launch.specs``,
``dryrun``, ``roofline``, ``report``) against the JAX package's.

Cells build on ``meta`` tensors over ``DeviceMesh``es of a ``fake``
process group in this process (``dryrun.fake_world``, destroyed after each
test), with ``device_type="cuda"`` as the dry-run builds them: nothing is
allocated and no card is touched.  The per-rank counts are held to closed
forms, to the reference's accounting rules and XLA's cost analysis, and to
the same counting mode over the plain model on the CPU.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import applicable  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch.specs import input_specs as jax_input_specs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.sharding.policy import ShardingPolicy as JaxPolicy  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.hwspec.device import H100_SXM  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import Model  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
FAMILY_ARCHS = ("qwen2-7b", "llama4-scout-17b-a16e", "mamba2-130m",
                "zamba2-7b")
KINDS = ("train", "prefill", "decode")
DTYPES = {jnp.int32: torch.int64, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}


def _mesh(shape=(2, 4), device_type="cuda"):
    return make_host_mesh(list(zip(("data", "model"), shape)),
                          device_type=device_type)


def _shape(kind: str) -> ShapeConfig:
    """A small cell of ``kind``; a train batch of 4 takes one microbatch
    (the production cells take 8, which multiply a count's time by 8)."""
    return ShapeConfig(kind, 64, 4 if kind == "train" else 8, kind)


def _dtype(x):
    return DTYPES[jnp.dtype(x.dtype).type]


# ---------------------------------------------------------------------------
def test_input_specs_match_reference_in_every_cell():
    n = 0
    for name, a in JAX_ARCHS.items():
        for sname, s in JAX_SHAPES.items():
            if not applicable(a, s):
                continue
            want = jax_input_specs(a, s)
            got = input_specs(ARCHS[name], SHAPES[sname])
            assert set(got) == set(want), (name, sname)
            for key in ("tokens", "labels", "frontend_embeds"):
                if key in want:
                    assert got[key].device.type == "meta"
                    assert tuple(got[key].shape) == want[key].shape
                    assert got[key].dtype == _dtype(want[key])
            if "cache" in want:
                assert got["cache_len"] == s.seq_len - 1
                assert want["cache_len"].shape == ()
                wc, gc = want["cache"], got["cache"]
                assert set(gc) == set(wc)
                for key in ("k", "v"):
                    if key in wc:
                        stacked = (len(gc[key]),) + tuple(gc[key][0].shape)
                        assert stacked == wc[key].shape
                        assert gc[key][0].dtype == _dtype(wc[key])
                if "ssm" in wc:
                    for field in wc["ssm"]._fields:
                        leaf = getattr(wc["ssm"], field)
                        mine = [getattr(st, field) for st in gc["ssm"]]
                        assert (len(mine),) + tuple(mine[0].shape) == \
                            leaf.shape
                        assert mine[0].dtype == _dtype(leaf)
            n += 1
    assert n == 32


def test_per_rank_flops_skip_global_and_propagation_ops():
    """Trap 1 (the global op) and trap 2 (sharding propagation's op on
    fake tensors): [64,4096] @ [4096,4096] on a 16x16 mesh with the left
    operand sharded by rows over data and the right by columns over model
    is 2*4*4096*256 FLOPs on a rank, on the first and a cached call."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    with dryrun.fake_world(256):
        mesh = _mesh((16, 16))
        prop = DTensor._op_dispatcher.sharding_propagator
        prop.propagate_op_sharding.cache_clear()
        a = DTensor.from_local(torch.empty(4, 4096, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(4096, 256, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        for _ in range(2):
            with dryrun.StepCounter() as c:
                out = a @ b
            assert c.flops == 8_388_608
            assert tuple(out.shape) == (64, 4096)
        with FlopCounterMode(display=False) as f:
            a @ b
        assert f.get_total_flops() == 2 * 64 * 4096 * 4096


def _redistributed(mesh, src, dst):
    """Redistribute a [64,128] fp32 DTensor over the model axis (4
    ranks) from ``src`` to ``dst`` under the counter."""
    from torch.distributed.tensor import DTensor
    local = (16, 128) if src[1].is_shard() else (64, 128)
    x = DTensor.from_local(torch.empty(local, device="meta"), mesh, src,
                           run_check=False)
    with dryrun.StepCounter() as c:
        x.redistribute(mesh, dst)
    return c


def test_collective_bytes_follow_the_reference_rule():
    """tests/test_dryrun_integration.py's rule (all-gather at its result,
    all-reduce at 2x its operand, reduce-scatter and all-to-all at their
    operand), held against ``repro.launch.dryrun.parse_collective_bytes``
    on the same shapes, on a 2x4 mesh."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    R, P = Replicate(), Partial()
    full = 64 * 128 * 4                      # the [64,128] fp32 tensor
    with dryrun.fake_world(8):
        mesh = _mesh()
        got = {
            "all-gather": _redistributed(mesh, [R, Shard(0)], [R, R]),
            "all-reduce": _redistributed(mesh, [R, P], [R, R]),
            "reduce-scatter": _redistributed(mesh, [R, P], [R, Shard(0)]),
            "all-to-all": _redistributed(mesh, [R, Shard(0)], [R, Shard(1)]),
        }
        cpu = _redistributed(_mesh(device_type="cpu"), [R, Shard(0)],
                             [R, Shard(1)])
    hlo = """
      %ag = f32[64,128]{1,0} all-gather(f32[16,128]{1,0} %a), dimensions={0}
      %ar = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %b), replica_groups={}
      %rs = f32[16,128]{1,0} reduce-scatter(f32[64,128]{1,0} %c), dimensions={0}
      %aa = f32[16,128]{1,0} all-to-all(f32[16,128]{1,0} %d), dimensions={1}
    """
    want = jdry.parse_collective_bytes(hlo)
    assert want == {"all-gather": full, "all-reduce": 2 * full,
                    "reduce-scatter": full, "all-to-all": full // 4}
    for kind, c in got.items():
        assert c.collective_bytes == {kind: want[kind]}, kind
        assert c.collective_counts == {kind: 1}
    # trap 3: a "cpu" mesh turns the all-to-all into an all-gather
    assert set(cpu.collective_bytes) == {"all-gather"}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_build_step_counts_each_family_on_a_2x4_mesh(name, kind):
    arch = get_arch(name).reduced()
    with dryrun.fake_world(8):
        fn, args, policy = dryrun.build_step(arch, _shape(kind), _mesh())
        counted = dryrun.count_step(fn, args, comm_debug=True)
    assert counted["flops"] > 0 and counted["bytes"] > 0
    # CommDebugMode counts the same collectives (the all-to-alls as
    # _dtensor.shard_dim_alltoall, the rest as funcol ops)
    assert sum(counted["collective_counts"].values()) == \
        sum(counted["comm_debug_counts"].values())
    mem = counted["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["peak_memory_in_bytes"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    if kind == "decode":                # the cache is donated
        assert mem["alias_size_in_bytes"] > 0
    for k, n in counted["collective_counts"].items():
        assert counted["collectives"][k] > 0 and n > 0


# ---------------------------------------------------------------------------
def _dense_matmul_flops(arch, B: int, S: int) -> int:
    """The matmul FLOPs of a reduced dense prefill: the projections, the
    plain attention's QK^T and PV over the whole S x S, the gated MLP, and
    the head on the last token."""
    d, H, KV, hd, ff = (arch.d_model, arch.num_heads, arch.num_kv_heads,
                        arch.head_dim, arch.d_ff)
    per_layer = (2 * B * S * d * (H + 2 * KV) * hd        # q, k, v
                 + 2 * 2 * B * H * S * S * hd             # QK^T, PV
                 + 2 * B * S * H * hd * d                 # out projection
                 + 3 * 2 * B * S * d * ff)                # gate, up, down
    return arch.num_layers * per_layer + 2 * B * d * arch.vocab_size


def _xla_prefill_flops(name: str, B: int, S: int) -> float:
    arch = JAX_ARCHS[name].reduced()
    model = JaxModel(arch, JaxPolicy(mesh=None), unroll=True)
    fn = jax.jit(lambda p, t: model.prefill(p, t))
    lowered = fn.lower(model.param_shapes(),
                       jax.ShapeDtypeStruct((B, S), jnp.int32))
    return float(lowered.compile().cost_analysis()["flops"])


def test_dense_cell_on_one_rank_against_closed_form_and_xla():
    """Reduced qwen2-7b prefill on a 1x1 mesh: the count equals the closed
    form of its matmuls exactly, and XLA's cost analysis of the
    reference's same cell (its layers unrolled: XLA counts a scan body
    once) lies at most 12 % above it: XLA also counts the elementwise
    work (norms, RoPE, the causal mask and softmax, SwiGLU, the residual
    adds), which is 9.9 % of its total at these widths."""
    name, B, S = "qwen2-7b", 2, 64
    arch = get_arch(name).reduced()
    with dryrun.fake_world(1):
        fn, args, _ = dryrun.build_step(arch, ShapeConfig("p", S, B,
                                                          "prefill"),
                                        _mesh((1, 1)))
        counted = dryrun.count_step(fn, args)
    want = _dense_matmul_flops(arch, B, S)
    assert counted["flops"] == want
    xla = _xla_prefill_flops(name, B, S)
    assert want <= xla <= 1.12 * want, (want, xla)
    assert counted["collectives"] == {}


def test_kernel_path_counts_the_attention_kernels_at_their_work():
    """``kernel_path`` counts the plain attention at the kernels' work:
    flash's QK^T and PV over the causal pairs (query i sees keys up to
    i + Skv - Sq) and decode's over the first ``cache_len`` positions,
    each input read once and the output written once; the plain counts
    beside them stay those of the plain versions."""
    from repro_torch.kernels import ref
    plain = ref.flash_attention_ref, ref.decode_attention_ref
    B, H, KV, hd, Sq, Skv, S, L = 2, 4, 2, 16, 40, 48, 64, 37
    bf = torch.bfloat16
    q = torch.empty(B, Sq, H, hd, device="meta", dtype=bf)
    k = torch.empty(B, Skv, KV, hd, device="meta", dtype=bf)
    got = dryrun.count_step(lambda q, k: ref.flash_attention_ref(
        q, k, k, causal=True), (q, k))
    pairs = sum(i + Skv - Sq + 1 for i in range(Sq))
    assert got["kernel_path"] == {
        "flops": 4 * B * H * hd * pairs,
        "bytes": 2 * (2 * q.numel() + 2 * k.numel())}
    assert got["flops"] == 4 * B * H * hd * Sq * Skv
    q1 = torch.empty(B, 1, H, hd, device="meta", dtype=bf)
    cache = torch.empty(B, S, KV, hd, device="meta", dtype=bf)
    got = dryrun.count_step(lambda q, c: ref.decode_attention_ref(
        q, c, c, L), (q1, cache))
    assert got["kernel_path"] == {
        "flops": 4 * B * H * hd * L,
        "bytes": 2 * (2 * q1.numel() + 2 * B * L * KV * hd)}
    assert got["flops"] == 4 * B * H * hd * S
    assert (ref.flash_attention_ref, ref.decode_attention_ref) == plain


def test_kernel_path_of_a_dense_prefill_is_its_causal_closed_form():
    """Reduced qwen2-7b prefill on a 1x1 mesh: on the kernel path the
    attention's S x S of the plain count becomes its S(S+1)/2 causal
    pairs, and fewer bytes move (no fp32 casts, no scores)."""
    name, B, S = "qwen2-7b", 2, 64
    arch = get_arch(name).reduced()
    with dryrun.fake_world(1):
        fn, args, _ = dryrun.build_step(arch, ShapeConfig("p", S, B,
                                                          "prefill"),
                                        _mesh((1, 1)))
        counted = dryrun.count_step(fn, args)
    attn = 4 * B * arch.num_heads * arch.head_dim * arch.num_layers
    want = (_dense_matmul_flops(arch, B, S) - attn * S * S
            + attn * S * (S + 1) // 2)
    assert counted["kernel_path"]["flops"] == want
    assert counted["kernel_path"]["bytes"] < counted["bytes"]


def _plain_step(arch, shape: ShapeConfig, cache_len: int):
    """The same step on the CPU without a policy, weights random."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    B, S = shape.global_batch, shape.seq_len
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, arch.vocab_size, (B, S), generator=g)
    if shape.kind == "train":
        model = Model(arch, device="cpu", impl="plain", remat="none")
        cfg = opt.AdamWConfig()
        state = init_train_state(model, g, cfg)
        return make_train_step(model, cfg), (state, {
            "tokens": tokens, "labels": tokens.clone()})
    model = Model(arch, device="cpu", impl="plain").init(g)
    params = dict(model.named_parameters())
    if shape.kind == "prefill":
        return (lambda p, t: model.prefill(t)), (params, tokens)
    return (lambda p, c, n, t: model.decode_step(c, n, t)), (
        params, model.init_cache(B, S), cache_len, tokens[:, :1].clone())


@pytest.mark.parametrize("kind", KINDS)
def test_meta_count_equals_the_plain_step_on_the_cpu(kind):
    """What the card's dry-run phase checks, on the CPU: the meta count on
    a 1x1 mesh under the policy equals the count over the real plain step
    without one (remat none, one microbatch, a cache_len inside)."""
    arch = get_arch("qwen2-7b").reduced()
    shape = ShapeConfig(kind, 32, 4, kind)
    with dryrun.fake_world(1):
        fn, args, _ = dryrun.build_step(arch, shape, _mesh((1, 1)),
                                        remat="none", microbatches=1,
                                        cache_len=20)
        meta = dryrun.count_step(fn, args)
    real = dryrun.count_step(*_plain_step(arch, shape, 20))
    assert meta["flops"] == real["flops"] > 0
    assert meta["memory"]["argument_size_in_bytes"] == \
        real["memory"]["argument_size_in_bytes"]


# ---------------------------------------------------------------------------
def test_depth_pair_matches_reference_for_every_arch():
    for name, a in JAX_ARCHS.items():
        assert dryrun.depth_pair(ARCHS[name]) == jdry.depth_pair(a), name


@pytest.mark.parametrize("name", ("qwen2-7b", "llama4-maverick-400b-a17b",
                                  "zamba2-7b"))
def test_linear_estimate_equals_direct_count_at_three_depths(name):
    """The reference's (L1, L2) extrapolation is exact for the port's
    homogeneous stacks: at 3 groups it equals the direct count."""
    arch = get_arch(name).reduced()
    L1, L2 = dryrun.depth_pair(arch)
    rows = {}
    with dryrun.fake_world(8):
        for L in (L1, L2, 3 * L1):
            fn, args, _ = dryrun.build_step(arch, _shape("prefill"), _mesh(),
                                            num_layers=L)
            rows[L] = dryrun.count_step(fn, args)
    for key in ("flops", "bytes"):
        est = dryrun.linear_estimate(rows[L1][key], rows[L2][key], L1, L2,
                                     3 * L1)
        assert est == rows[3 * L1][key], key
    for kind, b in rows[3 * L1]["collectives"].items():
        est = dryrun.linear_estimate(rows[L1]["collectives"].get(kind, 0.0),
                                     rows[L2]["collectives"].get(kind, 0.0),
                                     L1, L2, 3 * L1)
        assert est == b, kind


def test_model_flops_match_reference_in_every_cell():
    for name in JAX_ARCHS:
        for sname in JAX_SHAPES:
            assert roofline.model_flops(name, sname) == \
                jroof.model_flops(name, sname), (name, sname)


# ---------------------------------------------------------------------------
SYNTHETIC = {
    "arch": "qwen2-7b", "shape": "decode_32k", "mesh": "pod",
    "kind": "decode", "ok": True, "chips": 256,
    "memory": {"argument_size_in_bytes": 60 * 10 ** 9,
               "output_size_in_bytes": 10 ** 9,
               "temp_size_in_bytes": 25 * 10 ** 9,
               "alias_size_in_bytes": 10 ** 9,
               "peak_memory_in_bytes": 85 * 10 ** 9},
    "policy_notes": ["note"], "attn_mode": "context",
    "extrapolation": {"method": "counted", "est_flops": 2.0e12,
                      "est_bytes": 6.7e12,
                      "est_collective_bytes": {"all-gather": 9.0e11},
                      "est_collective_total": 9.0e11},
}


def test_analyze_record_divides_by_the_h100_preset():
    row = roofline.analyze_record(SYNTHETIC)
    assert row["compute_s"] == 2.0e12 / 989e12
    assert row["memory_s"] == 6.7e12 / 3.35e12
    assert row["collective_s"] == 9.0e11 / 900e9
    assert (H100_SXM.peak_flops["bf16"], H100_SXM.hbm_bw,
            H100_SXM.ici_bw_per_link) == (989e12, 3.35e12, 900e9)
    assert row["dominant"] == "memory"
    assert row["step_time_bound_s"] == row["memory_s"]
    mf = roofline.model_flops("qwen2-7b", "decode_32k")
    assert row["roofline_fraction"] == mf["model_flops_fwd_2nd"] / (
        row["memory_s"] * 256 * 989e12)
    assert roofline.analyze_record({**SYNTHETIC, "ok": False}) is None


def test_report_tables_on_a_synthetic_record(tmp_path, monkeypatch):
    (tmp_path / "dryrun_torch").mkdir()
    with open(tmp_path / "dryrun_torch" / "cell.json", "w") as f:
        json.dump(SYNTHETIC, f)
    monkeypatch.setattr(report, "RES", str(tmp_path))
    table = report.dryrun_table("pod")
    assert "fits h100-sxm 80 GB" in table
    # net = 60 + 25 + 1 - 1 = 85 GB > 80 GB
    assert "| qwen2-7b | decode_32k | OK | 60.00 + 25.00 | 85.00 | NO |" \
        in table
    roof = report.roofline_table("pod")
    assert "989 TFLOP/s" in roof and "| memory |" in roof
    assert "split-KV decode kernel" in roof
    assert report.before_after().startswith("no baseline")
    (tmp_path / "dryrun_torch_baseline").mkdir()
    base = json.loads(json.dumps(SYNTHETIC))
    base["extrapolation"]["est_collective_total"] = 1.8e12
    with open(tmp_path / "dryrun_torch_baseline" / "cell.json", "w") as f:
        json.dump(base, f)
    assert "| qwen2-7b × decode_32k | 1.80e+12 | 9.00e+11 | 0.50x |" in \
        report.before_after()


def test_report_lists_the_cells_that_moved(tmp_path, monkeypatch):
    """``cell_deltas`` lists a cell whose count moved, before -> after,
    and leaves out one that did not."""
    monkeypatch.setattr(report, "RES", str(tmp_path))
    after = dict(SYNTHETIC, collectives={"all-gather": 1.6e9,
                                         "all-reduce": 1.4e7},
                 cost={"flops": 2.6e10, "bytes": 2.9e10})
    before = json.loads(json.dumps(after))
    before["collectives"]["all-gather"] = 1.7e10
    same = dict(after, shape="prefill_32k")
    for sub, recs in (("dryrun_torch", (after, same)),
                      ("dryrun_torch_baseline", (before, same))):
        (tmp_path / sub).mkdir()
        for i, r in enumerate(recs):
            with open(tmp_path / sub / f"{i}.json", "w") as f:
                json.dump(r, f)
    rows = report.cell_deltas().splitlines()[2:]
    assert rows == ["| qwen2-7b × decode_32k | 1.7e+10 → 1.6e+09 | "
                    "1.4e+07 → 1.4e+07 | 0 → 0 | 2.6e+10 → 2.6e+10 | "
                    "85.00 → 85.00 |"]


def test_cli_production_cell_and_roofline(tmp_path):
    """One production cell through the CLI on a host without a card, then
    its roofline row."""
    env = {**os.environ, "PYTHONPATH": SRC}
    out = tmp_path / "qwen2-7b__decode_32k__pod.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-7b", "--shape", "decode_32k", "--mesh", "pod", "--out",
         str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[OK] qwen2-7b × decode_32k × pod" in r.stdout
    rec = json.loads(out.read_text())
    assert rec["chips"] == 256 and rec["cost"]["flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert set(rec["collectives"]) >= {"all-gather"}
    assert rec["extrapolation"]["method"] == "counted"
    assert 0 < rec["kernel_path"]["bytes"] < rec["cost"]["bytes"]
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(tmp_path)], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "h100-sxm: 989 TFLOP/s bf16" in r.stdout
    assert "| qwen2-7b | decode_32k |" in r.stdout


def test_redo_extrapolation_rebuilds_the_block_from_the_record(tmp_path):
    """``redo_extrapolation`` and ``run_all_ext`` refresh a cached
    record's extrapolation from its own counts (nothing is recounted);
    failed and skipped records are left as they are."""
    rec = {"arch": "qwen2-7b", "shape": "decode_32k", "mesh": "pod",
           "ok": True, "cost": {"flops": 3.0e12, "bytes": 2.0e11},
           "collectives": {"all-gather": 4.0e9, "all-reduce": 1.0e9}}
    bad = {"arch": "gemma-2b", "shape": "train_4k", "mesh": "pod",
           "ok": False, "error": "x"}
    for stem, r in (("good", rec), ("bad", bad)):
        (tmp_path / f"{stem}.json").write_text(json.dumps(r))
    dryrun.run_all_ext(str(tmp_path))
    ext = json.loads((tmp_path / "good.json").read_text())["extrapolation"]
    assert ext == {"method": "counted", "L1": 1, "L2": 2,
                   "true_layers": get_arch("qwen2-7b").num_layers,
                   "est_flops": 3.0e12, "est_bytes": 2.0e11,
                   "est_collective_bytes": rec["collectives"],
                   "est_collective_total": 5.0e9}
    assert json.loads((tmp_path / "bad.json").read_text()) == bad


@pytest.mark.slow
@pytest.mark.parametrize("mesh_name", ("pod", "multipod"))
def test_every_cell_counts_at_full_depth(tmp_path, monkeypatch, mesh_name):
    """Every (arch × shape) cell at full depth on a production mesh, one
    subprocess each through ``run_all`` (tens of minutes: a train cell
    takes 1–9 minutes)."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    assert dryrun.run_all([mesh_name], jobs=4) == []
    rows = roofline.load_all(str(tmp_path))
    assert len(rows) == 32
    assert all(r["step_time_bound_s"] > 0 for r in rows)


# ---------------------------------------------------------------------------
# chip_smoke.phase_dryrun, rehearsed on the CPU
def _counting(mod, plain):
    def launch(*args, **kw):
        mod.launches += 1
        return plain(*args, **kw)
    return launch


def _live_cpu_bytes() -> int:
    """The CPU's stand-in for ``torch.cuda.memory_allocated``: the bytes
    of every live CPU tensor's storage, each once."""
    import gc
    import warnings
    seen, total = set(), 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and o.device.type == "cpu":
                st = o.untyped_storage()
                if st._cdata not in seen:
                    seen.add(st._cdata)
                    total += st.nbytes()
    return total


@pytest.fixture
def dryrun_phase(monkeypatch):
    """``chip_smoke.phase_dryrun`` on the CPU: reduced models, a gloo group
    and a cpu mesh, the attention wrappers replaced by counting plain
    versions (``ops._on_cuda`` forced), ``memory_allocated`` by the live
    CPU tensors' bytes, prompts and the train batch shortened, one timed
    step a cell; production cells as the test passes them."""
    import torch.distributed as dist
    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    import repro_torch.configs as configs
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops, ref

    full = configs.get_arch
    monkeypatch.setattr(configs, "get_arch", lambda n: full(n).reduced())
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(fmod, "flash_attention",
                        _counting(fmod, ref.flash_attention_ref))
    monkeypatch.setattr(dmod, "decode_attention",
                        _counting(dmod, ref.decode_attention_ref))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **kw: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda *a, **kw: _live_cpu_bytes())
    # the card's shapes cut for the CPU (bf16 there is slow)
    monkeypatch.setattr(chip_smoke, "PROMPT_LENS", (24, 40))
    monkeypatch.setattr(chip_smoke, "TRAIN_S", 32)
    monkeypatch.setattr(chip_smoke, "DRYRUN_REPS", 1)
    yield lambda production=(): chip_smoke.phase_dryrun(
        torch, {"nvidia_smi": "cpu rehearsal"}, 0, device="cpu",
        backend="gloo", production=production)
    assert not dist.is_initialized()


def test_chip_smoke_dryrun_phase_rehearsal(dryrun_phase, capsys):
    import chip_smoke
    production = tuple((a + "-reduced", s, m)
                       for a, s, m in chip_smoke.DRYRUN_PRODUCTION)
    dryrun_phase(production)
    by = {}
    for ln in capsys.readouterr().out.splitlines():
        if ln.startswith("{"):
            d = json.loads(ln)
            by.setdefault(d["phase"], []).append(d)
    cells = by["dryrun_cell"]
    assert [c["cell"] for c in cells] == [
        "qwen2-7b prefill", "qwen2-7b decode step",
        "granite-3-2b train step"]
    for c in cells:
        assert c["flops"] == c["card_flops"] > 0
        assert c["argument_bytes_rel_err"] <= 0.01
        assert not c["failures"]
    assert cells[0]["launches"] == {"flash_attention": 2,
                                    "decode_attention": 0}
    assert cells[1]["launches"] == {"flash_attention": 0,
                                    "decode_attention": 2}
    # the served steps are bounded on the kernel path they time, the
    # train step (no kernel) on its plain one
    assert [c["timed_path"] for c in cells] == ["kernel", "kernel", "plain"]
    for c in cells[:2]:
        assert c["bound_s"] < c["plain_path_bound_s"]
        assert c["memory_s"] == c["kernel_path"]["bytes"] / 3.35e12
    assert cells[2]["bound_s"] == cells[2]["plain_path_bound_s"]
    # every production cell, the card's torch's once-refused ones too
    assert [tuple(p["cell"]) for p in by["dryrun_production"]] == list(
        production)
    for prod in by["dryrun_production"]:
        assert prod["ok"] and prod["returncode"] == 0
        assert prod["chips"] == 256
        assert prod["roofline"]["dominant"] in ("compute", "memory",
                                                "collective")
    assert by["dryrun_phase"][0]["failures"] == []


def test_chip_smoke_dryrun_phase_fails_on_a_wrong_count(dryrun_phase,
                                                        monkeypatch):
    """Work that only the meta dry-run does (an extra product under the
    mesh) must fail the FLOPs check."""
    from repro_torch.models import layers
    whole = layers.heads_whole

    def extra(policy, w, heads, out=False):
        if policy.mesh is not None:
            w.flatten(1) @ w.flatten(1).T
        return whole(policy, w, heads, out)

    monkeypatch.setattr(layers, "heads_whole", extra)
    with pytest.raises(AssertionError, match="dryrun: .*FLOPs"):
        dryrun_phase()


def test_chip_smoke_dryrun_phase_fails_on_an_uncounted_launch(
        dryrun_phase, monkeypatch):
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref
    monkeypatch.setattr(fmod, "flash_attention", ref.flash_attention_ref)
    with pytest.raises(AssertionError, match="dryrun: .*launches"):
        dryrun_phase()
