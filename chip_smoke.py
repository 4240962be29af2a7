#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure exits non-zero:

1. device  -- the card's name and power limit (nvidia-smi) and the count.
2. build   -- nvcc builds every kernel source of the port, one process per
              source, all started together; ptxas' registers, shared memory
              and spills per kernel (none allowed in the int8 GEMM and the
              SSD scan), and the tensor-core instructions in each library's
              SASS (the int8 GEMM must hold s8 wgmma, the SSD TF32 mma).
3. kernels -- each kernel against its plain PyTorch version on the card:
              the int8 GEMM on both layouts of w_q (K-major, its native
              layout, and row-major) over ragged M, K, N (around the decode
              and prefill bodies' tiles, and near K_MAX at the largest
              sums) and both output dtypes, bitwise;
              attention over a sweep of head dims (64, 112, 128, 256), GQA
              groups, dtypes, causal flags and ragged lengths (flash: query
              lengths around the 128-row tile and causal offsets; decode:
              cache lengths at the split-KV boundaries +- 1), and the bf16
              flash wrapper refusing a misaligned stride; the SSD scan
              against its dual form, its sequential recurrence and that
              recurrence in float64 over head dims, state dims, ragged
              lengths, batches, with and without an initial state, both
              ranges of A (around -1; -1 to -16 as the models set it), and
              split in two with the state carried; then at the serving
              shapes of qwen2-7b, zamba2-7b, mamba2-130m, gemma-2b and
              granite-3-2b (and qwen2-7b-int8's MLP up-projection at
              prefill and decode, on each layout of w_q) the kernel, plain
              and library times (CUDA events, L2 flushed before each
              launch; the int8 GEMM also after a flush that only reads)
              and the roofline bound (the SSD's at the fp32-accurate
              tensor-core rate, its FP32 FMA figure beside).
4. model   -- full-width qwen2-7b and zamba2-7b in bf16 (random weights
              from a seeded generator): a prefill through the kernels with
              every kernel call also held against its plain version on the
              same inputs and every SSD call against the recurrence in
              float64; its logits against the same model on the plain
              versions, with control readings (one wrong call; the SSD's
              chunk halved, which changes only the rounding); then, at full
              widths but 2 (qwen2) or 7 (zamba2: one group of 6 and one)
              layers in fp32, greedy generation through both paths and
              teacher-forced logits of the kernel path against the plain
              path in float64.
5. serve   -- the main path, once per model: 8 requests (prompt lengths
              256-512 drawn from --seed, 16 new tokens each) through
              Batcher -> Engine on full-width qwen2-7b, zamba2-7b and
              mamba2-130m (qwen2's decode steps replay as CUDA graphs
              between its decode-attention calls, which stay eager and
              counted), with the kernels' launch counts set to 0 just
              before each and checked just after: one flash launch per
              attention application per prefill, one decode launch per
              application per decode step, one SSD launch per Mamba2 layer
              per prefill (qwen2 28/420/0, zamba2 14/210/81, mamba2 0/0/24).
6. profile -- for each served model, the engine's prefill and decode-step
              times at the serve batch's padded shape on the host clock,
              then under
              torch.profiler: device time by kernel and the device's idle
              share in each.
7. int8    -- the int8 path on full-width qwen2-7b's layer 0: each of its
              seven projection weights quantised per output channel, kept
              K-major, and run
              through ops.quant_linear on the inputs the layer really gets
              in one prefill of the serve batch and the decode step after
              it; each call equal to the plain version (and to the same
              call on the row-major weight), one launch each,
              within 10 % of the error uniform int8 rounding predicts, and
              (all but the MLP down-projection, whose SwiGLU input is
              heavy-tailed) within 0.02 of the dense fp32 product.
8. moe      -- the MoE family at full width, its depth cut to fit the
              card: llama4-scout at 8 of its 48 layers and llama4-maverick
              at one group (a dense layer, then an MoE layer over 128
              experts), random weights from a seeded generator, in bf16.
              For each: a prefill of the serve batch's size (8 x 512)
              with every flash call held against its plain version; then
              the full-sequence logits and every MoE layer's routes
              (experts and keeps) through the kernels and through the
              plain versions, with each route flip's router-probability
              margin; a primary flip (everything before it in its row
              agreed in every earlier layer) must sit below ROUTE_MARGIN,
              and the logits limit holds the tokens whose row agrees up to
              them in every layer; a rounding-only control (the plain
              attention in float64) and a wrong-kernel control (the first
              attention not causal) printed beside.  Scout also runs 2
              layers in fp32 as the model phase does.  Both serve the 8
              requests through Batcher -> Engine (decoded eagerly) with
              launches exact (scout 8 / 120, maverick 2 / 30) and each
              MoE layer's drops at prefill (pads counted); scout's batch
              is profiled with routing, dispatch, the experts, the shared
              expert and attention annotated.  Peak memory per model.
9. plan     -- the planning chain on the card: the port's H100_SXM preset
              against the card (132 SMs, the usable HBM, a pinned 1 GiB
              host-to-device copy beside the preset's staging bandwidth);
              full-batch prefills and decode steps of the compound engines
              (gemma-2b, granite-3-2b, qwen2-7b; batch 8, prompt 256) fit
              the preset's flops and HBM efficiencies (one-parameter least
              squares of the profiler's own model at the served lengths),
              printed beside the measured services before and after the
              fit; the deadline scale is fixed from the measured services
              (max(4, 3 x the longest path / SLO)); then the port's Planner
              plans social_media at 4 rps on one MIG-carved H100
              (h100_cluster(1)), and fails if there is no plan or its
              MigSlicePacker does not pack it; the plan for four cards at
              40 rps is printed beside it.
10. compound -- the main path through the port's own ClusterRuntime: the
              social_media app on the plan phase's plan, each instance
              served on the whole card by EngineBackend at full width in
              bf16 (planned int8 variants too), Poisson 4 rps for 10 s of
              scenario time from --seed, deadlines at the plan phase's
              scale; every root arrival ends completed or dropped, each
              arch's flash and decode launches are exact, and each served
              tuple's planned latency is printed beside its services.
11. control -- the adaptive control loop on the same engines: the port's
              Controller steps social_media through 8 bins of 4 s of a
              diurnal trace (seed 2; its peak is 4 rps unless one card's
              plan only changes above that, then raised until the
              predicted demand crosses the first change), re-planning on
              the fitted h100_cluster(1), executing each plan change as a
              staged transition, with a failure detector, an emergency
              re-planner, a degradation ladder and instrumentation
              (tracer, SLO plane, audit log) attached; bin 4 loses 1
              g-unit of 7.  Every root ends completed or dropped in every
              bin, >= 2 bins re-plan and one runs a transition with loads,
              the lost unit reaches bin 5's planner, launches are exact
              per arch, and the hooks' counters, spans and audit events
              agree with the bins' SimMetrics.
12. gateway -- the serving front door on the same engines: the port's
              AsyncGateway serves social_media live behind its HTTP server
              on 127.0.0.1 (an ephemeral port), on the plan phase's plan
              with the SLO at that phase's scale and instrumentation
              (tracer, SLO plane, audit log) attached; the port's load
              generator sends Poisson 4 rps for 10 s from --seed over HTTP,
              then one streamed submit, and /metrics, /trace, /alerts,
              /audit and /healthz are scraped.  Every submission resolves
              and one at least is ok, no root is left, the scraped
              counters agree with the load report, the trace holds a
              queue and a service span per hop, the stream ends in done
              on deployed variants, and launches are exact per arch; the
              host seconds each inline service_s blocked the event loop,
              each batch's end beside its service, and the launches to a
              server still serving an earlier batch are printed.
13. train   -- the training path (``launch/train.py``, ``training/``,
              ``Model.loss``) on the plain attention, as the reference
              trains on its jnp attention.  granite-3-2b at full width and
              2 layers in fp32 on one batch (8 x 256) of the data pipeline:
              the loss within 1e-5 and every parameter's gradient within
              1e-3 (max |dg| over max |g|) of the same model in float64;
              remat "full" and "dots" against none; 4 microbatches against
              1 and int8 compression against exact over 8 steps, at
              tests/test_training.py's limits (int8 held to its 0.12 at
              its own reduced configuration; at full width, where the
              reference's algorithm drifts further, the reading is printed
              and the compressed run must learn); a model on the kernels
              refusing loss().backward().  Then all 40 layers in bf16
              through the launcher's setup for 12 steps: finite loss and
              grad norm, the optimizer at step 12, the last loss 0.3 below
              the first, no kernel launched; step time (host clock after
              synchronize), tokens/s, peak memory, one step under
              torch.profiler (idle share, device time by kind and the
              largest kernels), one step split into forward, backward and
              AdamW, and the peak of one loss and gradient under each
              remat.  Last, mamba2-130m at full width and depth in bf16:
              6 steps straight against 3 + checkpoint + restore + 3 (a
              temporary directory, removed) within 1e-6.
14. shard   -- the sharding substrate (sharding/policy.py, launch/mesh.py,
              DTensor parameters) on the card's 1x1 ("data", "model") mesh
              of a one-rank NCCL group: full-width qwen2-7b and
              mamba2-130m in bf16 serve the serve phase's 8 requests
              without a policy and then with the decode-kind policy on the
              same weights (parameters placed as DTensors, kernels reached
              on local shards); tokens identical, first-step logits within
              LOGITS_TOL, every kernel's launches equal and exact; wall per
              batch, idle share of a profiled batch, graphed or eager
              decode, peak memory and DTensor's collectives per batch,
              both ways.  Then granite-3-2b at full width (8 x 256) trains
              3 steps without a policy and, its state freed, 3 from the
              same seed under the training policy: losses within 1e-3
              relative, step times, peak memory and collectives.
15. dryrun  -- the dry-run and roofline (launch/specs.py, dryrun.py,
              roofline.py) held against the card's own steps.  Three card
              cells, each counted on meta over the 1x1 mesh (one-rank
              NCCL group; build_step, impl="plain") and then run on the
              card: qwen2-7b's prefill of the serve batch's padded shape,
              one qwen2-7b decode step (cache_len the padded prompt of
              prompt + SERVE_NEW), and granite-3-2b's train step (8 x 256,
              remat none, one microbatch, as phase 13 runs it).  The
              counted FLOPs must equal the same counting mode's over the
              card's step on the plain versions without a policy, the
              argument bytes be within 1 % of what the card allocated for
              the step's setup, and the served steps (on the kernels)
              launch flash / decode exactly once a layer; printed beside:
              the predicted peak and max_memory_allocated of the plain
              step, the wall of each timed step (host clock after
              synchronize), compute and memory bounds of the timed path
              (the served steps' from the dry-run's kernel-path count, the
              train step's from its plain count), wall over bound, the
              plain path's bounds beside them, and the roofline fraction
              (2ND, 6ND for training, over wall x 989e12).  Then the
              production cells qwen2-7b x decode_32k and llama4-scout x
              train_4k on the 256-rank pod mesh, each
              through python -m repro_torch.launch.dryrun in a subprocess
              on a fake group (no card visible): each must end ok; its
              roofline row, memory, collectives by kind and seconds are
              printed.

The second-to-last line is ``{"kernels": [...]}``, one row per kernel at
its main serving shape (four for quant_matmul: prefill and decode, each
on both layouts of w_q; the
attention kernels also at gemma-2b's and granite-3-2b's compound shapes
and at llama4-scout's), ``launches`` from the serve run of the model whose
shape the row names (``launches_by_model`` gives all five), from the compound phase for
gemma-2b and granite-3-2b (0 where the plan serves that arch no call), or
for quant_matmul from the int8 phase at that shape; the last is
``{"ok": true, "device": {...}}``.  Exits 2 with no result when
there is no CUDA device or no ``src/repro_torch`` beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W.
# "fp32_tc": fp32-accurate products on the tensor cores, 3xTF32 (three
# TF32 passes a product), the least time an fp32 SSD could take there.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
              "fp32_tc": 495e12 / 3}
PEAK_BYTES_S = 3.35e12
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:14-15

QWEN, ZAMBA, MAMBA = "qwen2-7b", "zamba2-7b", "mamba2-130m"
GEMMA, GRANITE = "gemma-2b", "granite-3-2b"     # the compound phase's others
SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
SERVE_BATCH, SERVE_MAX_SEQ, SERVE_NEW = 8, 1024, 16
PROMPT_LENS = (256, 512)
SSD_TOL = 2e-3                               # tests/test_kernels.py:74-77
# The SSD's y and final state against its recurrence in float64: max |error|
# over the largest |value|.  An fp32 recurrence reads ~1e-7, a dual form
# whose cumulative decay is summed in fp32 ~1e-5.
SSD_F64_TOL = 2e-6
LOGITS_TOL = 2e-2            # full-model prefill logits, kernel vs plain
FP32_LOGITS_TOL = 1e-3       # fp32 at a few layers, kernel vs float64
KERNELS = ("flash_attention", "decode_attention", "ssd_scan", "quant_matmul")
QMM_TOL = 1e-6            # int8 product: exact (tests/test_kernels.py:112)
# qwen2-7b-int8's MLP up-projection: K 3584 -> N 18944, at the serve
# batch's prefill (8 x 474 rows) and at one decode step (8 rows)
QMM_K, QMM_N = 3584, 18944
QMM_PREFILL, QMM_DECODE = "qwen2-7b-int8 prefill", "qwen2-7b-int8 decode"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "count": torch.cuda.device_count()}
    print(smi, flush=True)
    emit("device", **card, torch=torch.__version__,
         cuda=torch.version.cuda)
    return card


# Tensor-core instructions each redesigned library must hold in its SASS:
# the int8 GEMM's wgmma with s8 operands (IGMMA ... S8.S8), the SSD's
# mma.sync with TF32 operands (HMMA ... TF32).
SASS_REQUIRED = {"quant_matmul": ("GMMA", "S8.S8"),
                 "ssd_scan": ("HMMA", "TF32")}
NO_SPILLS = ("quant_matmul", "ssd_scan")     # ptxas: 0 bytes spilled


def phase_build() -> None:
    """Build every kernel source; ptxas' report per kernel, and the tensor-
    core instructions (HGMMA/IGMMA from wgmma, HMMA/IMMA from mma.sync) in
    each library's SASS (``cuobjdump``).  Fails if a kernel of NO_SPILLS
    spills or a library lacks its SASS_REQUIRED instructions."""
    import re
    import shutil
    from repro_torch.kernels import build
    t0 = time.monotonic()
    logs = build.build_all()
    seconds = round(time.monotonic() - t0, 2)
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "ptxas info" in ln or "spill" in ln]
             for name, log in logs.items()}
    spilled = {name: [ln for ln in ptxas[name]
                      if re.search(r"[1-9]\d* bytes spill", ln)]
               for name in NO_SPILLS}
    cuobjdump = (shutil.which("cuobjdump")
                 or str(Path(build.nvcc()).with_name("cuobjdump")))
    sass_mma = {}
    for name in build.SOURCES:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(build.library_path(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        lines = [ln for ln in sass.splitlines()
                 if re.search(r"\b[HI](G)?MMA\.", ln)]
        forms = {}
        for ln in lines:
            form = ln.split(";")[0].split("*/")[-1].split()[0]
            forms[form] = forms.get(form, 0) + 1
        sass_mma[name] = {"lines": len(lines), "forms": forms,
                          "b_transposed": sum("tnspB" in ln for ln in lines)}
    required = {name: sum(n for f, n in sass_mma[name]["forms"].items()
                          if all(part in f for part in parts))
                for name, parts in SASS_REQUIRED.items()}
    emit("build", seconds=seconds, ptxas=ptxas, sass_mma=sass_mma,
         sass_required_lines=required, spills=spilled)
    if any(spilled.values()) or not all(required.values()):
        raise AssertionError(f"build: spills {spilled}, required SASS "
                             f"lines {required}")


# ---------------------------------------------------------------------------
def _max_err(torch, out, want, tol: float):
    """Max |out - want| and whether every element is within
    atol + rtol * |want| with atol = rtol = tol."""
    o, w = out.float(), want.float()
    err = (o - w).abs()
    ok = bool(torch.isfinite(o).all()) and bool(
        (err <= tol + tol * w.abs()).all())
    return float(err.max()), ok


def _rel_errs(got, exact) -> list:
    """Per tensor, max |got - exact| over max |exact| (exact in float64)."""
    return [float((g.double() - e).abs().max() / e.abs().max())
            for g, e in zip(got, exact)]


def _time_ms(torch, fn, flush, iters: int = 20, dirty: bool = True) -> float:
    """Mean device time of one ``fn`` call over ``iters`` calls, each
    between two CUDA events with the L2 cache flushed before it, after two
    warm-up calls.  The flush writes ``flush`` (``dirty``: the call then
    also pays for writing those lines back) or only reads it.

    A sleep kernel is queued first, so the host has queued every call
    before the card reaches the first: the events then bracket device work
    only, not the host's time to launch it.  If the sleep ended before the
    last call was queued, the card may have waited on the host, so the
    calls are timed again behind a sleep twice as long."""
    sink = torch.empty((), dtype=torch.int64, device=flush.device)

    def flush_l2():
        if dirty:
            flush.zero_()
        else:
            torch.sum(flush.view(torch.int64), 0, out=sink)

    for _ in range(2):
        flush_l2()
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24                 # ~10 ms at 1.7 GHz
    for _ in range(6):
        torch.cuda._sleep(cycles)
        asleep = torch.cuda.Event()
        asleep.record()
        pairs = []
        for _ in range(iters):
            flush_l2()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        host_ahead = not asleep.query()
        torch.cuda.synchronize()
        if host_ahead:
            return sum(a.elapsed_time(b) for a, b in pairs) / iters
        cycles *= 2
    raise RuntimeError("the host could not queue the timed calls ahead of "
                       "the card")


def _bound(flop: float, nbytes: float, dtype: str):
    t_ops = flop / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _ssd_flop_bytes(B, S, nh, hd, ds, with_init: bool):
    """The least FLOP that computes the SSD scan of these S rows, and the
    bytes that must move: x, dt, B, C (read once for all heads), y, the
    final state and the initial one, all fp32.  The FLOP are the smaller of
    the exact recurrence's (5 hd ds a row: the decay, the rank-1 update,
    y = state . C) and the dual form's at the kernel's chunks counted over
    the causal triangles only (C B^T and (L o .)(x dt) over r(r+1)/2 pairs,
    the entering state's C state^T and the state update)."""
    from repro_torch.kernels.ssd_scan import CHUNK
    dual = 0
    for c0 in range(0, S, CHUNK):
        r = min(CHUNK, S - c0)
        pairs = r * (r + 1) // 2
        dual += 2 * pairs * (ds + hd) + 4 * r * ds * hd
    flop = B * nh * min(dual, 5 * hd * ds * S)
    nbytes = 4.0 * (2 * B * S * nh * hd + B * S * nh + nh + 2 * B * S * ds
                    + (2 if with_init else 1) * B * nh * hd * ds)
    return float(flop), nbytes


def phase_kernels(torch, card) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      split_plan)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import K_MAX as QMM_K_MAX
    from repro_torch.kernels.quant_matmul import plan as qmm_plan
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.ssd_scan import slice_plan, ssd_scan

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ssd_inputs(B, S, nh, hd, ds, decay="model"):
        """x, dt (softplus'd), A (< 0), B, C, fp32.  ``decay="model"``: A
        from -1 to -16 over the heads, as the models' ``A_log`` sets it;
        ``"unit"``: A = -exp(N(0, 1/4)), around -1."""
        A = (-torch.linspace(1.0, 16.0, nh, device=dev) if decay == "model"
             else -torch.exp(randn(nh) * 0.5))
        return (randn(B, S, nh, hd), F.softplus(randn(B, S, nh)), A,
                randn(B, S, ds), randn(B, S, ds))

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def qmm_inputs(M, K, N):
        """int8 x [M,K] and w [K,N] over the whole range, positive fp32
        scales."""
        return (int8(M, K), int8(K, N),
                torch.rand(M, generator=gen, device=dev) + 1e-3,
                torch.rand(N, generator=gen, device=dev) + 1e-3)

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    failures, n_cases, worst_f64 = [], 0, 0.0
    worst = dict.fromkeys(KERNELS, 0.0)

    def check(kernel, out, want, tol, **case):
        nonlocal n_cases
        err, ok = _max_err(torch, out, want, tol)
        n_cases += 1
        worst[kernel] = max(worst[kernel], err)
        if not ok:
            failures.append(dict(kernel=kernel, err=err, **case))

    # flash: hd x G x causal x dtype, cycling through ragged (Sq, Skv):
    # query lengths around the bf16 kernel's 128-row tile, and Sq < Skv
    # (causal rows at an offset)
    seqs = [(500, 500), (64, 192), (37, 37), (200, 333), (127, 127),
            (129, 129), (128, 300), (129, 257)]
    case = 0
    for hd in (64, 112, 128, 256):
        for G in (1, 4, 7, 8):
            for causal in (True, False):
                for dname, dt in dtypes.items():
                    Sq, Skv = seqs[case % len(seqs)]
                    case += 1
                    B, KV = 2, 2
                    q = randn(B, Sq, KV * G, hd, dtype=dt)
                    k = randn(B, Skv, KV, hd, dtype=dt)
                    v = randn(B, Skv, KV, hd, dtype=dt)
                    check("flash_attention",
                          flash_attention(q, k, v, causal=causal),
                          ref.flash_attention_ref(q, k, v, causal=causal),
                          TOLS[dname], hd=hd, G=G, causal=causal,
                          dtype=dname, Sq=Sq, Skv=Skv)
    # bf16 flash on a view whose head stride is not a whole 16 bytes: the
    # wrapper refuses it (TMA) and launches nothing
    base = randn(1, 64, 2, 68, dtype=torch.bfloat16)
    qv = base[..., :64]              # head stride 68 elements = 136 bytes
    n0 = fmod.launches
    try:
        flash_attention(qv, qv, qv)
        failures.append(dict(kernel="flash_attention", case="misaligned "
                             "stride accepted"))
    except ValueError:
        pass
    if fmod.launches != n0:
        failures.append(dict(kernel="flash_attention", case="misaligned "
                             "stride counted a launch"))
    n_cases += 1
    # decode: cache lengths at the split-KV boundaries +- 1 of each plan
    # (zamba2's, qwen2's and gemma-2b's groups on a 1024-position cache)
    for (B, KV, G, hd), dname in itertools.product(
            ((8, 32, 1, 112), (8, 4, 7, 128), (8, 1, 8, 256), (2, 1, 8, 64)),
            dtypes):
        S, dt = SERVE_MAX_SEQ, dtypes[dname]
        q = randn(B, 1, KV * G, hd, dtype=dt)
        kc = randn(B, S, KV, hd, dtype=dt)
        vc = randn(B, S, KV, hd, dtype=dt)
        sl = split_plan(B, KV, S, sm_count)[0]
        for cl in sorted({c for c in (1, 63, 64, 65, sl - 1, sl, sl + 1,
                                      2 * sl - 1, 2 * sl + 1, 528, S)
                          if 1 <= c <= S}):
            check("decode_attention", decode_attention(q, kc, vc, cl),
                  ref.decode_attention_ref(q, kc, vc, cl), TOLS[dname],
                  hd=hd, G=G, KV=KV, dtype=dname, cache_len=cl,
                  split=split_plan(B, KV, cl, sm_count))
    # decode: hd x G x fill x dtype on a ragged cache of 1000 positions
    for hd in (64, 112, 128, 256):
        for G in (1, 4, 7, 8):
            for fill in (0.3, 1.0):
                for dname, dt in dtypes.items():
                    B, S, KV = 3, 1000, 2
                    cl = max(1, int(S * fill))
                    q = randn(B, 1, KV * G, hd, dtype=dt)
                    kc = randn(B, S, KV, hd, dtype=dt)
                    vc = randn(B, S, KV, hd, dtype=dt)
                    check("decode_attention", decode_attention(q, kc, vc, cl),
                          ref.decode_attention_ref(q, kc, vc, cl),
                          TOLS[dname], hd=hd, G=G, fill=fill, dtype=dname,
                          cache_len=cl)
    # ssd: hd x ds x S (ragged and prime included) x B x init state x the
    # range of A, each against the dual form and the exact recurrence, and
    # against the recurrence in float64 (SSD_F64_TOL, relative to the
    # largest value); every case with an init state is also split in two
    # with the state carried.
    for hd, ds, S, B, with_init, decay in itertools.product(
            (64, 16), (64, 128), (64, 128, 474, 37, 257), (1, 8),
            (False, True), ("unit", "model")):
        nh = 4
        x, dt, A, Bm, Cm = ssd_inputs(B, S, nh, hd, ds, decay)
        s0 = randn(B, nh, hd, ds) if with_init else None
        y, fin = ssd_scan(x, dt, A, Bm, Cm, init_state=s0)
        cs = dict(hd=hd, ds=ds, S=S, B=B, init=with_init, decay=decay)
        for name, plain in (("dual", ref.ssd_scan_ref),
                            ("recurrence", ref.ssd_ref)):
            want_y, want_s = plain(x, dt, A, Bm, Cm, init_state=s0)
            check("ssd_scan", y, want_y, SSD_TOL, part="y", plain=name, **cs)
            check("ssd_scan", fin, want_s, SSD_TOL, part="state",
                  plain=name, **cs)
        exact = ref.ssd_ref(*(t.double() for t in (x, dt, A, Bm, Cm)),
                            init_state=None if s0 is None else s0.double())
        for part, err in zip(("y", "state"), _rel_errs((y, fin), exact)):
            worst_f64 = max(worst_f64, err)
            if err > SSD_F64_TOL:
                failures.append(dict(kernel="ssd_scan", vs="float64",
                                     part=part, rel_err=err, **cs))
        if with_init:
            h = S // 2
            y1, s1 = ssd_scan(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h],
                              init_state=s0)
            y2, s2 = ssd_scan(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:],
                              init_state=s1)
            check("ssd_scan", torch.cat([y1, y2], 1), y, SSD_TOL,
                  part="split y", **cs)
            check("ssd_scan", s2, fin, SSD_TOL, part="split state", **cs)
    # int8: each product on both layouts of w_q (row-major, and K-major:
    # the kernel's native layout), each against the plain version and
    # required bitwise equal to it; the bodies the plan picked are counted.
    qmm_exact = qmm_cases = 0
    qmm_paths = {}

    def qmm_check(xq, wq, xs, ws, dnames=tuple(dtypes), **case):
        nonlocal qmm_exact, qmm_cases
        for layout, w in (("row", wq), ("k", wq.t().contiguous().t())):
            path = qmm_plan(xq, w)
            qmm_paths[path] = qmm_paths.get(path, 0) + 1
            for dname in dnames:
                od = dtypes[dname]
                out = quant_matmul(xq, w, xs, ws, out_dtype=od)
                want = ref.quant_matmul_ref(xq, wq, xs, ws, od)
                check("quant_matmul", out, want, QMM_TOL, layout=layout,
                      path=path, out_dtype=dname, **case)
                qmm_cases += 1
                equal = bool(torch.equal(out, want))
                qmm_exact += equal
                if not equal:
                    failures.append(dict(kernel="quant_matmul", bitwise=False,
                                         layout=layout, path=path,
                                         out_dtype=dname, **case))

    # M x K x N (ragged, the decode and prefill rows, qwen2-7b-int8's
    # widths) x out dtype; the largest products are skipped to keep the
    # sweep short.
    for M, K, N in itertools.product((1, 8, 17, 128, 3792),
                                     (32, 200, 3584, 18944),
                                     (8, 100, 3584, 4608, 18944)):
        if M * K * N > 4e11:
            continue
        qmm_check(*qmm_inputs(M, K, N), M=M, K=K, N=N)
    # ragged around the redesigned bodies' tiles: M around the decode
    # body's widths (8 .. 64) and the prefill body's 128-row tiles, K past
    # a 128-byte box (3600) and not a 16-byte multiple (200: the mma.sync
    # body on either layout), N past a 64/256-column tile
    for M, K, N in itertools.product((1, 8, 16, 17, 64, 65, 129, 3792),
                                     (200, 3584, 3600), (100, 18944, 18950)):
        qmm_check(*qmm_inputs(M, K, N), dnames=("float32",), M=M, K=K, N=N)
    # near K_MAX with every product at +-127^2: the int32 sums (and the
    # decode body's split-K partial sums) at their largest; K 131,056 is a
    # 16-byte multiple (the TMA bodies), K_MAX itself is not
    for M, K in ((8, 131056), (65, 131056), (3, QMM_K_MAX)):
        xq, wq, xs, ws = qmm_inputs(M, K, 100)
        xq.fill_(127)
        wq.fill_(127)
        wq[:, 1::2] = -127
        qmm_check(xq, wq, xs, ws, dnames=("float32",), M=M, K=K, N=100,
                  extreme=True)
    # strided rows and unaligned starts: the mma.sync body's byte-wise loads
    xq, wq, xs, ws = qmm_inputs(40, 210, 110)
    xv, wv, wsv = xq[:, 3:203], wq[:200, 1:101], ws[1:101].contiguous()
    for layout, w in (("row", wv), ("k", wq.t().contiguous()[1:101, :200].t())):
        out = quant_matmul(xv, w, xs, wsv)
        want = ref.quant_matmul_ref(xv, wv, xs, wsv)
        check("quant_matmul", out, want, QMM_TOL, M=40, K=200, N=100,
              out_dtype="float32", strided=True, layout=layout)
        qmm_cases += 1
        qmm_exact += bool(torch.equal(out, want))
    torch.cuda.synchronize()
    emit("kernels_sweep", cases=n_cases, failures=failures,
         max_abs_err=worst, ssd_max_rel_err_vs_float64=worst_f64,
         quant_matmul_cases=qmm_cases, quant_matmul_bitwise_equal=qmm_exact,
         quant_matmul_paths=qmm_paths)
    if failures:
        raise AssertionError(f"{len(failures)} kernel cases out of "
                             f"tolerance: {failures[:5]}")

    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    bf = torch.bfloat16
    rows, extra, oks = [], [], {}

    def time_row(row, fn, plain, library):
        row.update(ms=_time_ms(torch, fn, flush),
                   plain_ms=_time_ms(torch, plain, flush),
                   library_ms=(None if library is None
                               else _time_ms(torch, library, flush)))
        return row

    def flash_at(tag, B, S, H, KV, hd):
        q, k, v = (randn(B, S, H, hd, dtype=bf), randn(B, S, KV, hd, dtype=bf),
                   randn(B, S, KV, hd, dtype=bf))
        err, oks[f"flash {tag}"] = _max_err(
            torch, flash_attention(q, k, v), ref.flash_attention_ref(q, k, v),
            TOLS["bfloat16"])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = S * (S + 1) // 2                  # causal (query, key) pairs
        bound, by = _bound(4.0 * B * H * hd * pairs,
                           2.0 * (2 * q.numel() + k.numel() + v.numel()),
                           "bfloat16")
        return time_row(dict(
            name="flash_attention", route="cuda", model=tag,
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:86",
            shape=f"{tag}: q [{B},{S},{H},{hd}] k/v [{B},{S},{KV},{hd}] "
                  f"bf16 causal",
            max_abs_err=max(err, worst["flash_attention"]),
            bound_ms=bound, bound_by=by),
            lambda: flash_attention(q, k, v),
            lambda: ref.flash_attention_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))

    def decode_at(tag, B, H, KV, hd, cl):
        q1 = randn(B, 1, H, hd, dtype=bf)
        kc = randn(B, SERVE_MAX_SEQ, KV, hd, dtype=bf)
        vc = randn(B, SERVE_MAX_SEQ, KV, hd, dtype=bf)
        err, oks[f"decode {tag}"] = _max_err(
            torch, decode_attention(q1, kc, vc, cl),
            ref.decode_attention_ref(q1, kc, vc, cl), TOLS["bfloat16"])
        q1t = q1.transpose(1, 2)
        kct, vct = kc[:, :cl].transpose(1, 2), vc[:, :cl].transpose(1, 2)
        bound, by = _bound(4.0 * B * H * hd * cl,
                           2.0 * (2 * B * cl * KV * hd + 2 * q1.numel()),
                           "bfloat16")
        split_len, n_splits = split_plan(B, KV, cl, sm_count)
        return time_row(dict(
            name="decode_attention", route="cuda", model=tag,
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:65",
            shape=f"{tag}: q [{B},1,{H},{hd}] caches [{B},{SERVE_MAX_SEQ},"
                  f"{KV},{hd}] bf16 cache_len {cl}",
            max_abs_err=max(err, worst["decode_attention"]),
            bound_ms=bound, bound_by=by,
            split_len=split_len, split_blocks=n_splits * KV * B),
            lambda: decode_attention(q1, kc, vc, cl),
            lambda: ref.decode_attention_ref(q1, kc, vc, cl),
            lambda: F.scaled_dot_product_attention(q1t, kct, vct,
                                                   enable_gqa=True))

    def ssd_at(tag, B, S, nh, hd, ds, chunk):
        x, dt, A, Bm, Cm = ssd_inputs(B, S, nh, hd, ds)
        y, fin = ssd_scan(x, dt, A, Bm, Cm)
        dual = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
        err = 0.0
        for name, (want_y, want_s) in (
                ("dual", dual), ("recurrence", ref.ssd_ref(x, dt, A, Bm, Cm))):
            e_y, ok_y = _max_err(torch, y, want_y, SSD_TOL)
            e_s, ok_s = _max_err(torch, fin, want_s, SSD_TOL)
            oks[f"ssd {tag} vs {name}"] = ok_y and ok_s
            err = max(err, e_y, e_s)
        # Both fp32 forms against the recurrence in float64.
        exact = ref.ssd_ref(*(t.double() for t in (x, dt, A, Bm, Cm)))
        f64 = {"kernel": _rel_errs((y, fin), exact),
               "plain": _rel_errs(dual, exact)}
        oks[f"ssd {tag} vs float64"] = max(f64["kernel"]) <= SSD_F64_TOL
        # The bound at the fp32-accurate tensor-core rate (the kernel's own
        # route); the FP32 FMA figure beside it, named as such.
        flop, nbytes = _ssd_flop_bytes(B, S, nh, hd, ds, False)
        bound, by = _bound(flop, nbytes, "fp32_tc")
        P = slice_plan(B, nh, hd, ds, sm_count)
        # The same call at 4x B*nh blocks (slices of hd / 4), beside the
        # wrapper's plan: held to the same limits and timed.
        P4 = hd // 4
        with _slice_width(P4):
            y4, fin4 = ssd_scan(x, dt, A, Bm, Cm)
            oks[f"ssd {tag} at P {P4} vs float64"] = (
                max(_rel_errs((y4, fin4), exact)) <= SSD_F64_TOL)
            ms_4x = _time_ms(torch, lambda: ssd_scan(x, dt, A, Bm, Cm), flush)
        return time_row(dict(
            name="ssd_scan", route="cuda", model=tag,
            source="src/repro_torch/kernels/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:78",
            shape=f"{tag}: x [{B},{S},{nh},{hd}] B/C [{B},{S},{ds}] fp32",
            max_abs_err=max(err, worst["ssd_scan"]),
            y_state_rel_err_vs_float64=f64,
            bound_ms=bound, bound_by=by,
            bound_fp32_fma_ms=_bound(flop, nbytes, "float32")[0],
            slice_width=P, blocks=B * nh * (hd // P), batch_x_heads=B * nh,
            ms_at_4x_blocks={"slice_width": P4, "blocks": 4 * B * nh,
                             "ms": ms_4x}),
            lambda: ssd_scan(x, dt, A, Bm, Cm),
            lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk),
            None)            # no single PyTorch call computes the SSD scan

    def qmm_at(tag, M, K, N):
        """The int8 product as ``ops.quant_linear`` runs it (fp32 out), one
        row per layout of w_q: K-major (the kernel's native layout; the
        weight is quantised once and kept so, outside any timed call) and
        row-major.  The library call is ``torch._int_mm`` plus the same
        epilogue in torch ops on the same layout (K-major is cuBLASLt's
        int8 layout); it needs M > 16, so a smaller M is padded to 32 rows
        outside the timed call."""
        xq, wq, xs, ws = qmm_inputs(M, K, N)
        want = ref.quant_matmul_ref(xq, wq, xs, ws)
        xp = xq if M > 16 else torch.cat([xq, xq.new_zeros(32 - M, K)])
        bound, by = _bound(2.0 * M * K * N,
                           M * K + K * N + 4.0 * (M + N) + 4.0 * M * N,
                           "int8")
        out_rows = []
        for layout, w in (("K-major", wq.t().contiguous().t()),
                          ("row-major", wq)):
            label = f"{tag} {layout}"
            out = quant_matmul(xq, w, xs, ws)
            err, oks[f"quant_matmul {label}"] = _max_err(torch, out, want,
                                                         QMM_TOL)
            oks[f"quant_matmul {label} bitwise"] = bool(torch.equal(out,
                                                                    want))

            def library(w=w):
                acc = torch._int_mm(xp, w)[:M]
                return acc.float() * xs[:, None] * ws[None, :]

            row = time_row(dict(
                name="quant_matmul", route="cuda", model=tag, layout=layout,
                source="src/repro_torch/kernels/csrc/quant_matmul.cu",
                replaces="src/repro/kernels/quant_matmul.py:46",
                shape=f"{tag}: x_q [{M},{K}] w_q [{K},{N}] {layout} int8 "
                      f"-> fp32",
                body=qmm_plan(xq, w),
                max_abs_err=max(err, worst["quant_matmul"]),
                bound_ms=bound, bound_by=by),
                lambda w=w: quant_matmul(xq, w, xs, ws),
                lambda: ref.quant_matmul_ref(xq, wq, xs, ws), library)
            row["library"] = (f"torch._int_mm + epilogue, w_q {layout}"
                              + ("" if M > 16 else f" (M padded {M} -> 32)"))
            # the same with a flush that leaves no dirty lines in L2 to
            # write back during the call
            row["ms_read_flush"] = _time_ms(torch, lambda w=w: quant_matmul(
                xq, w, xs, ws), flush, dirty=False)
            row["library_ms_read_flush"] = _time_ms(torch, library, flush,
                                                    dirty=False)
            row["library_equal"] = bool(torch.equal(library(), want))
            out_rows.append(row)
        return out_rows

    # one row per kernel at its main serving shape (qwen2-7b's attention,
    # zamba2-7b's SSD, qwen2-7b-int8's MLP up-projection at prefill and at
    # a decode step); zamba2's hd-112 attention and mamba2's SSD beside
    B = SERVE_BATCH
    rows.append(flash_at(QWEN, B, 512, 28, 4, 128))
    rows.append(decode_at(QWEN, B, 28, 4, 128, 528))
    rows.append(ssd_at(ZAMBA, B, 474, 112, 64, 64, 128))
    rows.extend(qmm_at(QMM_PREFILL, B * 474, QMM_K, QMM_N))
    rows.extend(qmm_at(QMM_DECODE, B, QMM_K, QMM_N))
    extra.append(flash_at(ZAMBA, B, 512, 32, 32, 112))
    extra.append(decode_at(ZAMBA, B, 32, 32, 112, 528))
    # the compound phase's other two archs: gemma-2b (MQA, hd 256) and
    # granite-3-2b (hd 64)
    rows.append(flash_at(GEMMA, B, 512, 8, 1, 256))
    rows.append(decode_at(GEMMA, B, 8, 1, 256, 528))
    rows.append(flash_at(GRANITE, B, 512, 32, 8, 64))
    rows.append(decode_at(GRANITE, B, 32, 8, 64, 528))
    # the MoE phase's llama4-scout (40 query / 8 KV heads, G 5, hd 128)
    rows.append(flash_at(SCOUT, B, 512, 40, 8, 128))
    rows.append(decode_at(SCOUT, B, 40, 8, 128, 528))
    extra.append(ssd_at(MAMBA, B, 474, 24, 64, 128, 128))
    emit("kernels_serving_shapes", card=card["nvidia_smi"], rows=rows,
         also=extra, ok=oks)
    if not all(oks.values()):
        raise AssertionError(f"serving-shape kernels out of tolerance: "
                             f"{[k for k, ok in oks.items() if not ok]}")
    return rows


# ---------------------------------------------------------------------------
def _model(torch, name: str, num_layers=None, dtype=None, seed: int = 0):
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    arch = get_arch(name)
    if num_layers is not None:
        arch = arch.scaled(num_layers=num_layers)
    model = Model(arch, device="cuda", dtype=dtype or torch.bfloat16)
    return model.init(torch.Generator(device="cuda").manual_seed(seed))


@contextlib.contextmanager
def _each_call_checked(torch, found: dict):
    """Within the block, every kernel launch is also held against its plain
    version on the same inputs (attention at its dtype's tolerance, the
    SSD's y and final state at 2e-3); ``found`` collects, per kernel, the
    calls, the largest |error| and the calls out of tolerance.  Each SSD
    call is also held against the recurrence in float64 on its inputs
    (SSD_F64_TOL): ``found["ssd_scan_vs_float64"]`` holds the calls, the
    kernel's and the plain version's largest relative error, and the
    kernel's calls over the limit."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as smod

    def record(kernel, pairs, tol):
        n, worst, bad = found.get(kernel, (0, 0.0, 0))
        errs = [_max_err(torch, out, want, tol) for out, want in pairs]
        found[kernel] = (n + 1, max([worst] + [e for e, _ in errs]),
                         bad + (not all(ok for _, ok in errs)))

    def tol(x):
        return TOLS[str(x.dtype).removeprefix("torch.")]

    flash, decode, ssd = (fmod.flash_attention, dmod.decode_attention,
                          smod.ssd_scan)

    def flash_checked(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        record("flash_attention",
               [(out, ref.flash_attention_ref(q, k, v, **kw))], tol(q))
        return out

    def decode_checked(q, kc, vc, cache_len, **kw):
        out = decode(q, kc, vc, cache_len, **kw)
        record("decode_attention",
               [(out, ref.decode_attention_ref(q, kc, vc, cache_len, **kw))],
               tol(q))
        return out

    def ssd_checked(x, dt, A, Bm, Cm, init_state=None):
        y, fin = ssd(x, dt, A, Bm, Cm, init_state=init_state)
        want = ref.ssd_scan_ref(x, dt, A, Bm, Cm, init_state=init_state)
        record("ssd_scan", list(zip((y, fin), want)), SSD_TOL)
        exact = ref.ssd_ref(*(t.double() for t in (x, dt, A, Bm, Cm)),
                            init_state=None if init_state is None
                            else init_state.double())
        kern, plain = max(_rel_errs((y, fin), exact)), max(_rel_errs(want,
                                                                     exact))
        n, wk, wp, bad = found.get("ssd_scan_vs_float64", (0, 0.0, 0.0, 0))
        found["ssd_scan_vs_float64"] = (n + 1, max(wk, kern), max(wp, plain),
                                        bad + (kern > SSD_F64_TOL))
        return y, fin

    fmod.flash_attention, dmod.decode_attention, smod.ssd_scan = (
        flash_checked, decode_checked, ssd_checked)
    try:
        yield
    finally:
        fmod.flash_attention, dmod.decode_attention, smod.ssd_scan = (
            flash, decode, ssd)


def _calls_in_tolerance(arch, found: dict, prefills: int, steps: int):
    """None if the checked calls are all in tolerance and as many as the
    path makes (per prefill one flash call per attention application and
    one SSD call per Mamba2 layer, per decode step one decode call per
    application), else what is wrong."""
    from repro_torch.models.kvcache import num_attn_applications
    n_attn = num_attn_applications(arch)
    expect = {k: n for k, n in (
        ("flash_attention", n_attn * prefills),
        ("decode_attention", n_attn * steps),
        ("ssd_scan", arch.num_layers * prefills if arch.ssm else 0)) if n}
    calls = {k: v[0] for k, v in found.items() if k in KERNELS}
    bad = {k: v[-1] for k, v in found.items() if v[-1]}
    if calls != expect or bad:
        return f"calls {calls} (expected {expect}), out of tolerance {bad}"
    return None


@contextlib.contextmanager
def _slice_width(P: int):
    """Within the block, the SSD wrapper gives every block a slice of P
    columns of hd, whatever its plan would pick."""
    from repro_torch.kernels import ssd_scan as smod
    plan = smod.slice_plan
    smod.slice_plan = lambda *args: P
    try:
        yield
    finally:
        smod.slice_plan = plan


@contextlib.contextmanager
def _plain_altered(attr: str, wrong, every_call: bool = False):
    """Within the block, the plain version ``ref.<attr>`` has its
    arguments changed by ``wrong(args, kwargs)`` on its first call, or on
    every call."""
    from repro_torch.kernels import ref
    plain, calls = getattr(ref, attr), [0]

    def altered(*args, **kw):
        calls[0] += 1
        if every_call or calls[0] == 1:
            args, kw = wrong(args, kw)
        return plain(*args, **kw)

    setattr(ref, attr, altered)
    try:
        yield
    finally:
        setattr(ref, attr, plain)


@contextlib.contextmanager
def _plain_in_float64(torch):
    """Within the block, the plain attention and SSD compute in float64
    (inputs cast up, results cast back): the yardstick of both fp32
    paths, since a stack of random Mamba2 layers amplifies rounding."""
    from repro_torch.kernels import ref
    saved = {n: getattr(ref, n) for n in (
        "flash_attention_ref", "decode_attention_ref", "ssd_scan_ref")}

    def up(t):
        return t.double() if torch.is_tensor(t) else t

    def in_float64(plain):
        def call(*args, **kw):
            out = plain(*map(up, args), **{k: up(v) for k, v in kw.items()})
            f = args[0].dtype
            return (tuple(o.to(f) for o in out) if isinstance(out, tuple)
                    else out.to(f))
        return call

    for name, plain in saved.items():
        setattr(ref, name, in_float64(plain))
    try:
        yield
    finally:
        for name, plain in saved.items():
            setattr(ref, name, plain)


def _forced_logits(torch, model, prompts, forced):
    """Next-token logits [B, n, V]: of the prompts (prefill), then of each
    of ``forced[:, :n-1]`` in turn (decode steps)."""
    S = prompts.shape[1]
    logits, cache = model.prefill(prompts, max_seq=SERVE_MAX_SEQ)
    out = [logits[:, -1]]
    for i in range(forced.shape[1] - 1):
        logits, cache = model.decode_step(cache, S + i, forced[:, i:i + 1])
        out.append(logits[:, -1])
    return torch.stack(out, 1)


def phase_model(torch, card, name: str, small_layers: int):
    """A full-width bf16 prefill, then a fp32 generation at a few layers,
    each through the kernels and through the plain versions.  Every kernel
    call is held against its plain version on the same inputs, and every
    SSD call against the recurrence in float64.  A stack of random Mamba2
    layers amplifies rounding, so the fp32 logits of the kernel path are
    held against the plain path in float64, at twice the plain fp32
    path's own distance from it; the bf16 prefill logits are held against
    the plain path only where a control reading with only the rounding
    changed (the SSD's chunk halved) stays below the limit (in bf16 the
    Mamba2 stack decorrelates them)."""
    import numpy as np

    model = _model(torch, name)
    arch = model.arch
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(
        rng.integers(0, arch.vocab_size, size=(SERVE_BATCH, 512)),
        device=model.device)
    per_call = {}
    with _each_call_checked(torch, per_call):
        got, _ = model.prefill(tokens)
    model.impl = "plain"
    want, _ = model.prefill(tokens)

    def rel_top1(out):
        return (float((out - want).abs().max() / want.abs().max()),
                float((out.argmax(-1) == want.argmax(-1)).float().mean()))

    rel, top1 = rel_top1(got)
    finite = bool(torch.isfinite(got).all())
    # Control readings on the plain path: one wrong call (the first
    # attention not causal; the first SSD with A halved) shows what a
    # broken kernel in one layer reads against the limit.
    controls = {}

    def control(attr, wrong, every_call=False):
        with _plain_altered(attr, wrong, every_call):
            bad, _ = model.prefill(tokens)
        return rel_top1(bad)

    if arch.num_heads:
        controls["first_attention_not_causal"] = control(
            "flash_attention_ref", lambda a, kw: (a, {**kw, "causal": False}))
    rounding = None
    if arch.ssm is not None:
        controls["first_ssd_A_halved"] = control(
            "ssd_scan_ref",
            lambda a, kw: (a[:2] + (a[2] * 0.5,) + a[3:], kw))
        label = "every_ssd_chunk_halved"
        controls[label] = control(
            "ssd_scan_ref",
            lambda a, kw: (a, {**kw, "chunk": arch.ssm.chunk_size // 2}),
            every_call=True)
        rounding = controls[label][0]
    model.impl = "kernel"
    logits_decide = rounding is None or rounding < LOGITS_TOL
    calls_wrong = _calls_in_tolerance(arch, per_call, prefills=1, steps=0)
    emit("model_prefill", card=card["nvidia_smi"], arch=arch.name,
         params=sum(p.numel() for p in model.parameters()),
         logits_shape=list(got.shape), rel_err=rel, top1_agreement=top1,
         finite=finite, controls_rel_err_top1=controls,
         logits_decide=logits_decide,
         per_call_calls_maxerr_bad={k: list(v) for k, v in per_call.items()})
    if (not finite or calls_wrong
            or (logits_decide and rel >= LOGITS_TOL)):
        raise AssertionError(f"{arch.name} prefill: rel err {rel}, finite "
                             f"{finite}, {calls_wrong}")
    _greedy_fp32(torch, card, name, small_layers, rng)
    return model


def _greedy_fp32(torch, card, name: str, small_layers: int, rng) -> None:
    """At full width but ``small_layers`` layers in fp32: greedy generation
    through the kernels and through the plain versions, then teacher-forced
    logits of both paths and of the plain path in float64; the kernel path
    within max(FP32_LOGITS_TOL, 2 x the plain path's distance) of float64,
    and every kernel call within tolerance of its plain version."""
    import numpy as np
    from repro_torch.serving.engine import Engine, EngineConfig

    small = _model(torch, name, num_layers=small_layers, dtype=torch.float32,
                   seed=2)
    arch = small.arch
    prompts = rng.integers(0, arch.vocab_size,
                           size=(SERVE_BATCH, 300)).astype(np.int32)
    outs = {}
    for impl in ("kernel", "plain"):
        small.impl = impl
        eng = Engine(small, EngineConfig(max_batch=SERVE_BATCH,
                                         max_seq=SERVE_MAX_SEQ))
        outs[impl] = eng.generate(prompts, max_new=SERVE_NEW)
    same = bool(np.array_equal(outs["kernel"], outs["plain"]))
    # Teacher-forced along the plain path's tokens, so that one flipped
    # pick does not send the paths down different continuations: the
    # kernel path, the plain path and the plain path in float64.  The
    # kernel path may be at most twice as far from the float64 path as the
    # plain path is (or 1e-3, whichever is larger).
    prompt_t = torch.as_tensor(prompts, device=small.device).long()
    forced = torch.as_tensor(outs["plain"], device=small.device).long()
    per_call, logits = {}, {}
    small.impl = "kernel"
    with _each_call_checked(torch, per_call):
        logits["kernel"] = _forced_logits(torch, small, prompt_t, forced)
    small.impl = "plain"
    logits["plain"] = _forced_logits(torch, small, prompt_t, forced)
    with _plain_in_float64(torch):
        logits["float64"] = _forced_logits(torch, small, prompt_t, forced)
    small.impl = "kernel"

    def rel_per_seq(a, b):
        return ((logits[a] - logits[b]).abs().amax(dim=(1, 2))
                / logits[b].abs().max()).tolist()

    per_seq = {"kernel_vs_plain": rel_per_seq("kernel", "plain"),
               "kernel_vs_float64": rel_per_seq("kernel", "float64"),
               "plain_vs_float64": rel_per_seq("plain", "float64")}
    rel = max(per_seq["kernel_vs_float64"])
    limit = max(FP32_LOGITS_TOL, 2 * max(per_seq["plain_vs_float64"]))
    diff = (logits["kernel"] - logits["plain"]).abs().amax(-1)     # [B, n]
    pick = {impl: lg.argmax(-1) for impl, lg in logits.items()}
    flips = []
    for b, t in (pick["kernel"] != pick["plain"]).nonzero().tolist():
        lg = logits["plain"][b, t]
        flips.append(dict(seq=b, step=t, margin=float(
            lg[pick["plain"][b, t]] - lg[pick["kernel"][b, t]]),
            logit_diff=float(diff[b, t])))
    calls_wrong = _calls_in_tolerance(small.arch, per_call, prefills=1,
                                      steps=forced.shape[1] - 1)
    differ = np.nonzero((outs["kernel"] != outs["plain"]).any(1))[0]
    emit("model_greedy_fp32", card=card["nvidia_smi"], arch=arch.name,
         layers=small_layers, identical_tokens=same,
         sequences_differing=differ.tolist(),
         forced_kernel_vs_float64=rel, forced_limit=limit,
         forced_rel_err_per_sequence=per_seq, forced_flips=flips,
         per_call_calls_maxerr_bad={k: list(v) for k, v in per_call.items()},
         tokens_kernel=outs["kernel"][differ[:1]].tolist(),
         tokens_plain=outs["plain"][differ[:1]].tolist())
    if calls_wrong or not rel <= limit:
        raise AssertionError(f"{arch.name}: fp32 teacher-forced logits, "
                             f"kernel path vs float64 {rel} > {limit}; "
                             f"{calls_wrong}")
    del small
    torch.cuda.empty_cache()


def _serve_prompts(seed: int, vocab: int) -> list:
    """The serve batch's prompts: SERVE_BATCH lengths drawn from
    PROMPT_LENS, then each prompt's tokens, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=SERVE_BATCH)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


def phase_serve(torch, card, model, seed: int) -> dict:
    import numpy as np
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.models.kvcache import num_attn_applications
    from repro_torch.serving.batcher import Batcher, ServeRequest
    from repro_torch.serving.engine import Engine, EngineConfig

    arch = model.arch
    V = arch.vocab_size
    prompts = _serve_prompts(seed, V)
    lens = np.array([len(p) for p in prompts])
    eng = Engine(model, EngineConfig(max_batch=SERVE_BATCH,
                                     max_seq=SERVE_MAX_SEQ))
    eng.generate(np.zeros((SERVE_BATCH, int(lens.max())), np.int32),
                 max_new=2)                          # warm-up, not counted
    torch.cuda.synchronize()
    clock = [0.0]
    batcher = Batcher(eng, timeout_ms=1e9, max_new=SERVE_NEW,
                      clock=lambda: clock[0])
    for i, p in enumerate(prompts):
        batcher.submit(ServeRequest(i, p, deadline_s=1e9, submitted_s=0.0))
    torch.cuda.reset_peak_memory_stats()
    mods = {"flash_attention": fmod, "decode_attention": dmod,
            "ssd_scan": smod, "quant_matmul": qmod}
    for mod in mods.values():
        mod.launches = 0
    done, walls = [], []
    while batcher.queue:
        t0 = time.monotonic()
        served = batcher.pump()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        if not served:
            raise AssertionError("the batcher launched nothing")
        done += served
    counts = {name: mod.launches for name, mod in mods.items()}
    n_batches = len(walls)
    n_attn = num_attn_applications(arch)
    n_ssm = arch.num_layers if arch.ssm is not None else 0
    expect = {"flash_attention": n_attn * n_batches,
              "decode_attention": n_attn * n_batches * (SERVE_NEW - 1),
              "ssd_scan": n_ssm * n_batches,
              "quant_matmul": 0}     # no model serves int8 (Variant.quant)
    results_ok = all(r.result is not None and r.result.shape == (SERVE_NEW,)
                     and int(r.result.min()) >= 0
                     and int(r.result.max()) < V for r in done)
    emit("serve", card=card["nvidia_smi"], arch=arch.name,
         requests=SERVE_BATCH, served=len(done), dropped=batcher.dropped,
         prompt_lens=lens.tolist(), batches=n_batches,
         wall_s_per_batch=walls,
         tokens_per_s=len(done) * SERVE_NEW / sum(walls),
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches=counts, expected_launches=expect)
    if len(done) != SERVE_BATCH or not results_ok:
        raise AssertionError(f"{arch.name}: served {len(done)} of "
                             f"{SERVE_BATCH} (results ok: {results_ok})")
    if counts != expect:
        raise AssertionError(f"{arch.name}: launch counts {counts} != "
                             f"{expect}")
    return counts, eng, int(lens.max())


@contextlib.contextmanager
def _annotated(torch, regions: dict):
    """Within the block, each function ``regions`` names (``(module,
    attribute)`` -> label) runs inside ``torch.profiler.record_function``
    of its label."""
    saved = {key: getattr(*key) for key in regions}

    def wrap(label, fn):
        def call(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return call

    for (mod, attr), label in regions.items():
        setattr(mod, attr, wrap(label, saved[mod, attr]))
    try:
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def phase_profile(torch, card, eng, S: int, regions=None) -> None:
    """Where a serve batch's time goes, at the serve phase's padded shape:
    the engine's prefill and each decode step (graphed on a dense model)
    on the host clock (synchronised),
    then the same prefill and steps again under torch.profiler, device
    time summed over kernels only (not over the ops that launch them).
    With ``regions`` (``(module, attribute)`` -> label) the profiled runs
    also annotate those functions, and each label's device time (its
    kernels and its callees') is printed."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = eng.model
    prompts = np.random.default_rng(3).integers(
        0, model.arch.vocab_size, size=(SERVE_BATCH, S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, device=model.device)

    def prefill():
        logits, cache = eng.prefill(tokens)
        return logits[:, -1].argmax(-1, keepdim=True), cache

    def decode(tok, cache, i):
        logits, cache = eng.decode_step(cache, S + i, tok)
        return logits[:, -1].argmax(-1, keepdim=True)

    torch.cuda.synchronize()
    t0 = time.monotonic()
    tok, cache = prefill()
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    steps = []
    for i in range(SERVE_NEW - 1):
        t0 = time.monotonic()
        tok = decode(tok, cache, i)
        torch.cuda.synchronize()
        steps.append(time.monotonic() - t0)

    labels = set((regions or {}).values())

    def kernels(prof):
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in labels]
        busy = sum(e.self_device_time_total for e in evs) / 1e3
        ranked = sorted(evs, key=lambda e: e.self_device_time_total,
                        reverse=True)
        # the port's own kernels whatever their rank (decode_attention is
        # two: the split and the merge kernel; ssd_scan two: C B^T and the
        # scan)
        ours = [e for e in ranked if any(f"{k}_kernel" in e.key for k in (
            "flash_attention_bf16", "flash_attention_fp32", "decode_split",
            "decode_merge", "ssd_cb", "ssd_scan", "quant_matmul_wgmma",
            "quant_matmul_small", "quant_matmul_mma", "dequant"))]
        return busy, [{"name": e.key[:90], "calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
                      for e in ranked[:8] + [e for e in ours
                                             if e not in ranked[:8]]]

    def by_region(prof):
        return {e.key: {"calls": e.count, "device_ms":
                        e.device_time_total / 1e3}
                for e in prof.key_averages()
                if e.key in labels and e.device_type == DeviceType.CPU}

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    def annotated():
        return (_annotated(torch, regions) if regions
                else contextlib.nullcontext())

    with annotated(), profile(activities=acts) as p_prefill:
        tok, cache = prefill()
        torch.cuda.synchronize()
    with annotated(), profile(activities=acts) as p_decode:
        for i in range(SERVE_NEW - 1):
            tok = decode(tok, cache, i)
        torch.cuda.synchronize()
    busy_p, top_p = kernels(p_prefill)
    busy_d, top_d = kernels(p_decode)
    decode_s = sum(steps)
    if regions:
        emit("profile_regions", card=card["nvidia_smi"],
             arch=model.arch.name, prefill=by_region(p_prefill),
             decode=by_region(p_decode))
    emit("profile", card=card["nvidia_smi"], arch=model.arch.name,
         padded_prompt_len=S,
         prefill_s=prefill_s, decode_step_s=steps, decode_total_s=decode_s,
         prefill_device_busy_ms=busy_p,
         prefill_idle_share=1.0 - busy_p / 1e3 / prefill_s,
         decode_device_busy_ms=busy_d,
         decode_idle_share=1.0 - busy_d / 1e3 / decode_s,
         prefill_kernels=top_p, decode_kernels=top_d)


# ---------------------------------------------------------------------------
# Full width, depth cut to fit one 80 GB card in bf16 (the whole models
# hold 215.5 and 795.4 GB): scout 8 of its 48 layers (39.37 GB of
# weights), maverick one group of moe_every = 2, a dense layer then an MoE
# layer over 128 experts (37.11 GB).
MOE_LAYERS = {SCOUT: 8, MAVERICK: 2}
MOE_FP32_LAYERS = 2
# A *flip* is a token whose experts differ between the kernel and the plain
# path in one layer; it is *primary* where every token up to it in its row
# agreed in every earlier layer, so that only rounding of its own layer's
# input can have moved it.  A flip needs the paths' difference in the two
# experts' probabilities to exceed the plain path's margin between them,
# so a perturbation of at most dp moves only tokens of margin <= 2 dp.  The
# phase prints dp over the tokens whose context agrees
# (``prob_diff_agreeing``); with only rounding changed (the control with
# the plain attention in float64) it reads 7.4e-3 at scout on an H100
# (PERF.md), so a primary flip is admissible only at a margin below
# ROUTE_MARGIN = 2e-2.  The wrong-kernel control (the first attention not
# causal) flips thousands of tokens at margins far above it.  The logits
# limit then holds every token whose row agrees up to it in every layer
# (with grouped dispatch a token's routes, ranks and logits depend on no
# later token); the tokens after a row's first difference are counted,
# and their error printed, not held.
ROUTE_MARGIN = 2e-2


def _max_or(t, empty):
    """max(t) as a float, or ``empty`` when t has no element."""
    return float(t.max()) if t.numel() else empty


@contextlib.contextmanager
def _routes_logged(log: list):
    """Within the block, every MoE layer appends its ``moe.Routes`` to
    ``log``."""
    from repro_torch.models import moe
    mlp = moe.moe_mlp
    moe.moe_mlp = lambda h, blk, arch, dispatch: mlp(h, blk, arch, dispatch,
                                                     log)
    try:
        yield
    finally:
        moe.moe_mlp = mlp


def _route_diff(torch, got: list, want: list, B: int) -> dict:
    """The routes of one prefill of B rows on two paths (``moe.Routes``,
    one per MoE layer; ``want`` the plain path) compared: the flips of
    each layer with the plain path's margin, which are primary (see
    ROUTE_MARGIN), the keeps that differ, the largest router-probability
    difference over tokens whose context agrees, and ``agree`` [B, S]:
    the tokens whose row agrees up to them in every layer."""
    K = want[0].idx.shape[-1]
    S = want[0].idx.numel() // (B * K)
    dev = want[0].idx.device
    pos = torch.arange(S, device=dev)
    first = torch.full((B,), S, device=dev)  # first differing position
    layers, prob_diff = [], 0.0
    for a, b in zip(got, want):
        ia, ib = a.idx.reshape(B, S, K), b.idx.reshape(B, S, K)
        ka, kb = a.keep.reshape(B, S, K), b.keep.reshape(B, S, K)
        pa, pb = a.probs.reshape(B, S, -1), b.probs.reshape(B, S, -1)
        top = pb.topk(K + 1, dim=-1).values
        margin = top[..., K - 1] - top[..., K]
        context = pos[None] < first[:, None]
        prob_diff = max(prob_diff, _max_or(
            (pa - pb).abs().amax(-1)[context], 0.0))
        flip = (ia != ib).any(-1)
        primary = flip & context
        layers.append({
            "flips": int(flip.sum()), "primary": int(primary.sum()),
            "primary_flips": [
                {"row": r, "token": t, "margin": float(margin[r, t])}
                for r, t in primary.nonzero().tolist()],
            "other_flip_margins": margin[flip & ~context].tolist(),
            "keeps_differ": int((ka != kb).any(-1).sum())})
        differ = flip | (ka != kb).any(-1)
        first = torch.minimum(first, torch.where(
            differ.any(1), differ.int().argmax(1), S))
    margins = [f["margin"] for lay in layers for f in lay["primary_flips"]]
    return {"layers": layers, "flips": sum(x["flips"] for x in layers),
            "primary_flips": len(margins),
            "primary_margin_max": max(margins, default=0.0),
            "prob_diff_agreeing": prob_diff,
            "agree": pos[None] < first[:, None]}


def _moe_prefill_check(torch, card, model) -> None:
    """An MoE model at full width in bf16: a prefill of SERVE_BATCH x 512
    through the kernels with every flash call held against its plain
    version; then the full-sequence logits and every MoE layer's routes on
    both paths, the flips counted with their margins (ROUTE_MARGIN) and
    the logits held at LOGITS_TOL over the tokens whose rows agree; the
    same readings for a rounding-only and a wrong-kernel control."""
    import numpy as np
    from repro_torch.configs import get_arch
    arch = model.arch
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, arch.vocab_size, size=(SERVE_BATCH, 512)), device=model.device)
    per_call = {}
    with _each_call_checked(torch, per_call):
        model.prefill(tokens)
    calls_wrong = _calls_in_tolerance(arch, per_call, prefills=1, steps=0)

    def forward(impl, log):
        model.impl = impl
        with _routes_logged(log):
            return model.forward(tokens)

    routes = {"kernel": [], "plain": []}
    got = forward("kernel", routes["kernel"])
    want = forward("plain", routes["plain"])
    scale = float(want.abs().max())

    def reading(logits, log):
        diff = _route_diff(torch, log, routes["plain"], SERVE_BATCH)
        agree = diff.pop("agree")
        err = (logits - want).abs().amax(-1) / scale          # [B, S]
        diff.update(
            agreeing_tokens=int(agree.sum()),
            rel_err_agreeing=_max_or(err[agree], None),
            rel_err_others=_max_or(err[~agree], None),
            top1_agreement=float((logits.argmax(-1) == want.argmax(-1))
                                 .float().mean()))
        diff["rule_holds"] = (diff["primary_margin_max"] < ROUTE_MARGIN
                              and diff["rel_err_agreeing"] is not None
                              and diff["rel_err_agreeing"] < LOGITS_TOL)
        return diff

    kernel = reading(got, routes["kernel"])
    finite = bool(torch.isfinite(got).all())
    del got
    controls = {}
    for label, attr, wrong in (
            ("attention_in_float64", None, None),
            ("first_attention_not_causal", "flash_attention_ref",
             lambda a, kw: (a, {**kw, "causal": False}))):
        log = []
        with (_plain_in_float64(torch) if attr is None
              else _plain_altered(attr, wrong)):
            logits = forward("plain", log)
        controls[label] = reading(logits, log)
        del logits
    model.impl = "kernel"
    emit("moe_prefill", card=card["nvidia_smi"], arch=arch.name,
         layers=arch.num_layers, cut=f"{arch.num_layers} of "
         f"{get_arch(arch.name).num_layers} layers",
         params=sum(p.numel() for p in model.parameters()),
         route_margin=ROUTE_MARGIN, logits_tol=LOGITS_TOL, finite=finite,
         kernel_vs_plain=kernel, controls=controls,
         per_call_calls_maxerr_bad={k: list(v) for k, v in per_call.items()})
    if calls_wrong or not finite or not kernel["rule_holds"]:
        raise AssertionError(
            f"{arch.name} prefill: primary flip margin "
            f"{kernel['primary_margin_max']} (limit {ROUTE_MARGIN}), rel "
            f"err over agreeing tokens {kernel['rel_err_agreeing']} (limit "
            f"{LOGITS_TOL}), finite {finite}, {calls_wrong}")


def _serve_drops(torch, model, log: list, seed: int, S: int) -> dict:
    """Each MoE layer's drops in the serve run's prefill (the entries of
    ``log`` before its SERVE_NEW - 1 decode steps): the share of all
    (token, k) rows, of the left pads' and of the prompts' own, and the
    share of a row's rows that its busiest expert drew (mean over rows),
    with the capacity per row; and the decode steps' drops."""
    from repro_torch.models.moe import capacity
    m = model.arch.moe
    n_moe = model.moe_group[0]
    steps = (SERVE_NEW - 1) * n_moe
    prefill, decode = log[-steps - n_moe:-steps], log[-steps:]
    lens = torch.tensor([len(p) for p in _serve_prompts(
        seed, model.arch.vocab_size)], device=model.device)
    pad = torch.arange(S, device=model.device)[None] < (S - lens)[:, None]
    pad = pad.repeat_interleave(m.experts_per_token, dim=1)
    layers = []
    for r in prefill:
        drop = ~r.keep.reshape(SERVE_BATCH, -1)
        load = torch.zeros(SERVE_BATCH, m.num_experts, device=model.device)
        load.scatter_add_(1, r.idx.reshape(SERVE_BATCH, -1),
                          torch.ones_like(load[:, :1]).expand(
                              -1, S * m.experts_per_token))
        layers.append({"share": float(drop.float().mean()),
                       "pads": float(drop[pad].float().mean()),
                       "prompts": float(drop[~pad].float().mean()),
                       "busiest_expert_share": float(
                           load.amax(1).mean() / (S * m.experts_per_token))})
    return {"capacity_per_row": capacity(model.arch, S),
                "pad_share": float(pad.float().mean()), "prefill_layers": layers,
            "decode_drops": sum(int((~r.keep).sum()) for r in decode)}


def phase_moe(torch, card, seed: int) -> dict:
    """The MoE family on the card: scout in fp32 at MOE_FP32_LAYERS layers
    (greedy and teacher-forced, as the model phase); scout at
    MOE_LAYERS[SCOUT] layers in bf16 (prefill check, served through
    Batcher -> Engine with launches exact and each MoE layer's drops,
    profiled with its MoE regions annotated); maverick at one group (the
    prefill check, served).  Returns each model's serve launches."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    import numpy as np

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    _greedy_fp32(torch, card, SCOUT, MOE_FP32_LAYERS,
                 np.random.default_rng(1))
    peaks = {f"{SCOUT} fp32 x {MOE_FP32_LAYERS}":
             torch.cuda.max_memory_allocated()}
    regions = {(moe, "_route"): "moe.route",
               (moe, "_dispatch_grouped"): "moe.dispatch",
               (moe, "_expert_ffn"): "moe.experts",
               (moe, "_shared_expert"): "moe.shared",
               (tfm, "attention_full"): "attention",
               (tfm, "attention_decode"): "attention"}
    launches = {}
    for name in (SCOUT, MAVERICK):
        torch.cuda.reset_peak_memory_stats()
        model = _model(torch, name, num_layers=MOE_LAYERS[name])
        _moe_prefill_check(torch, card, model)
        log = []
        with _routes_logged(log):
            launches[name], eng, S = phase_serve(torch, card, model, seed)
        emit("moe_serve_drops", card=card["nvidia_smi"], arch=name,
             padded_prompt_len=S, **_serve_drops(torch, model, log, seed, S))
        del log
        if name == SCOUT:
            phase_profile(torch, card, eng, S, regions)
        peaks[name] = torch.cuda.max_memory_allocated()
        del model, eng
        torch.cuda.empty_cache()
    emit("moe", card=card["nvidia_smi"], seconds=time.monotonic() - t0,
         max_memory_allocated_bytes=peaks, launches=launches)
    return launches


# ---------------------------------------------------------------------------
QMM_DENSE_TOL = 0.02         # int8 linear vs dense, tests/test_kernels.py:125
# Projections whose inputs are a normalised hidden state or the attention
# output (near-Gaussian rows); the MLP down-projection's input, the SwiGLU
# product, has heavy-tailed rows (max |x| ~13x their rms), which per-row
# int8 rounds ~2.7x as coarsely.  The JAX package's quant_linear reads above
# 0.02 on such rows as well (tests/test_torch_quant.py, SwiGLU-like rows of
# max/rms ~11, the two packages equal); this phase holds the down-projection
# to bitwise equality with the plain version and to the rounding model.
QMM_DENSE_HELD = ("wq", "wk", "wv", "wo", "wg", "wu")
QMM_MODEL_TOL = 0.1          # measured vs rounding model, relative


def _layer0_inputs(torch, model, run):
    """The activations that layer 0's projections receive while ``run()``
    drives the model, captured as they are handed to each matmul: a torch
    function mode sees every ``x @ w`` whose ``w`` is (a view of) one of
    the layer's weights.  Returns ({name: x}, {name: w as [K, N]})."""
    from torch.overrides import TorchFunctionMode
    blk = model.blocks[0]
    weights = {"wq": blk.wq.flatten(1), "wk": blk.wk.flatten(1),
               "wv": blk.wv.flatten(1), "wo": blk.wo.flatten(0, 1),
               "wg": blk.wg, "wu": blk.wu, "wd": blk.wd}
    by_ptr = {(w.data_ptr(), tuple(w.shape)): n for n, w in weights.items()}
    seen = {}

    class Capture(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if (getattr(func, "__name__", "") in ("matmul", "__matmul__")
                    and len(args) == 2 and torch.is_tensor(args[1])):
                name = by_ptr.get((args[1].data_ptr(), tuple(args[1].shape)))
                if name is not None and name not in seen:
                    seen[name] = args[0].detach().clone()
            return func(*args, **(kwargs or {}))

    with Capture():
        out = run()
    if set(seen) != set(weights):
        raise AssertionError(f"captured {sorted(seen)} of {sorted(weights)}")
    return seen, weights, out


def phase_int8(torch, card, model, seed: int) -> dict:
    """The int8 path on full-width qwen2-7b's layer 0: every projection's
    weight quantised per output channel and kept K-major (the kernel's
    native layout), run through ``ops.quant_linear`` on the inputs that
    layer really gets in one prefill of the serve batch and in the decode
    step after it.  Each call must equal the plain version, launch the
    kernel exactly once, come within QMM_MODEL_TOL of the error that
    uniform int8 rounding predicts for its inputs, and (the QMM_DENSE_HELD
    projections) within QMM_DENSE_TOL of the dense fp32 product; the same
    call on the row-major weight must give the same bits.  Returns the
    launches per shape and layout."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quant_matmul as qmod

    prompts = _serve_prompts(seed, model.arch.vocab_size)
    S = max(len(p) for p in prompts)
    padded = np.zeros((SERVE_BATCH, S), np.int64)     # left-padded with 0
    for i, p in enumerate(prompts):
        padded[i, S - len(p):] = p
    tokens = torch.as_tensor(padded, device=model.device)

    def prefill():
        return model.prefill(tokens, max_seq=SERVE_MAX_SEQ)

    x_pre, weights, (logits, cache) = _layer0_inputs(torch, model, prefill)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    x_dec, _, _ = _layer0_inputs(
        torch, model, lambda: model.decode_step(cache, S, tok))
    del cache, logits
    # Each weight is quantised once and kept K-major (the kernel's native
    # layout); the row-major copy runs too and must give the same bits.
    quantised = {}
    for name, w in weights.items():
        w_q, w_s = ops.quantize_int8(w, axis=0)
        quantised[name] = (w_q.t().contiguous().t(), w_q, w_s)
    results, launches, bad = {}, {}, []
    for tag, inputs in ((QMM_PREFILL, x_pre), (QMM_DECODE, x_dec)):
        launches[tag] = {"K-major": 0, "row-major": 0}
        for name, x in inputs.items():
            w = weights[name]
            w_km, w_q, w_s = quantised[name]
            n0 = qmod.launches
            out = ops.quant_linear(x, w_km, w_s)
            once = qmod.launches - n0 == 1
            launches[tag]["K-major"] += qmod.launches - n0
            n0 = qmod.launches
            same_row_major = bool(torch.equal(ops.quant_linear(x, w_q, w_s),
                                              out))
            launches[tag]["row-major"] += qmod.launches - n0
            x2 = x.reshape(-1, x.shape[-1])
            x_q, x_s = ref.quantize_int8(x2)
            plain = ref.quant_matmul_ref(x_q, w_q, x_s, w_s).reshape(
                out.shape).to(out.dtype)
            dense = x2.float() @ w.float()
            rel = float((out.reshape(dense.shape).float() - dense).norm()
                        / dense.norm())
            # uniform rounding: each x_q, w_q entry off by U(-s/2, s/2),
            # the bf16 output by U(-2^-9, 2^-9) relative; independent
            model_rel = float(torch.sqrt(
                ((x_s.double() ** 2).sum() * w.double().square().sum()
                 + (w_s.double() ** 2).sum() * x2.double().square().sum())
                / 12 / dense.double().square().sum()
                + (2.0 ** -18 / 3 if out.dtype == torch.bfloat16 else 0.0)))
            row_peak = float((x2.float().abs().amax(-1)
                              / x2.float().square().mean(-1).sqrt()
                              .clamp_min(1e-30)).mean())
            ok = {"equal_plain": bool(torch.equal(out, plain)),
                  "one_launch": once, "row_major_equal": same_row_major,
                  "vs_model": abs(rel / model_rel - 1.0) <= QMM_MODEL_TOL,
                  "dense": (rel < QMM_DENSE_TOL if name in QMM_DENSE_HELD
                            else None)}
            results[f"{tag} {name}"] = dict(
                M=x2.shape[0], K=x2.shape[1], N=w.shape[1],
                rel_err_vs_dense=rel, rounding_model_rel_err=model_rel,
                input_max_over_rms=row_peak, **ok)
            if not all(v for v in ok.values() if v is not None):
                bad.append(f"{tag} {name}: {ok}, rel {rel}, model "
                           f"{model_rel}")
    emit("int8", card=card["nvidia_smi"], arch=model.arch.name,
         padded_prompt_len=S, dense_tol=QMM_DENSE_TOL,
         dense_held=list(QMM_DENSE_HELD), model_tol=QMM_MODEL_TOL,
         launches=launches, calls=results)
    if bad:
        raise AssertionError(f"int8 path: {bad}")
    return launches


class _Ledger:
    """Runtime hooks: root arrivals, and per root the leaf outcomes
    (completions and fan-weighted drops) filed under its id."""

    def __init__(self):
        self.arrivals = 0
        self.outcomes = {}
        self.drops = {}
        self.dispatches = []

    def on_arrival(self, app, task, now, queue_len):
        self.arrivals += 1

    def on_drop(self, app, task, reason, n, now, root_id=-1):
        self.outcomes[root_id] = self.outcomes.get(root_id, 0) + n
        self.drops[f"{task}:{reason}"] = self.drops.get(
            f"{task}:{reason}", 0) + n

    def on_complete(self, app, root_id, latency_ms, missed, now):
        self.outcomes[root_id] = self.outcomes.get(root_id, 0) + 1

    def on_dispatch(self, server, batch, now, service_s, queue_len):
        self.dispatches.append((server.tup.key, len(batch), service_s))


class _PerArch:
    """An ExecutionBackend around another that files the kernel launches
    of each service call under the arch it served (a call is synchronous,
    so the counters' change during it is its own), and keeps the host
    seconds each call holds its caller (``walls``)."""

    def __init__(self, inner, mods):
        self.inner, self.mods = inner, mods
        self.graphs, self.calls, self.launches = {}, {}, {}
        self.walls = []

    def bind(self, graph, config, app=""):
        self.graphs[app] = graph
        self.inner.bind(graph, config, app)

    def on_capacity_change(self, servers):
        self.inner.on_capacity_change(servers)

    def service_s(self, server, batch, now_s, rng):
        graph = self.graphs[server.app]
        arch = graph.tasks[server.tup.task].variant(server.tup.variant).arch
        before = {k: m.launches for k, m in self.mods.items()}
        t0 = time.monotonic()
        service = self.inner.service_s(server, batch, now_s, rng)
        self.walls.append(time.monotonic() - t0)
        per = self.launches.setdefault(arch, dict.fromkeys(self.mods, 0))
        for k, m in self.mods.items():
            per[k] += m.launches - before[k]
        self.calls[arch] = self.calls.get(arch, 0) + 1
        return service


COMPOUND_APP = "social_media"
COMPOUND_BATCH, COMPOUND_RPS, COMPOUND_S = 8, 4.0, 10.0
COMPOUND_PROMPT, COMPOUND_MAX_SEQ = 256, 512
# Deadlines at 4x the app's 700 ms at least: a full-width hop of 16 new
# tokens took 0.3-1.1 s on the card with eager decode steps (0.12-0.25 s
# graphed), and at 1x the early-drop rule dropped every request at
# ingest.  Whatever of a service is bound by the host varies from machine
# to machine by 2x and more, so the deadline also leaves
# COMPOUND_PATH_SLACK times the longest path's service measured before
# planning; with less than about 2x every root may be dropped at ingest.  The scale is fixed once, from measured
# services only, before the plan is made.  Attainment within the app's
# own SLO is reported beside it.
COMPOUND_SLO_SCALE = 4.0
COMPOUND_PATH_SLACK = 3.0
# The plan phase: the batches the profiler may plan (capped at the
# engine's max batch, so no planned batch is served in two launches), and
# the planner's budgets: a node budget that binds and a wall-clock one the
# plans never reach.
PLAN_BATCHES = (1, 2, 4, 8)
PLAN_KW = dict(max_tuples_per_task=32, bb_nodes=8, bb_time_s=120.0)
PLAN_REPS = 3                 # timed prefills / decode runs / services
PLAN_WIDE_CARDS, PLAN_WIDE_RPS = 4, 40.0   # printed, not served
H2D_BYTES = 1 << 30
H100_SMS = 132


def _served_terms(arch, batch: int, prompt: int, new: int) -> dict:
    """The profiler's own prefill and decode-step terms (``request_flops``,
    ``request_bytes``) at the lengths the engine serves: ``batch`` prompts
    of ``prompt`` tokens and ``new`` generated tokens, weights and the KV
    cache read once a pass, bf16 (the engine ignores ``Variant.quant``)."""
    from repro_torch.core.profiler import request_bytes, request_flops
    fl_p, fl_d = request_flops(arch, "bf16", batch, prompt, new)
    wb, kv, _ = request_bytes(arch, "bf16", batch, prompt + new)
    return {"prefill_flop": fl_p, "step_flop": fl_d, "bytes": wb + kv}


def _fit_device(dev, terms: dict, measured: dict):
    """``dev`` with its efficiencies fitted to the measured walls: one-
    parameter least squares of the profiler's model over the archs,
    ``hbm_efficiency`` from the mean decode steps through the byte term
    (t_dec = bytes / (hbm_bw * e)) and ``flops_efficiency`` from the
    prefills through the operation term (t_pre = flop / (peak * e)), the
    terms that bind at the served batch.  Minimising sum (a_i x - t_i)^2
    over x = 1/e gives x = sum a_i t_i / sum a_i^2."""
    import dataclasses

    def fit(a, t):
        return sum(x * x for x in a) / sum(x * y for x, y in zip(a, t))

    archs = sorted(terms)
    mem = [terms[a]["bytes"] / dev.hbm_bw for a in archs]
    ops = [terms[a]["prefill_flop"] / dev.peak("bf16") for a in archs]
    return dataclasses.replace(
        dev, hbm_efficiency=fit(mem, [measured[a]["step_s"] for a in archs]),
        flops_efficiency=fit(ops, [measured[a]["prefill_s"]
                                   for a in archs]))


def _profiled_vs_measured(graph, dev, measured: dict) -> dict:
    """Per arch, the profiler's own service (``Profiler.profile_one``, P95
    factor divided out) of the arch's first variant at the served lengths
    (prompt 256, 16 new tokens), batch 8, on one whole H100 of spec
    ``dev``, beside the measured service."""
    import dataclasses
    from repro_torch.core.profiler import P95_FACTOR, Profiler
    from repro_torch.hwspec import ClusterSpec, h100_cluster

    (pool,) = h100_cluster(1).pools
    pool = dataclasses.replace(pool, device=dev)
    whole = next(sl for sl in pool.scheme.slices() if sl.name == "7g.80gb.s1")
    prof = Profiler(graph, cluster=ClusterSpec(pools=(pool,)), batches=())
    out = {}
    for a in sorted(measured):
        v = next(v for t in graph.tasks.values() for v in t.variants
                 if v.arch == a)
        v = dataclasses.replace(v, seq_len=COMPOUND_PROMPT,
                                gen_len=SERVE_NEW)
        e = prof.profile_one(v, whole, COMPOUND_BATCH, pool=pool)
        service = e.latency_ms / 1e3 / P95_FACTOR
        out[a] = {"service_s": service,
                  "measured_service_s": measured[a]["service_s"],
                  "service_profiled_over_measured":
                      service / measured[a]["service_s"]}
    return out


def _slo_scale(graph, services: dict) -> tuple:
    """The deadline scale, from measured services only: each task on a
    path takes its slowest arch's measured full-batch service, and the
    deadline is max(COMPOUND_SLO_SCALE x SLO, COMPOUND_PATH_SLACK x the
    longest such path)."""
    slowest = {t: max(services[v.arch] for v in task.variants)
               for t, task in graph.tasks.items()}
    longest = max(sum(slowest[t] for t in path) for path in graph.paths)
    return max(COMPOUND_SLO_SCALE, COMPOUND_PATH_SLACK * longest
               / (graph.slo_latency_ms / 1e3)), longest


def _scaled_on(graph, dev, devices: int, slo_scale: float):
    """The app's graph with its latency SLO scaled by ``slo_scale``, the
    cluster of ``devices`` H100s of device spec ``dev`` (``h100_cluster``)
    and the profiler of the one on the other (``PLAN_BATCHES``)."""
    import dataclasses
    from repro_torch.core.profiler import Profiler
    from repro_torch.hwspec import ClusterSpec, h100_cluster

    (pool,) = h100_cluster(devices).pools
    cluster = ClusterSpec(pools=(dataclasses.replace(pool, device=dev),))
    g = dataclasses.replace(graph,
                            slo_latency_ms=graph.slo_latency_ms * slo_scale)
    return g, cluster, Profiler(g, cluster=cluster, batches=PLAN_BATCHES)


def _plan_on(graph, dev, devices: int, rps: float, slo_scale: float):
    """The port's planner on ``devices`` H100s of device spec ``dev``
    (``h100_cluster``), the app's latency SLO scaled by ``slo_scale``, and
    the plan packed by the pool's MIG packer.  Returns the planner, the
    plan (None if there is none), the placements (None if the plan does
    not pack), the packer and the planner's host seconds."""
    from repro_torch.core.milp import Planner
    from repro_torch.core.placement import make_placer

    g, cluster, prof = _scaled_on(graph, dev, devices, slo_scale)
    (pool,) = cluster.pools
    planner = Planner(g, prof, s_avail=cluster.total_units, **PLAN_KW)
    t0 = time.monotonic()
    cfg = planner.plan(rps)
    plan_s = time.monotonic() - t0
    packer = make_placer(pool)
    placed = None
    if cfg is not None:
        placed = packer.pack([t.segment for t, m in cfg.instances()
                              for _ in range(m)])
    return planner, cfg, placed, packer, plan_s


def _plan_summary(graph, planner, cfg, placed, packer, plan_s) -> dict:
    """What a plan says: its instances, slices, g-units packed, objective
    (paper Eq. 14 as the planner prices it: beta x sum price x cost x m -
    alpha x A_obj) and the planner's counters."""
    import dataclasses
    out = {"planner_host_s": plan_s,
           "stats": dataclasses.asdict(planner.stats)}
    if cfg is None:
        return {**out, "plan": None}
    prices = planner.cluster.prices()
    price = sum(prices[t.pool] * t.cost * m for t, m in cfg.instances())
    return {**out, "plan": [
        {"task": t.task, "variant": t.variant,
         "arch": graph.tasks[t.task].variant(t.variant).arch,
         "quant": graph.tasks[t.task].variant(t.variant).quant,
         "slice": t.segment, "batch": t.batch, "count": m,
         "streams": t.streams, "latency_ms": t.latency_ms,
         "throughput_rps": t.throughput} for t, m in cfg.instances()],
        "slices": cfg.slices, "pool_slices": cfg.pool_slices(),
        "a_obj": cfg.exact_a_obj(),
        "objective": planner.beta * price - planner.alpha * cfg.exact_a_obj(),
        "worst_path_ms": cfg.worst_path_latency(),
        "packed": placed is not None,
        "g_used": packer.g_total_used if placed is not None else None,
        "cards_used": (len({p.pod for p in placed}) if placed is not None
                       else None),
        "placements": ([[p.segment, p.pod, p.row] for p in placed]
                       if placed is not None else None)}


def _archs(graph) -> list:
    """The archs the app's variants run (gemma-2b, granite-3-2b and
    qwen2-7b for social_media)."""
    return sorted({v.arch for t in graph.tasks.values() for v in t.variants})


def _probe(graph, arch_name: str):
    """A server for ``EngineBackend.service_s`` outside the runtime: the
    first variant of the app that runs ``arch_name``, on the whole card."""
    from types import SimpleNamespace
    from repro_torch.core.milp import TupleVar
    task, var = next((t, v) for t, task in graph.tasks.items()
                     for v in task.variants if v.arch == arch_name)
    return SimpleNamespace(app="", tup=TupleVar(
        task, var.name, "7g.80gb.s1", COMPOUND_BATCH, latency_ms=0.0,
        throughput=0.0, cost=7, accuracy=var.accuracy))


def _measure_arch(torch, eng, rng, reps: int) -> dict:
    """A full batch's prefill and decode steps through the engine (its
    graphed steps on the card), on the host clock (synchronised), ``reps``
    times, at the compound phase's shapes."""
    model = eng.model
    steps, prefills = [], []
    for _ in range(reps):
        prompts = rng.integers(0, model.arch.vocab_size,
                               size=(COMPOUND_BATCH, COMPOUND_PROMPT))
        tokens = torch.as_tensor(prompts, device=model.device)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, cache = eng.prefill(tokens)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        prefills.append(time.monotonic() - t0)
        for i in range(SERVE_NEW - 1):
            t0 = time.monotonic()
            logits, cache = eng.decode_step(cache, COMPOUND_PROMPT + i, tok)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            steps.append(time.monotonic() - t0)
        del cache, logits
    return {"prefill_s": sorted(prefills)[len(prefills) // 2],
            "step_s": sum(steps) / len(steps),
            "prefill_walls_s": prefills}


def _phase_spec(torch, card, dev) -> dict:
    """The H100_SXM preset against the card: SM count and memory (fails
    below 132 SMs or below the preset's usable HBM), and a pinned
    host-to-device copy of 1 GiB beside the preset's staging bandwidth."""
    props = torch.cuda.get_device_properties(0)
    host = torch.empty(H2D_BYTES, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(H2D_BYTES, dtype=torch.uint8, device="cuda")
    dst.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, stop = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        start.record()
        dst.copy_(host, non_blocking=True)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / 1e3)
    del host, dst
    h2d = H2D_BYTES / min(times)
    spec = {"sm_count": props.multi_processor_count,
            "sm_count_expected": H100_SMS,
            "total_memory_bytes": props.total_memory,
            "preset_hbm_bytes": dev.hbm_bytes,
            "preset_usable_hbm_bytes": dev.usable_hbm_bytes,
            "preset_hbm_bw": dev.hbm_bw,
            "preset_peak_flops": dict(dev.peak_flops),
            "pinned_h2d_bytes": H2D_BYTES, "pinned_h2d_s": times,
            "pinned_h2d_bytes_per_s": h2d,
            "preset_staging_bw": dev.staging_bw,
            "h2d_over_preset_staging": h2d / dev.staging_bw}
    if props.multi_processor_count != H100_SMS:
        raise AssertionError(f"plan: {props.multi_processor_count} SMs, "
                             f"the H100_SXM preset has {H100_SMS}")
    if props.total_memory < dev.usable_hbm_bytes:
        raise AssertionError(f"plan: {props.total_memory} B on the card < "
                             f"the preset's usable {dev.usable_hbm_bytes}")
    return spec


def phase_plan(torch, card, seed: int) -> dict:
    """The planning chain on the card: the H100_SXM preset checked against
    it; its flops and HBM efficiencies fitted to full-batch prefills and
    decode steps of the compound engines (EngineBackend at full width in
    bf16, batch 8, prompt 256) of gemma-2b, granite-3-2b and qwen2-7b,
    with the profiler's services before and after the fit beside the
    measured ones; the deadline scale fixed from the measured services;
    then the port's Planner on one MIG-carved H100 (h100_cluster with the
    fitted spec) at the compound rate, which must give a plan that its
    MigSlicePacker packs, and the plan for four cards at ten times the
    rate, printed only.  The timed runs are this phase's path: the
    kernels' counts are set to 0 before them and checked after.  Returns
    what the compound and control phases serve: the backend with its
    engines, the plan, the scale, the measured services, the fitted spec
    and the measured pinned H2D rate."""
    import numpy as np
    from repro_torch.core.apps import get_app
    from repro_torch.hwspec import H100_SXM
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.runtime import EngineBackend

    t_phase = time.monotonic()
    spec = _phase_spec(torch, card, H100_SXM)
    graph = get_app(COMPOUND_APP)
    archs = _archs(graph)
    backend = EngineBackend(reduced=False, max_batch=COMPOUND_BATCH,
                            max_seq=COMPOUND_MAX_SEQ,
                            prompt_len=COMPOUND_PROMPT, max_new=SERVE_NEW)
    backend.bind(graph, None)
    rng = np.random.default_rng(seed)
    measured, terms, launches, expect = {}, {}, {}, {}
    for arch_name in archs:
        eng = backend._engine_for(arch_name)           # builds and warms
        probe = _probe(graph, arch_name)
        full = [None] * COMPOUND_BATCH
        backend.service_s(probe, full, 0.0, rng)       # first full batch
        fmod.launches = dmod.launches = 0
        measured[arch_name] = _measure_arch(torch, eng, rng, PLAN_REPS)
        services = [backend.service_s(probe, full, 0.0, rng)
                    for _ in range(PLAN_REPS)]
        launches[arch_name] = {"flash_attention": fmod.launches,
                               "decode_attention": dmod.launches}
        layers = eng.model.arch.num_layers
        expect[arch_name] = {
            "flash_attention": layers * 2 * PLAN_REPS,
            "decode_attention": layers * 2 * PLAN_REPS * (SERVE_NEW - 1)}
        measured[arch_name]["service_s"] = sorted(services)[PLAN_REPS // 2]
        measured[arch_name]["service_walls_s"] = services
        terms[arch_name] = _served_terms(eng.model.arch, COMPOUND_BATCH,
                                         COMPOUND_PROMPT, SERVE_NEW)
    fitted = _fit_device(H100_SXM, terms, measured)
    service = {a: m["service_s"] for a, m in measured.items()}
    slo_scale, longest = _slo_scale(graph, service)
    print(f"plan: deadline scale {slo_scale:.4f} (longest path "
          f"{longest:.4f} s of measured services)", flush=True)
    planner, cfg, placed, packer, plan_s = _plan_on(
        graph, fitted, 1, COMPOUND_RPS, slo_scale)
    wide = _plan_on(graph, fitted, PLAN_WIDE_CARDS, PLAN_WIDE_RPS, slo_scale)
    emit("plan", card=card["nvidia_smi"], spec=spec, app=COMPOUND_APP,
         batch=COMPOUND_BATCH, prompt_len=COMPOUND_PROMPT,
         new_tokens=SERVE_NEW, terms=terms, measured=measured,
         fitted={"flops_efficiency": fitted.flops_efficiency,
                 "hbm_efficiency": fitted.hbm_efficiency},
         preset={"flops_efficiency": H100_SXM.flops_efficiency,
                 "hbm_efficiency": H100_SXM.hbm_efficiency},
         profiled_before_fit=_profiled_vs_measured(graph, H100_SXM, measured),
         profiled_after_fit=_profiled_vs_measured(graph, fitted, measured),
         longest_path_service_s=longest, slo_scale=slo_scale,
         rate_rps=COMPOUND_RPS, batches=PLAN_BATCHES, planner_kw=PLAN_KW,
         served={"cards": 1, "rate_rps": COMPOUND_RPS,
                 **_plan_summary(graph, planner, cfg, placed, packer,
                                 plan_s)},
         wide={"cards": PLAN_WIDE_CARDS, "rate_rps": PLAN_WIDE_RPS,
               **_plan_summary(graph, *wide)},
         launches=launches, expected_launches=expect,
         phase_host_wall_s=time.monotonic() - t_phase)
    if launches != expect:
        raise AssertionError(f"plan: launches {launches} != {expect}")
    if cfg is None:
        raise AssertionError(f"plan: no plan for {COMPOUND_APP} at "
                             f"{COMPOUND_RPS} rps on one H100")
    if placed is None:
        raise AssertionError("plan: the plan does not pack on one H100")
    return {"backend": backend, "graph": graph, "cfg": cfg,
            "slo_scale": slo_scale, "longest_path_s": longest,
            "services": service, "fitted": fitted,
            "h2d_bytes_per_s": spec["pinned_h2d_bytes_per_s"]}


def phase_compound(torch, card, seed: int, planned: dict) -> dict:
    """The main path through the port's own control plane: the
    social_media app served by ``repro_torch.runtime.ClusterRuntime`` on
    ``EngineBackend(reduced=False)`` (full-width gemma-2b, granite-3-2b
    and qwen2-7b in bf16) on the plan the plan phase made, under Poisson
    traffic with deadlines at the scale that phase fixed.  Every planned
    instance is served on the whole card (MIG is not reconfigured) and
    a planned int8 variant runs in bf16 (the engine ignores
    ``Variant.quant``, as the reference's does).  Before the run, one
    full-batch service per arch has every kernel call held against its
    plain version on the same inputs (``_each_call_checked``), at the
    shapes this path gives the kernels.  Every root arrival must end as
    completed or dropped at each of its leaves, the queues must drain,
    and each arch's launches must be one flash launch per layer per
    service call and one decode launch per layer per decode step.  Prints
    each served tuple's planned latency beside its measured services.
    Returns the launches per arch and kernel."""
    import dataclasses
    import numpy as np
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.runtime import ClusterRuntime, Scenario

    t_phase = time.monotonic()
    backend, graph = planned["backend"], planned["graph"]
    cfg = dataclasses.replace(planned["cfg"], graph=graph)
    slo_scale = planned["slo_scale"]
    leaves = len(graph.paths)
    if any(f != 1.0 for f in graph.mult.values()):
        raise AssertionError("the per-root accounting assumes fan-out 1")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed)
    checked, bad = {}, {}
    for arch_name in _archs(graph):
        found = {}
        with _each_call_checked(torch, found):
            backend.service_s(_probe(graph, arch_name),
                              [None] * COMPOUND_BATCH, 0.0, rng)
        checked[arch_name] = {k: {"calls": n, "max_abs_err": worst,
                                  "out_of_tol": out}
                              for k, (n, worst, out) in found.items()}
        wrong = _calls_in_tolerance(backend._engines[arch_name].model.arch,
                                    found, 1, SERVE_NEW - 1)
        if wrong:
            bad[arch_name] = wrong
    mods = {"flash_attention": fmod, "decode_attention": dmod,
            "ssd_scan": smod, "quant_matmul": qmod}
    counted = _PerArch(backend, mods)
    ledger = _Ledger()
    rt = ClusterRuntime(graph, cfg, counted, seed=seed, hooks=ledger)
    for mod in mods.values():
        mod.launches = 0
    t0 = time.monotonic()
    m = rt.run(Scenario.poisson(COMPOUND_RPS, duration_s=COMPOUND_S,
                                warmup_s=0.0, slo_scale=slo_scale))
    run_wall = time.monotonic() - t0
    totals = {k: mod.launches for k, mod in mods.items()}
    expect = {}
    for arch_name, calls in counted.calls.items():
        layers = backend._engines[arch_name].model.arch.num_layers
        expect[arch_name] = {"flash_attention": layers * calls,
                             "decode_attention":
                                 layers * calls * (SERVE_NEW - 1),
                             "ssd_scan": 0, "quant_matmul": 0}
    left = sum(len(q) for q in rt.queues.values())
    accounted = (ledger.arrivals > 0
                 and len(ledger.outcomes) == ledger.arrivals
                 and -1 not in ledger.outcomes
                 and all(n == leaves for n in ledger.outcomes.values())
                 and m.completions + m.dropped == leaves * ledger.arrivals
                 and left == 0)
    sums_ok = all(totals[k] == sum(c[k] for c in counted.launches.values())
                  for k in mods)
    lat = np.asarray(m.latencies_ms) if m.latencies_ms else np.zeros(1)
    batches, served = {}, []
    for key, n, _ in ledger.dispatches:
        batches.setdefault(key[0], []).append(n)
    for tup, count in cfg.instances():
        walls = [s for key, _, s in ledger.dispatches if key == tup.key]
        v = graph.tasks[tup.task].variant(tup.variant)
        served.append({
            "task": tup.task, "variant": tup.variant, "quant": v.quant,
            "served_as": "bf16", "slice": tup.segment,
            "served_on": "whole card", "batch": tup.batch, "count": count,
            "planned_latency_ms": tup.latency_ms,
            "measured_service_ms": [s * 1e3 for s in walls],
            "planned_over_mean_measured": (
                tup.latency_ms / (1e3 * sum(walls) / len(walls))
                if walls else None)})
    emit("compound", card=card["nvidia_smi"], app=COMPOUND_APP,
         plan_from="plan phase (repro_torch Planner, h100_cluster(1))",
         served=served,
         note="every planned instance is served on the whole card (no MIG "
              "reconfiguration); int8 variants run in bf16 (EngineBackend "
              "ignores Variant.quant, as the reference's does)",
         batch=COMPOUND_BATCH, rate_rps=COMPOUND_RPS,
         scenario_s=COMPOUND_S, seed=seed,
         measured_service_s_batch8=planned["services"],
         checked_vs_plain=checked, checked_out_of_tol=bad,
         root_arrivals=ledger.arrivals, leaves_per_root=leaves,
         completions=m.completions, missed=m.missed, dropped=m.dropped,
         drops=ledger.drops, queued_at_end=left, accounted=accounted,
         longest_path_service_s=planned["longest_path_s"],
         slo_scale=slo_scale,
         slo_attainment=1.0 - m.violation_rate,
         within_app_slo=sum(x <= graph.slo_latency_ms
                            for x in m.latencies_ms)
         / max(m.total_requests, 1),
         e2e_p50_ms=float(np.percentile(lat, 50)),
         e2e_p99_ms=float(np.percentile(lat, 99)),
         service_calls=counted.calls, batch_sizes=batches,
         launches=counted.launches, expected_launches=expect,
         run_host_wall_s=run_wall,
         phase_host_wall_s=time.monotonic() - t_phase,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if bad:
        raise AssertionError(f"compound: kernel calls vs plain: {bad}")
    if not accounted or m.completions <= 0:
        raise AssertionError(
            f"compound: {ledger.arrivals} arrivals, {len(ledger.outcomes)} "
            f"roots with outcomes, {m.completions} completions + "
            f"{m.dropped} dropped, {left} left in queues")
    if counted.launches != expect or not sums_ok:
        raise AssertionError(f"compound: launches {counted.launches} != "
                             f"{expect} (totals {totals})")
    return counted.launches


class _Tee:
    """The control phase's hooks: every call goes to ``inner`` (the
    phase's ``Instrumentation``, whose other attributes it stands in for);
    root arrivals, leaf outcomes and dispatches also go to the current
    bin's ``_Ledger``, and each dispatch's start to ``starts``."""

    def __init__(self, inner):
        self.inner, self.ledger, self.starts = inner, None, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def on_arrival(self, app, task, now, queue_len):
        self.inner.on_arrival(app, task, now, queue_len)
        self.ledger.on_arrival(app, task, now, queue_len)

    def on_drop(self, app, task, reason, n, now, root_id=-1):
        self.inner.on_drop(app, task, reason, n, now, root_id=root_id)
        self.ledger.on_drop(app, task, reason, n, now, root_id=root_id)

    def on_complete(self, app, root_id, latency_ms, missed, now):
        self.inner.on_complete(app, root_id, latency_ms, missed, now)
        self.ledger.on_complete(app, root_id, latency_ms, missed, now)

    def on_dispatch(self, server, batch, now, service_s, queue_len):
        self.inner.on_dispatch(server, batch, now, service_s, queue_len)
        self.ledger.on_dispatch(server, batch, now, service_s, queue_len)
        self.starts.append((server.tup.key, now))


# The control phase: the port's Controller steps social_media through
# CONTROL_BINS bins of a diurnal trace (seed 2: rising from 0.33 of its
# peak to the peak in bin 6, so the predicted demand drifts past the
# controller's 10 % re-plan threshold from bin to bin), CONTROL_BIN_S
# simulated seconds a bin.  The peak is the compound rate unless one card's
# plan is the same from the trace's low end to there: then it is raised
# until the controller's predicted demand passes, by CONTROL_OVERSHOOT, the
# first rate of CONTROL_SWEEP_RPS at which the plan changes (at PR 16's fit
# the one-card plan is one 1g instance per task from 0.02 to 20 rps).  In
# bin CONTROL_LOSS_BIN the provider reclaims CONTROL_LOSS_UNITS g-units of
# the card's 7 (a PreemptionEvent); one card still plans on the 6 that
# remain.  The emergency monitor judges 1 s windows of at least 6 leaf
# outcomes (its default 0.5 s and 10 never fill at the low rates).
CONTROL_TRACE_SEED, CONTROL_BINS, CONTROL_BIN_S = 2, 8, 4.0
CONTROL_SWEEP_RPS = tuple(round(COMPOUND_RPS * 1.25 ** k, 6)
                          for k in range(-8, 14))     # 0.67 .. 73 rps
CONTROL_OVERSHOOT = 1.1
CONTROL_LOSS_BIN, CONTROL_LOSS_AT_S, CONTROL_LOSS_NOTICE_S = 4, 1.5, 0.5
CONTROL_LOSS_UNITS = 1
CONTROL_MONITOR = dict(interval_s=1.0, min_requests=6)
CONTROL_STICKINESS = 0.05     # the emergency planner's, as the chaos tests'


def _transition_rows(graph, pool, tr, h2d: float) -> dict:
    """A staged transition's actions and makespan, and beside each load
    its weight bytes over the preset's staging bandwidth (the planner's
    warm-up) and over the pinned H2D rate the plan phase measured, each
    on the slice's share of the path (``memory_fraction``)."""
    from repro_torch.configs import ARCHS
    dev = pool.device
    actions, load_s = [], {"preset": [], "measured": []}
    for a in tr.keeps + tr.drains + tr.loads:
        row = {"kind": a.kind, "task": a.tup.task, "variant": a.tup.variant,
               "slice": a.tup.segment, "batch": a.tup.batch,
               "count": a.count, "ready_s": a.ready_s,
               "retire_s": a.retire_s, "carved": a.carved}
        if a.kind == "load":
            sl = next(s for s in pool.scheme.slices()
                      if s.name == a.tup.segment)
            v = graph.tasks[a.tup.task].variant(a.tup.variant)
            nbytes = (ARCHS[v.arch].param_count()[0]
                      * dev.param_bytes(v.quant) / max(sl.devices, 1))
            row.update(weight_bytes=nbytes,
                       load_s_at_preset_staging=dev.weight_load_s(
                           nbytes, sl.memory_fraction),
                       load_s_at_measured_h2d=nbytes / (
                           h2d * sl.memory_fraction))
            load_s["preset"].append(row["load_s_at_preset_staging"])
            load_s["measured"].append(row["load_s_at_measured_h2d"])
        actions.append(row)
    return {"actions": actions, "makespan_s": tr.makespan_s,
            "n_actions": tr.n_actions,
            "repartition_pools": sorted(tr.repartition_pools),
            "blocked_pools": sorted(tr.blocked_pools),
            "longest_load_s_at_preset_staging": max(load_s["preset"],
                                                    default=0.0),
            "longest_load_s_at_measured_h2d": max(load_s["measured"],
                                                  default=0.0),
            "preset_staging_bw": dev.staging_bw,
            "measured_h2d_bytes_per_s": h2d}


def _control_peak(graph, cluster, prof) -> dict:
    """The control trace's peak: ``COMPOUND_RPS`` if the port's planner on
    ``cluster`` deploys other instances at some rate of CONTROL_SWEEP_RPS
    above the trace's low end but below the controller's highest predicted
    demand; else the peak at which that prediction passes the first such
    rate by CONTROL_OVERSHOOT.  A fresh planner plans each rate."""
    from repro_torch.core.milp import Planner
    from repro_torch.core.trace import diurnal_trace, predict_demand

    unit = diurnal_trace(seed=CONTROL_TRACE_SEED, bins=CONTROL_BINS).rps
    pred = max(predict_demand(list(unit[:i + 1])) for i in range(len(unit)))

    def deployed(rps):
        cfg = Planner(graph, prof, s_avail=cluster.total_units,
                      **PLAN_KW).plan(rps)
        return None if cfg is None else sorted(
            (t.key, m) for t, m in cfg.instances())

    low = float(unit.min()) * COMPOUND_RPS / float(unit.max())
    base, change = deployed(low), None
    for rps in CONTROL_SWEEP_RPS:
        plan = deployed(rps) if rps > low else None
        if plan is not None and plan != base:
            change = rps
            break
    if change is None:
        raise AssertionError(f"control: one card's plan is the same from "
                             f"{low} to {CONTROL_SWEEP_RPS[-1]} rps")
    peak = max(COMPOUND_RPS, CONTROL_OVERSHOOT * change * float(unit.max())
               / pred)
    return {"peak_rps": peak, "first_change_rps": change, "low_rps": low,
            "max_predicted_over_peak": pred / float(unit.max())}


def _counts(parsed: dict, family: str, label: str = "") -> dict:
    """One exposition family's samples summed by the value of ``label``
    (one total under "" when ``label`` is empty)."""
    out = {}
    for labels, v in parsed.get(family, {}).items():
        k = dict(labels).get(label, "") if label else ""
        out[k] = out.get(k, 0.0) + v
    return out


def phase_control(torch, card, seed: int, planned: dict) -> dict:
    """The adaptive control loop on the card: the port's ``Controller``
    drives social_media bin by bin on the plan phase's
    ``EngineBackend(reduced=False)`` (full-width gemma-2b, granite-3-2b and
    qwen2-7b in bf16, engines built and decode steps graphed once), its
    planner on the fitted ``H100_SXM`` of ``h100_cluster(1)`` with the
    plan phase's deadline scale.  Each bin predicts demand, re-plans when
    it drifts or the last bin's violations spike, executes the plan change
    as a staged transition (``TransitionPlanner``: old instances drain,
    new ones serve from their modelled warm-up), and serves Poisson
    traffic at the bin's demand; a ``FailureDetector`` carries one bin's
    capacity loss into the next bin's planner, an ``EmergencyReplanner``
    and a ``DegradationLadder`` ride on every bin's runtime, and an
    ``Instrumentation`` (tracer, SLO plane, audit log) sees every hook.

    It fails unless, in every bin, each root ends completed or dropped at
    each of its leaves and the queues drain; at least two bins re-plan and
    one executes a staged transition with loads whose new instances serve
    inside the bin, each bin's runtime running exactly the transition its
    report charges; the detector's dead units after the loss bin equal
    what that bin's runtime lost, reach the next bin's planner, and its
    plan fits in what remains; each arch's launches are one flash launch
    per layer per service call and one decode launch per layer per decode
    step; and the registry's counters equal the bins' ``SimMetrics``, the
    trace holds a hop, queue and service span for every sub-request
    served, and the audit log one re-plan event per planning pass and one
    transition event per transition the runtime applied mid-bin.  MIG
    carving and weight staging are modelled, not done: every instance is
    served on the whole card, and a planned int8 variant runs in bf16.
    Returns the launches per arch and kernel."""
    import dataclasses
    from repro_torch.chaos import (DegradationLadder, EmergencyReplanner,
                                   FailureDetector)
    from repro_torch.core.controller import Controller
    from repro_torch.core.frontend import Frontend
    from repro_torch.core.milp import Planner
    from repro_torch.core.trace import diurnal_trace
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.obs import (AuditLog, Instrumentation, SloPlane,
                                 Tracer, parse_exposition,
                                 validate_chrome_trace)
    from repro_torch.reconfig import TransitionPlanner
    from repro_torch.runtime import PreemptionEvent, Scenario

    t_phase = time.monotonic()
    backend = planned["backend"]
    graph, cluster, prof = _scaled_on(planned["graph"], planned["fitted"], 1,
                                      planned["slo_scale"])
    (pool,) = cluster.pools
    leaves = len(graph.paths)
    mods = {"flash_attention": fmod, "decode_attention": dmod,
            "ssd_scan": smod, "quant_matmul": qmod}
    counted = _PerArch(backend, mods)
    hooks = Instrumentation(tracer=Tracer(), slo=SloPlane(), audit=AuditLog())
    tee = _Tee(hooks)
    detector = FailureDetector()
    ladder = DegradationLadder(profiler=prof)
    monitor = EmergencyReplanner(
        Frontend(graph), planner=Planner(
            graph, prof, s_avail=cluster.total_units,
            stickiness=CONTROL_STICKINESS, **PLAN_KW),
        reconfig=TransitionPlanner(cluster, graph), hooks=tee,
        **CONTROL_MONITOR)
    ctl = Controller(graph, prof, s_avail=cluster.total_units,
                     cluster=cluster, planner_kwargs=dict(PLAN_KW),
                     backend_factory=lambda: counted,
                     reconfig=TransitionPlanner(cluster, graph),
                     detector=detector, monitor=monitor, ladder=ladder,
                     hooks=tee)
    bins = []
    make_runtime, staged_plan = ctl.make_runtime, ctl.reconfig.plan

    def kept_runtime(**kw):
        rt = make_runtime(**kw)
        rec, run = bins[-1], rt.run
        rec["runtime"] = rt

        def kept_run(scenario):
            rec["metrics"] = run(scenario)
            return rec["metrics"]
        rt.run = kept_run
        return rt

    def kept_plan(*args, **kw):
        tr = staged_plan(*args, **kw)
        bins[-1]["staged"].append(tr)
        return tr

    ctl.make_runtime, ctl.reconfig.plan = kept_runtime, kept_plan
    peak = _control_peak(graph, cluster, prof)
    rps = diurnal_trace(seed=CONTROL_TRACE_SEED, bins=CONTROL_BINS
                        ).scaled_to_max(peak["peak_rps"]).rps
    loss = PreemptionEvent(at_s=CONTROL_LOSS_AT_S, pool=pool.name,
                           notice_s=CONTROL_LOSS_NOTICE_S,
                           fraction=CONTROL_LOSS_UNITS / pool.capacity_units)
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    for i, r in enumerate(rps):
        tee.ledger, tee.starts = _Ledger(), []
        bins.append({"ledger": tee.ledger, "starts": tee.starts,
                     "staged": [], "dead_before": detector.dead_units()})
        scenario = Scenario.poisson(float(r), duration_s=CONTROL_BIN_S,
                                    warmup_s=0.0)
        if i == CONTROL_LOSS_BIN:
            scenario = scenario.with_chaos(loss)
        t0 = time.monotonic()
        rep = ctl.step(i, float(r), scenario=scenario, seed=seed + i)
        hooks.registry.render()      # a scrape: the SLO plane evaluates
        bins[-1].update(
            report=rep, host_s=time.monotonic() - t0,
            dead_after=detector.dead_units(),
            planner_dead=dict(ctl.planner.dead_units),
            pool_slices=ctl._config.pool_slices(),
            emergency=monitor.replans, spikes=monitor.spikes,
            ladder_level=ladder.level, alerts=hooks.slo.alerts_json())
    totals = {k: mod.launches for k, mod in mods.items()}
    fails = []

    # 1. accounting, bin by bin
    per_bin = []
    for i, b in enumerate(bins):
        rt, m, led = b["runtime"], b["metrics"], b["ledger"]
        roots = set(rt._root_t)
        left = sum(len(q) for q in rt.queues.values())
        ok = (bool(roots) and set(led.outcomes) == roots
              and all(n == leaves for n in led.outcomes.values())
              and m.completions + m.dropped == leaves * len(roots)
              and left == 0)
        if not ok:
            fails.append(f"bin {i}: {len(roots)} roots, "
                         f"{len(led.outcomes)} with outcomes, "
                         f"{m.completions} completions + {m.dropped} "
                         f"dropped, {left} left in queues")
        per_bin.append({
            "bin": i, "rate_rps": float(rps[i]), "roots": len(roots),
            "admitted": led.arrivals, "completions": m.completions,
            "missed": m.missed, "dropped": m.dropped,
            "drop_reasons": dict(m.drop_reasons),
            "slo_attainment": 1.0 - m.violation_rate,
            "within_app_slo": sum(
                x <= planned["graph"].slo_latency_ms
                for x in m.latencies_ms) / max(m.total_requests, 1),
            "window_violation_rate": (m.window.violation_rate
                                      if m.window is not None else None),
            "transition_window_s": m.transition_window_s,
            "dead_units": rt.dead_units(), "pool_slices": b["pool_slices"],
            "planner_dead_units": b["planner_dead"],
            "emergency_replans": b["emergency"], "spikes": b["spikes"],
            "ladder_level": b["ladder_level"],
            "alerts": b["alerts"]["alerts"], "host_s": b["host_s"],
            "accounted": ok})

    # 2. re-planning: each runtime runs the one transition its bin charges
    transitions = []
    for i, b in enumerate(bins):
        rep, rt = b["report"], b["runtime"]
        want = next((t for t in b["staged"] if not t.is_empty), None)
        charged = (rep.transition_s, rep.transition_actions)
        if rt._transition is not want or charged != (
                (want.makespan_s, want.n_actions) if want else (0.0, 0)):
            fails.append(f"bin {i}: charged {charged}, its runtime ran "
                         f"{'a' if rt._transition else 'no'} transition, "
                         f"its step planned "
                         f"{'one' if want else 'none'}")
        if want is None:
            continue
        served = {a.tup.key for a in want.loads for key, t in b["starts"]
                  if key == a.tup.key and t >= a.ready_s - 1e-9}
        transitions.append({"bin": i, "loads_served": len(served),
                            **_transition_rows(graph, pool, want,
                                               planned["h2d_bytes_per_s"])})
    replanned = [b["report"].bin_idx for b in bins if b["report"].replanned]
    executed = [t for t in transitions
                if any(a["kind"] == "load" for a in t["actions"])]
    if len(replanned) < 2 or not executed:
        fails.append(f"re-planned in bins {replanned}; staged transitions "
                     f"with loads: {len(executed)}")

    # 3. detection: the loss reaches the next bin's plan
    lost = bins[CONTROL_LOSS_BIN]["runtime"].dead_units()
    after = bins[CONTROL_LOSS_BIN]["dead_after"]
    nxt = bins[CONTROL_LOSS_BIN + 1]
    room = pool.capacity_units - sum(after.values())
    if (lost != {pool.name: CONTROL_LOSS_UNITS}
            or bins[CONTROL_LOSS_BIN]["dead_before"] or after != lost
            or not nxt["report"].replanned or nxt["planner_dead"] != after
            or nxt["pool_slices"].get(pool.name, 0) > room
            or any(b["runtime"].dead_units() for j, b in enumerate(bins)
                   if j != CONTROL_LOSS_BIN)):
        fails.append(f"detection: bin {CONTROL_LOSS_BIN} lost {lost}, the "
                     f"detector holds {after}; bin {CONTROL_LOSS_BIN + 1} "
                     f"re-planned {nxt['report'].replanned} with "
                     f"{nxt['planner_dead']} dead, using "
                     f"{nxt['pool_slices']} of {room}")

    # 4. launches per arch, as in the compound phase
    expect = {}
    for arch_name, calls in counted.calls.items():
        layers = backend._engines[arch_name].model.arch.num_layers
        expect[arch_name] = {"flash_attention": layers * calls,
                             "decode_attention":
                                 layers * calls * (SERVE_NEW - 1),
                             "ssd_scan": 0, "quant_matmul": 0}
    if (not counted.calls or counted.launches != expect
            or any(totals[k] != sum(c[k] for c in counted.launches.values())
                   for k in mods)):
        fails.append(f"launches {counted.launches} != {expect} "
                     f"(totals {totals})")

    # 5. instrumentation against the bins' SimMetrics
    parsed = parse_exposition(hooks.registry.render())
    ms = [b["metrics"] for b in bins]
    want_reasons, want_served = {}, {}
    for m in ms:
        for k, n in m.drop_reasons.items():
            want_reasons[k] = want_reasons.get(k, 0) + n
        for (t, _), n in m.traffic.items():
            want_served[t] = want_served.get(t, 0) + n
    shed_roots = sum(m.drop_reasons.get(k, 0) for m in ms
                     for k in ("admission", "shed")) / leaves
    roots = sum(p["roots"] for p in per_bin)
    emergency = sum(b["emergency"] for b in bins)
    audit = {}
    for e in hooks.audit.events:
        audit[e.kind] = audit.get(e.kind, 0) + 1
    spans = {}
    events = validate_chrome_trace(hooks.tracer.chrome_trace())
    for s in hooks.tracer.spans:
        spans[s.cat] = spans.get(s.cat, 0) + 1
    got = {
        "arrivals": _counts(parsed, "jigsaw_arrivals_total").get("", 0.0),
        "completions": _counts(parsed, "jigsaw_completions_total").get(
            "", 0.0),
        "missed": _counts(parsed, "jigsaw_missed_total").get("", 0.0),
        "drops": _counts(parsed, "jigsaw_drops_total", "reason"),
        "served": _counts(parsed, "jigsaw_served_total", "task"),
        "replans": _counts(parsed, "jigsaw_replans_total").get("", 0.0),
        "transitions": _counts(parsed, "jigsaw_transitions_total", "kind"),
        "audit": audit, "spans": spans, "complete_events": len(events),
        "spans_dropped": hooks.tracer.dropped}
    want = {
        "arrivals": float(sum(b["ledger"].arrivals for b in bins)),
        "completions": float(sum(m.completions for m in ms)),
        "missed": float(sum(m.missed for m in ms)),
        "drops": {k: float(n) for k, n in want_reasons.items()},
        "served": {k: float(n) for k, n in want_served.items()},
        "replans": float(len(ctl.milp_times_ms)),
        "transitions": {"emergency": float(emergency)} if emergency else {},
        "spans": dict.fromkeys(("queue", "service", "hop"),
                               int(sum(want_served.values())))}
    inst_ok = (all(got[k] == want[k] for k in want if k != "spans")
               and {k: spans.get(k, 0) for k in want["spans"]}
               == want["spans"] and hooks.tracer.dropped == 0
               and len(events) == len(hooks.tracer.spans)
               and got["arrivals"] + shed_roots == roots
               and audit.get("replan", 0) == len(ctl.milp_times_ms)
               and audit.get("transition", 0) == emergency
               and audit.get("emergency_replan", 0) == emergency)
    if not inst_ok:
        fails.append(f"instrumentation: {got} against {want} "
                     f"({roots} roots, {shed_roots} shed at the gate)")
    emit("control", card=card["nvidia_smi"], app=COMPOUND_APP,
         plan_on="repro_torch Controller, h100_cluster(1) with the plan "
                 "phase's fitted H100_SXM",
         note="every planned instance is served on the whole card; MIG "
              "carving and weight staging of a transition are modelled "
              "(a loaded instance serves from its ready_s), not done; int8 "
              "variants run in bf16 (EngineBackend ignores Variant.quant, "
              "as the reference's does); attainment has no limit yet",
         trace={"seed": CONTROL_TRACE_SEED, "bins": CONTROL_BINS, **peak,
                "rps": [float(r) for r in rps]},
         bin_s=CONTROL_BIN_S, seed=seed, slo_scale=planned["slo_scale"],
         loss={"bin": CONTROL_LOSS_BIN, "event": dataclasses.asdict(loss),
               "units": CONTROL_LOSS_UNITS, "of": pool.capacity_units},
         reports=[dataclasses.asdict(b["report"]) for b in bins],
         bins=per_bin, transitions=transitions, replanned_bins=replanned,
         detector_dead_units=detector.dead_units(),
         monitor=CONTROL_MONITOR, registry=got, expected=want,
         service_calls=counted.calls, launches=counted.launches,
         expected_launches=expect,
         phase_host_wall_s=time.monotonic() - t_phase,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         failures=fails)
    if fails:
        raise AssertionError("control: " + "; ".join(fails))
    return counted.launches


# The gateway phase: the compound phase's traffic (Poisson at COMPOUND_RPS
# for COMPOUND_S seconds from --seed) sent over HTTP on the loopback to the
# port's AsyncGateway, which serves it live (time_scale 1) on the plan
# phase's plan and engines.  GATEWAY_LIMIT_S bounds the whole exchange (load,
# drain, streamed submit, scrapes); a root that never resolves fails it.
GATEWAY_HOST = "127.0.0.1"
GATEWAY_RPS, GATEWAY_S = COMPOUND_RPS, COMPOUND_S
GATEWAY_LIMIT_S = 180.0


class _Dispatches:
    """The gateway phase's hooks: every call goes to ``inner`` (the phase's
    ``Instrumentation``, whose other attributes it stands in for), and each
    dispatch is also kept: server, batch, start, service, the host seconds
    its ``service_s`` blocked the loop (the last of ``counted.walls``), and
    how many earlier batches of that server were still in their ``_serve``.
    ``watch`` wraps a gateway's ``_serve`` so that each batch's end is kept
    too: its hops' latencies, and how many later launches' ``busy_until``
    it overwrote."""

    def __init__(self, inner, counted):
        self.inner, self.counted = inner, counted
        self.dispatches, self.open = [], {}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def on_dispatch(self, server, batch, now, service_s, queue_len):
        self.inner.on_dispatch(server, batch, now, service_s, queue_len)
        pending = self.open.setdefault(server.idx, [])
        rec = {"server": server.idx, "task": server.tup.task,
               "variant": server.tup.variant, "batch": len(batch),
               "start_s": now, "service_s": service_s,
               "blocked_s": self.counted.walls[-1],
               "earlier_in_serve": len(pending),
               "enqueue_s": [r.enqueue_t for r in batch]}
        pending.append((batch, rec))
        self.dispatches.append(rec)

    def watch(self, gw):
        serve = gw._serve

        async def watched(srv, qt, batch, service):
            await serve(srv, qt, batch, service)
            pending = self.open[srv.idx]
            i = next(i for i, (b, _) in enumerate(pending) if b is batch)
            _, rec = pending.pop(i)
            end = srv.busy_until            # _serve's own clock reading
            rec["done_s"] = end
            rec["hop_ms"] = [(end - t) * 1e3 for t in rec.pop("enqueue_s")]
            rec["overwrote"] = sum(r["start_s"] + r["service_s"] > end
                                   for _, r in pending)
        gw._serve = watched


async def _fetch(port: int, method: str, path: str) -> tuple:
    """One HTTP/1.1 request on the loopback: status, head and body."""
    import asyncio
    reader, writer = await asyncio.open_connection(GATEWAY_HOST, port)
    try:
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: {GATEWAY_HOST}\r\n"
                     f"Content-Length: 0\r\nConnection: close\r\n\r\n"
                     .encode())
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
        await writer.wait_closed()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), head, body


def _dechunk(payload: bytes) -> bytes:
    """An HTTP/1.1 chunked body, decoded."""
    out, rest = [], payload
    while rest:
        size_line, _, rest = rest.partition(b"\r\n")
        size = int(size_line, 16)
        if size == 0:
            break
        out.append(rest[:size])
        rest = rest[size + 2:]
    return b"".join(out)


def phase_gateway(torch, card, seed: int, planned: dict) -> dict:
    """The serving front door on the card: the port's ``AsyncGateway``
    serves social_media live (``time_scale`` 1) behind its
    ``GatewayHTTPServer`` on the loopback, on the plan phase's one-H100
    plan and graph (SLO scaled by that phase's deadline scale) and its
    ``EngineBackend(reduced=False)`` engines (full-width gemma-2b,
    granite-3-2b and qwen2-7b in bf16), with an ``Instrumentation``
    (tracer, SLO plane, audit log).  The port's load generator sends
    Poisson traffic over HTTP (``open_loop`` + ``http_submitter``); then
    one streamed submit, and ``/metrics``, ``/trace``, ``/alerts``,
    ``/audit`` and ``/healthz`` are scraped.

    It fails unless every submission resolves (ok + dropped + rejected ==
    submitted, no errors) and at least one is ok; no root is left in the
    gateway or in ``/healthz``; the scraped arrivals equal the admitted
    submissions and ok <= completions <= ok + dropped; the trace is valid
    and every root has as many queue and service spans as hop spans; the
    stream ends in ``done`` and its hops name deployed variants only; and
    each arch's launches are one flash launch per layer per service call
    and one decode launch per layer per decode step.  The gateway calls
    ``service_s`` inline, as the JAX package's does: the event loop is
    blocked for each service, a hop then sleeps its service again, and a
    server may take a batch while its last one still sleeps.  The phase
    measures all three.  Returns the launches per arch and kernel."""
    import asyncio
    import dataclasses
    from repro_torch.gateway import (AsyncGateway, GatewayHTTPServer,
                                     http_submitter, open_loop)
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.obs import (AuditLog, Instrumentation, SloPlane,
                                 Tracer, parse_exposition,
                                 validate_chrome_trace)

    t_phase = time.monotonic()
    backend = planned["backend"]
    graph, _, _ = _scaled_on(planned["graph"], planned["fitted"], 1,
                             planned["slo_scale"])
    cfg = dataclasses.replace(planned["cfg"], graph=graph)
    deployed = sorted({(t.task, t.variant) for t, m in cfg.instances()
                       if m > 0})
    mods = {"flash_attention": fmod, "decode_attention": dmod,
            "ssd_scan": smod, "quant_matmul": qmod}
    counted = _PerArch(backend, mods)
    hooks = Instrumentation(tracer=Tracer(), slo=SloPlane(), audit=AuditLog())
    probe = _Dispatches(hooks, counted)
    torch.cuda.reset_peak_memory_stats()

    async def exchange():
        gw = AsyncGateway({COMPOUND_APP: (graph, cfg)}, counted, seed=seed,
                          time_scale=1.0, hooks=probe)
        probe.watch(gw)
        srv = GatewayHTTPServer(gw, hooks, GATEWAY_HOST, 0)
        await srv.start()
        out = {"gw": gw}
        try:
            port = srv.port
            for mod in mods.values():
                mod.launches = 0
            t0 = time.monotonic()
            out["report"] = (await open_loop(
                http_submitter(f"http://{GATEWAY_HOST}:{port}"),
                {COMPOUND_APP: GATEWAY_RPS}, duration_s=GATEWAY_S,
                seed=seed)).to_dict()
            out["run_wall_s"] = time.monotonic() - t0
            out["roots_left"] = len(gw._roots)
            out["metrics"] = (await _fetch(port, "GET", "/metrics"))[2]
            out["stream"] = await _fetch(
                port, "POST", f"/v1/{COMPOUND_APP}/submit?stream=1")
            for path in ("/metrics", "/trace", "/alerts", "/audit",
                         "/healthz"):
                out[path] = await _fetch(port, "GET", path)
        finally:
            await srv.stop()
        return out

    async def bounded():
        return await asyncio.wait_for(exchange(), GATEWAY_LIMIT_S)

    got = asyncio.run(bounded())
    gw, tot = got["gw"], got["report"]["total"]
    totals = {k: mod.launches for k, mod in mods.items()}
    fails = []

    # 1. every submission resolves, and no root is left behind
    health = json.loads(got["/healthz"][2])
    if (tot["submitted"] <= 0 or tot["errors"] or tot["ok"] < 1
            or tot["ok"] + tot["dropped"] + tot["rejected"]
            != tot["submitted"]):
        fails.append(f"resolution: {tot}")
    if got["roots_left"] or gw._roots or health.get("inflight_roots"):
        fails.append(f"roots left: {got['roots_left']} after the load, "
                     f"{len(gw._roots)} at the end, /healthz {health}")

    # 2. the counters scraped after the load against the load report
    parsed = parse_exposition(got["metrics"].decode())
    arrivals = _counts(parsed, "jigsaw_arrivals_total").get("", 0.0)
    completions = _counts(parsed, "jigsaw_completions_total").get("", 0.0)
    if (arrivals != tot["submitted"] - tot["rejected"]
            or not tot["ok"] <= completions <= tot["ok"] + tot["dropped"]):
        fails.append(f"counters: {arrivals} arrivals, {completions} "
                     f"completions against {tot}")

    # 3. the trace: valid, and a queue and a service span for every hop
    status, _, body = got["/trace"]
    events = validate_chrome_trace(json.loads(body)) if status == 200 else []
    spans = {}
    for s in hooks.tracer.spans:
        per = spans.setdefault(s.root_id, {"hop": 0, "queue": 0,
                                           "service": 0})
        per[s.cat] = per.get(s.cat, 0) + 1
    uneven = [r for r, n in spans.items()
              if not n["hop"] == n["queue"] == n["service"]]
    if status != 200 or not events or not spans or uneven:
        fails.append(f"trace: status {status}, {len(events)} events, "
                     f"roots with uneven spans {uneven}")

    # 4. the streamed submit
    status, head, body = got["stream"]
    lines = ([json.loads(ln) for ln in _dechunk(body).strip().split(b"\n")]
             if status == 200 else [])
    hops = [(ln["task"], ln["variant"]) for ln in lines
            if ln.get("event") == "hop"]
    if (status != 200 or b"chunked" not in head.lower() or not lines
            or lines[-1].get("event") != "done"
            or any(h not in deployed for h in hops)):
        fails.append(f"stream: status {status}, lines {lines}")

    # 5. launches per arch, as in the compound phase
    expect = {}
    for arch_name, calls in counted.calls.items():
        layers = backend._engines[arch_name].model.arch.num_layers
        expect[arch_name] = {"flash_attention": layers * calls,
                             "decode_attention":
                                 layers * calls * (SERVE_NEW - 1),
                             "ssd_scan": 0, "quant_matmul": 0}
    if (not counted.calls or counted.launches != expect
            or any(totals[k] != sum(c[k] for c in counted.launches.values())
                   for k in mods)):
        fails.append(f"launches {counted.launches} != {expect} "
                     f"(totals {totals})")

    # the inline service: loop blocked, service paid twice, double booking
    done = [d for d in probe.dispatches if "done_s" in d]
    if len(done) != len(probe.dispatches):
        fails.append(f"{len(probe.dispatches) - len(done)} batches never "
                     "ended their _serve")
    blocked = [d["blocked_s"] for d in probe.dispatches]
    ratio = [(d["done_s"] - d["start_s"]) / d["service_s"] for d in done
             if d["service_s"] > 0]
    audit = {}
    for ln in got["/audit"][2].decode().splitlines():
        kind = json.loads(ln)["kind"]
        audit[kind] = audit.get(kind, 0) + 1
    alerts = json.loads(got["/alerts"][2])
    emit("gateway", card=card["nvidia_smi"], app=COMPOUND_APP,
         plan_from="plan phase (repro_torch Planner, h100_cluster(1))",
         deployed=deployed, slo_scale=planned["slo_scale"],
         slo_ms=graph.slo_latency_ms, host=GATEWAY_HOST,
         rate_rps=GATEWAY_RPS, duration_s=GATEWAY_S, seed=seed,
         time_scale=gw.time_scale,
         note="every planned instance is served on the whole card; int8 "
              "variants run in bf16 (EngineBackend ignores Variant.quant, "
              "as the reference's does); AsyncGateway calls service_s "
              "inline and then sleeps the service, as the reference's "
              "does; attainment has no limit yet",
         load=got["report"], run_host_wall_s=got["run_wall_s"],
         scraped={"arrivals": arrivals, "completions": completions,
                  "drops": _counts(parsed, "jigsaw_drops_total", "reason"),
                  "admission_rejects": _counts(
                      parsed, "jigsaw_admission_rejects_total").get("", 0.0)},
         health=health, alerts_firing=alerts.get("alerts"),
         alert_rules=[r["name"] for r in alerts.get("rules", [])],
         audit=audit, trace_events=len(events),
         roots_traced=len(spans), stream=lines,
         service_calls=counted.calls, launches=counted.launches,
         expected_launches=expect,
         loop_blocked_s={"sum": sum(blocked), "calls": len(blocked),
                         "per_call": blocked},
         done_over_service={
             "mean": sum(ratio) / len(ratio) if ratio else None,
             "min": min(ratio, default=None),
             "max": max(ratio, default=None)},
         launches_on_busy_server=sum(d["earlier_in_serve"] > 0
                                     for d in probe.dispatches),
         busy_until_overwritten=sum(d.get("overwrote", 0) for d in done),
         dispatches=probe.dispatches,
         phase_host_wall_s=time.monotonic() - t_phase,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         failures=fails)
    if fails:
        raise AssertionError("gateway: " + "; ".join(fails))
    return counted.launches


# ---------------------------------------------------------------------------
# The training path (phase 13): granite-3-2b at full width, B 8 x S 256.
# AdamW's state is 16 B a parameter (bf16 params and grads, fp32 master, m,
# v): 40.5 GB at all 40 layers, which with the plain attention's
# activations fits one 80 GB card.  mamba2-130m's restart goes through a
# checkpoint on disk.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 256, 12
TRAIN_CHECK_LAYERS = 2          # the fp32 checks against float64
TRAIN_F64_LOSS_TOL = 1e-5       # relative, fp32 loss vs float64
TRAIN_F64_GRAD_TOL = 1e-3       # per tensor max|dg| / max|g|, vs float64
TRAIN_REMAT_TOL = 1e-5          # per tensor, remat against none (rounding)
TRAIN_LOSS_RTOL = 1e-5          # tests/test_training.py:40-55
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
TRAIN_COMPRESSED_TOL = 0.12     # tests/test_training.py:69-83
TRAIN_LOSS_DROP = 0.3           # tests/test_training.py:37
TRAIN_RESTART_TOL = 1e-6        # tests/test_checkpoint.py:115


def _named_grads(torch, model, batch):
    """(loss, [grads]) of one loss over ``model``'s parameters."""
    loss = model.loss(batch)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def _params_against(cfg, a: dict, b: dict, state_a: dict) -> dict:
    """Two states' params one step in, at TRAIN_RTOL/ATOL, apart from
    elements in AdamW's eps region (``sqrt(v_hat) < 10 eps``: a gradient
    ~1e-9, where ``g / (|g| + eps)`` turns on rounding); those are held to
    ``2 lr``, the bound of any update (as tests/test_torch_training.py)."""
    step = int(state_a["opt"]["step"])
    b2c = 1.0 - cfg.b2 ** step
    bad = flat = 0
    worst_flat = 0.0
    lr = float(cfg.lr)
    for k, p in a.items():
        p, q = p.detach().float(), b[k].detach().float()
        d = (p - q).abs()
        eps_region = (state_a["opt"]["v"][k] / b2c).sqrt() < 10 * cfg.eps
        far = d > TRAIN_ATOL + TRAIN_RTOL * p.abs()
        bad += int((far & ~eps_region).sum())
        nonzero = eps_region & (state_a["opt"]["v"][k] > 0)
        flat += int(nonzero.sum())
        if bool(eps_region.any()):
            worst_flat = max(worst_flat, float(d[eps_region].max()))
    return {"outside_tolerance": bad, "eps_region_elements": flat,
            "eps_region_max_abs_diff": worst_flat,
            "eps_region_ok": worst_flat <= 2 * lr * step}


def _train_checks(torch, card, seed: int) -> list:
    """granite-3-2b at full width, TRAIN_CHECK_LAYERS layers, fp32: loss
    and gradients against the same model in float64, remat against none,
    4 microbatches against 1, int8 compression against exact over 8 steps,
    and the kernel path refusing autograd."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.models import Model
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (batch_on, init_train_state,
                                                 make_train_step)

    fails = []
    arch = get_arch(GRANITE).scaled(num_layers=TRAIN_CHECK_LAYERS)
    dcfg = data_mod.for_arch(arch, TRAIN_S, TRAIN_B)

    def model(dtype=torch.float32, impl="plain", like=None):
        m = Model(arch, device="cuda", dtype=dtype, impl=impl)
        if like is None:
            m.init(torch.Generator(device=m.device).manual_seed(seed))
        else:
            m.load_state_dict({k: v.to(dtype) for k, v in
                               like.state_dict().items()})
        return m.requires_grad_(True)

    m32 = model()
    batch = batch_on(data_mod.batch_at_step(dcfg, 0), m32.device)
    m64 = model(torch.float64, like=m32)
    l32, g32 = _named_grads(torch, m32, batch)
    l64, g64 = _named_grads(torch, m64, batch)
    names = [n for n, _ in m32.named_parameters()]
    rel = _rel_errs(g32, g64)
    worst = max(range(len(rel)), key=rel.__getitem__)
    loss_rel = abs(float(l32) - float(l64)) / abs(float(l64))
    f64 = {"loss_fp32": float(l32), "loss_f64": float(l64),
           "loss_rel_err": loss_rel, "grad_rel_err_max": rel[worst],
           "grad_rel_err_worst_tensor": names[worst],
           "grad_rel_err_median": sorted(rel)[len(rel) // 2],
           "tensors": len(rel)}
    if loss_rel > TRAIN_F64_LOSS_TOL or rel[worst] > TRAIN_F64_GRAD_TOL:
        fails.append(f"fp32 vs float64: loss {loss_rel}, grad {rel[worst]}")
    del m64, g64

    remat = {}
    for kind in ("full", "dots"):
        m32.remat = kind
        lr_, gr = _named_grads(torch, m32, batch)
        r = _rel_errs(gr, g32)
        remat[kind] = {"loss_abs_diff": abs(float(lr_) - float(l32)),
                       "grad_rel_err_max": max(r)}
        if max(r) > TRAIN_REMAT_TOL or abs(float(lr_) - float(l32)) > \
                TRAIN_LOSS_RTOL * abs(float(l32)):
            fails.append(f"remat {kind}: {remat[kind]}")
    m32.remat = "none"
    del g32

    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    host_batch = data_mod.batch_at_step(dcfg, 0)
    m_a = model(like=m32)
    s_a = init_train_state(m_a, None, cfg)
    m_b = model(like=m32)
    s_b = init_train_state(m_b, None, cfg)
    s_a, r_a = make_train_step(m_a, cfg, microbatches=1)(s_a, host_batch)
    s_b, r_b = make_train_step(m_b, cfg, microbatches=4)(s_b, host_batch)
    mb_loss_rel = abs(float(r_a["loss"]) - float(r_b["loss"])) / abs(
        float(r_a["loss"]))
    mb = {"loss_1": float(r_a["loss"]), "loss_4": float(r_b["loss"]),
          "loss_rel_err": mb_loss_rel,
          "grad_norm_1": float(r_a["grad_norm"]),
          "grad_norm_4": float(r_b["grad_norm"]),
          **_params_against(cfg, s_a["params"], s_b["params"], s_a)}
    if (mb_loss_rel > TRAIN_LOSS_RTOL or mb["outside_tolerance"]
            or not mb["eps_region_ok"]):
        fails.append(f"microbatches 4 vs 1: {mb}")
    del m_a, m_b, s_a, s_b

    # int8 compression against exact, 8 steps each from the same weights:
    # at tests/test_training.py's own configuration (granite reduced, S 32,
    # B 8), held to its 0.12; at full width, where the reference's
    # algorithm drifts further (one scale a stacked leaf zeroes most of a
    # wide gradient: tests/test_torch_training.py::
    # test_int8_gap_grows_with_width_as_the_reference), the reading is kept
    # beside the limit and the compressed run must still learn.
    compressed = {}
    for label, arch_c, dcfg_c in (
            ("reduced", get_arch(GRANITE).reduced(),
             data_mod.for_arch(get_arch(GRANITE).reduced(), 32, 8)),
            ("full_width", arch, dcfg)):
        base = Model(arch_c, device=m32.device, dtype=torch.float32,
                     impl="plain")
        base.init(torch.Generator(device=m32.device).manual_seed(seed))
        runs = {}
        for kind in (None, "int8"):
            m = Model(arch_c, device=m32.device, dtype=torch.float32,
                      impl="plain")
            m.load_state_dict(base.state_dict())
            s = init_train_state(m, None, cfg)
            f = make_train_step(m, cfg, grad_compression=kind)
            runs[kind or "exact"] = []
            for i in range(8):
                s, r = f(s, data_mod.batch_at_step(dcfg_c, i))
                runs[kind or "exact"].append(float(r["loss"]))
            del m, s, f
        diff = abs(runs["exact"][-1] - runs["int8"][-1])
        compressed[label] = {**runs, "abs_diff": diff}
        del base
    if compressed["reduced"]["abs_diff"] >= TRAIN_COMPRESSED_TOL:
        fails.append(f"int8 compression (reduced): {compressed['reduced']}")
    wide = compressed["full_width"]["int8"]
    if not (all(map(math.isfinite, wide))
            and wide[-1] < wide[0] - TRAIN_LOSS_DROP):
        fails.append(f"int8 compression (full width) did not learn: {wide}")

    mk = model(impl="kernel", like=m32)
    n0 = fmod.launches
    try:
        mk.loss(batch).backward()
        refused = None
    except RuntimeError as e:
        refused = str(e)
    if refused is None or "no backward" not in refused or \
            fmod.launches != n0:
        fails.append(f"the kernel path did not refuse autograd: {refused}")
    emit("train_checks", card=card["nvidia_smi"], arch=arch.name,
         layers=arch.num_layers, batch=TRAIN_B, seq=TRAIN_S,
         params=sum(p.numel() for p in m32.parameters()),
         float64=f64, remat=remat, microbatches_4_vs_1=mb,
         compressed_8_steps=compressed,
         compressed_limit=TRAIN_COMPRESSED_TOL,
         kernel_refusal=refused, failures=fails)
    return fails


def _step_profile(torch, step_fn, state, batch) -> tuple:
    """One training step under torch.profiler: (state, wall s, device
    busy ms, top kernels, device ms by kind)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kinds = (("gemm", ("gemm", "xmma", "cutlass", "nvjet", "wgmma")),
             ("softmax", ("softmax",)), ("copy/cast", ("copy",)),
             ("reduce", ("reduce",)),
             ("elementwise", ("elementwise", "vectorized", "unrolled")))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    by_kind = {}
    for e in evs:
        name = e.key.lower()
        kind = next((k for k, subs in kinds if any(s in name for s in subs)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    top = [{"name": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3}
           for e in sorted(evs, key=lambda e: e.self_device_time_total,
                           reverse=True)[:12]]
    return state, wall, busy, top, by_kind


def _step_parts(torch, step_fn, state, batch) -> tuple:
    """One training step with the loss (forward), its gradients (backward)
    and the AdamW update each bracketed by synchronize: host seconds of
    each."""
    from repro_torch.models import Model
    from repro_torch.training import optimizer as opt
    parts = {}

    def timed(label, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[label] = parts.get(label, 0.0) + time.monotonic() - t0
            return out
        return call

    saved = (Model.loss, torch.autograd.grad, opt.apply_updates)
    Model.loss = timed("forward", saved[0])
    torch.autograd.grad = timed("backward", saved[1])
    opt.apply_updates = timed("optimizer", saved[2])
    try:
        state, _ = step_fn(state, batch)
    finally:
        Model.loss, torch.autograd.grad, opt.apply_updates = saved
    return state, parts


def _train_full(torch, card) -> list:
    """granite-3-2b at full width and depth in bf16 through
    ``launch/train.py``'s own setup: TRAIN_STEPS steps on the host clock,
    then one step under the profiler, one split into its parts, and the
    peak memory of one loss and gradient under each remat."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.launch import train as train_launch
    from repro_torch.training import data as data_mod
    from repro_torch.training.train_step import batch_on

    fails = []
    args = train_launch.parse_args([
        "--arch", GRANITE, "--steps", str(TRAIN_STEPS),
        "--seq-len", str(TRAIN_S), "--global-batch", str(TRAIN_B),
        "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    model, ocfg, state, start, step_fn, dcfg = train_launch.setup(args)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    mods = {"flash_attention": fmod, "decode_attention": dmod,
            "ssd_scan": smod, "quant_matmul": qmod}
    for mod in mods.values():
        mod.launches = 0
    losses, gnorms, walls = [], [], []
    for step in range(start, args.steps):
        batch = data_mod.batch_at_step(dcfg, step)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    opt_step = int(state["opt"]["step"])
    launches = {k: m.launches for k, m in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    finite = all(map(math.isfinite, losses + gnorms))
    if not finite or opt_step != TRAIN_STEPS:
        fails.append(f"full depth: finite {finite}, step {opt_step}")
    if not losses[-1] < losses[0] - TRAIN_LOSS_DROP:
        fails.append(f"full depth: loss {losses[0]} -> {losses[-1]} fell "
                     f"less than {TRAIN_LOSS_DROP}")
    if any(launches.values()):
        fails.append(f"the training path launched kernels: {launches}")
    steady = sorted(walls[2:])
    step_s = steady[len(steady) // 2]
    state, prof_wall, busy, top, by_kind = _step_profile(
        torch, step_fn, state, data_mod.batch_at_step(dcfg, TRAIN_STEPS))
    state, parts = _step_parts(torch, step_fn, state,
                               data_mod.batch_at_step(dcfg, TRAIN_STEPS + 1))
    batch = batch_on(data_mod.batch_at_step(dcfg, 0), model.device)
    remat_peak = {}
    for kind in ("none", "full", "dots"):
        model.remat = kind
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, grads = _named_grads(torch, model, batch)
        del grads
        torch.cuda.synchronize()
        remat_peak[kind] = {
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "above_state_bytes": torch.cuda.max_memory_allocated() - base}
    model.remat = "none"
    emit("train", card=card["nvidia_smi"], arch=model.arch.name,
         layers=model.arch.num_layers, dtype=str(model.dtype),
         params=sum(p.numel() for p in model.parameters()),
         batch=TRAIN_B, seq=TRAIN_S, steps=len(walls), optimizer_step=opt_step,
         lr=ocfg.lr, warmup_steps=ocfg.warmup_steps, losses=losses,
         grad_norms=gnorms, step_s=walls, median_step_s_after_2=step_s,
         tokens_per_s=TRAIN_B * TRAIN_S / step_s,
         state_bytes=state_bytes, peak_bytes=peak,
         profiled_step_wall_s=prof_wall, device_busy_ms=busy,
         idle_share_profiled_step=1.0 - busy / 1e3 / prof_wall,
         idle_share_of_median_step=1.0 - busy / 1e3 / step_s,
         device_ms_by_kind=by_kind,
         top_kernels=top, step_parts_s=parts, remat_peak=remat_peak,
         kernel_launches=launches, failures=fails)
    del model, state, step_fn
    return fails


def _train_restart(torch, card, tmp: str) -> list:
    """mamba2-130m at full width and depth in bf16 through the launcher's
    setup: 6 steps straight against 3 + save + restore (a fresh model and
    state, ``--resume``) + 3; a repeat of the straight run reads the
    card's own run-to-run spread."""
    from repro_torch.launch import train as train_launch
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import data as data_mod
    from repro_torch.training.train_step import state_tree

    def run(argv, hi):
        args = train_launch.parse_args([
            "--arch", MAMBA, "--steps", "6", "--seq-len", str(TRAIN_S),
            "--global-batch", str(TRAIN_B), "--device", "cuda", *argv])
        model, _, state, start, step_fn, dcfg = train_launch.setup(args)
        out = []
        for i in range(start, hi):
            state, m = step_fn(state, data_mod.batch_at_step(dcfg, i))
            out.append(float(m["loss"]))
        return model, state, start, out

    _, _, _, direct = run([], 6)
    _, _, _, again = run([], 6)
    model, state, _, first = run([], 3)
    t0 = time.monotonic()
    ckpt.save(tmp, 3, state_tree(model, state, device="cpu"))
    save_s = time.monotonic() - t0
    del model, state
    t0 = time.monotonic()
    _, state, start, resumed = run(["--resume", "--ckpt-dir", tmp], 6)
    restore_s = time.monotonic() - t0
    diff = abs(direct[-1] - resumed[-1])
    fails = []
    if start != 3 or int(state["opt"]["step"]) != 6 or \
            diff > TRAIN_RESTART_TOL:
        fails.append(f"restart: start {start}, diff {diff}")
    emit("train_restart", card=card["nvidia_smi"], arch=MAMBA,
         direct=direct, direct_again=again, first_3=first, resumed=resumed,
         resumed_from=start, abs_diff=diff,
         run_to_run_abs_diff=abs(direct[-1] - again[-1]),
         deterministic_algorithms=torch.are_deterministic_algorithms_enabled(),
         save_s=save_s, setup_and_restore_s=restore_s,
         checkpoint_bytes=sum(os.path.getsize(os.path.join(d, f))
                              for d, _, fs in os.walk(tmp) for f in fs),
         failures=fails)
    return fails


def phase_train(torch, card, seed: int) -> None:
    """The training path: checks at two fp32 layers, full-depth bf16
    training, and a restart through a checkpoint."""
    import shutil
    import tempfile
    t0 = time.monotonic()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    fails = _train_checks(torch, card, seed)
    torch.cuda.empty_cache()
    fails += _train_full(torch, card)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        fails += _train_restart(torch, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    emit("train_phase", card=card["nvidia_smi"], resident_bytes_before=resident,
         phase_host_wall_s=time.monotonic() - t0, failures=fails)
    if fails:
        raise AssertionError("train: " + "; ".join(fails))


# ---------------------------------------------------------------------------
SHARD_MESH = (("data", 1), ("model", 1))   # one card: the 1x1 mesh
SHARD_TRAIN_STEPS = 3
SHARD_LOSS_RTOL = 1e-3


def _comm_counts(mode) -> dict:
    return {str(op): n for op, n in mode.get_comm_counts().items()}


def _device_busy_ms(prof) -> float:
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def _shard_serve_way(torch, model, prompts, probe, busy_of) -> dict:
    """One way (with or without the policy) of the shard phase's serve:
    the probe's first-step logits, the serve batch through Batcher ->
    Engine with the launch counts set to 0 just before it and read just
    after, then one more batch of the probe under the profiler for the
    device's idle share and one under ``CommDebugMode`` for the
    collectives DTensor issues (a dispatch mode: it slows every op, so it
    stays out of the timed batches)."""
    import numpy as np
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.serving.batcher import Batcher, ServeRequest
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.sharding.policy import whole

    eng = Engine(model, EngineConfig(max_batch=SERVE_BATCH,
                                     max_seq=SERVE_MAX_SEQ))
    S = max(len(p) for p in prompts)
    eng.generate(np.zeros((SERVE_BATCH, S), np.int32), max_new=2)  # warm-up
    tokens = torch.as_tensor(probe, device=model.device)
    first = whole(eng.prefill(tokens)[0]).float()
    torch.cuda.synchronize()
    clock = [0.0]
    batcher = Batcher(eng, timeout_ms=1e9, max_new=SERVE_NEW,
                      clock=lambda: clock[0])
    for i, p in enumerate(prompts):
        batcher.submit(ServeRequest(i, p, deadline_s=1e9, submitted_s=0.0))
    mods = {"flash_attention": fmod, "decode_attention": dmod,
            "ssd_scan": smod, "quant_matmul": qmod}
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    done, walls = [], []
    while batcher.queue:
        t0 = time.monotonic()
        served = batcher.pump()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        if not served:
            raise AssertionError("shard: the batcher launched nothing")
        done += served
    launches = {name: mod.launches for name, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.generate(probe, max_new=SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy = busy_of(prof)
    with CommDebugMode() as comms:
        eng.generate(probe, max_new=SERVE_NEW)
    results = [r.result for r in sorted(done, key=lambda r: r.req_id)]
    return {"decode_mode": eng.decode_mode, "batches": len(walls),
            "wall_s_per_batch": walls, "launches": launches,
            "collectives_per_batch": _comm_counts(comms),
            "peak_bytes": peak, "profiled_batch_wall_s": wall,
            "profiled_device_busy_ms": busy,
            "idle_share": 1.0 - busy / 1e3 / wall,
            "_results": results, "_first": first}


def _shard_serve(torch, card, name: str, mesh, seed: int,
                 busy_of=_device_busy_ms) -> dict:
    """A model served without a policy and then with the decode-kind
    policy on the mesh, on the same weights: tokens must be identical, the
    first-step logits within LOGITS_TOL, every kernel's launches equal."""
    import numpy as np
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models import Model
    from repro_torch.models.kvcache import num_attn_applications
    from repro_torch.sharding.policy import make_policy

    model = _model(torch, name)
    arch = model.arch
    prompts = _serve_prompts(seed, arch.vocab_size)
    S = max(len(p) for p in prompts)
    probe = np.random.default_rng(3).integers(
        0, arch.vocab_size, size=(SERVE_BATCH, S)).astype(np.int32)
    plain = _shard_serve_way(torch, model, prompts, probe, busy_of)
    policy = make_policy(arch, ShapeConfig("serve", SERVE_MAX_SEQ,
                                           SERVE_BATCH, "decode"), mesh)
    sharded_model = Model(arch, device=model.device, dtype=model.dtype,
                          policy=policy)
    sharded_model.load_state_dict(model.state_dict())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    sharded = _shard_serve_way(torch, sharded_model, prompts, probe, busy_of)
    from torch.distributed.tensor import DTensor
    placed = sum(isinstance(p, DTensor) for p in sharded_model.parameters())
    n_params = len(list(sharded_model.parameters()))
    del sharded_model
    gc.collect()
    torch.cuda.empty_cache()
    a, b = plain.pop("_first"), sharded.pop("_first")
    rel = float((a - b).abs().max() / a.abs().max())
    same_tokens = all(np.array_equal(x, y) for x, y in
                      zip(plain.pop("_results"), sharded.pop("_results")))
    n_attn = num_attn_applications(arch)
    n_ssm = arch.num_layers if arch.ssm is not None else 0
    expect = {"flash_attention": n_attn * plain["batches"],
              "decode_attention": n_attn * plain["batches"] * (SERVE_NEW - 1),
              "ssd_scan": n_ssm * plain["batches"], "quant_matmul": 0}
    fails = []
    if not same_tokens:
        fails.append(f"{name}: tokens differ with the policy")
    if not rel < LOGITS_TOL:
        fails.append(f"{name}: first-step logits {rel} >= {LOGITS_TOL}")
    if not plain["launches"] == sharded["launches"] == expect:
        fails.append(f"{name}: launches {plain['launches']} / "
                     f"{sharded['launches']} != {expect}")
    if placed != n_params:
        fails.append(f"{name}: {placed} of {n_params} parameters placed")
    emit("shard_serve", card=card["nvidia_smi"], arch=arch.name,
         mesh=dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
         attn_mode=policy.attn_mode, rules=policy.rules,
         parameters_placed=placed, tokens_identical=same_tokens,
         first_logits_rel_err=rel, logits_tol=LOGITS_TOL,
         expected_launches=expect, plain=plain, sharded=sharded,
         failures=fails)
    return {"failures": fails, "launches": sharded["launches"]}


def _shard_train_way(torch, arch, policy, device: str) -> dict:
    """SHARD_TRAIN_STEPS steps of granite-3-2b at full width in bf16 on
    the plain attention (the launcher's setup, with ``policy``), then one
    more under ``CommDebugMode`` for the collectives of a step."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.models import Model
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    torch.cuda.reset_peak_memory_stats()
    model = Model(arch, device=device, impl="plain", dtype=torch.bfloat16,
                  policy=policy)
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=min(20, TRAIN_STEPS // 5),
                          total_steps=TRAIN_STEPS)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(0), cfg)
    step_fn = make_train_step(model, cfg)
    dcfg = data_mod.for_arch(arch, TRAIN_S, TRAIN_B)
    losses, walls = [], []
    for i in range(SHARD_TRAIN_STEPS):
        batch = data_mod.batch_at_step(dcfg, i)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    with CommDebugMode() as comms:
        state, _ = step_fn(state, data_mod.batch_at_step(
            dcfg, SHARD_TRAIN_STEPS))
    out = {"losses": losses, "step_s": walls,
           "collectives_per_step": _comm_counts(comms), "peak_bytes": peak}
    del model, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_shard(torch, card, seed: int, device: str = "cuda",
                backend: str = "nccl", busy_of=_device_busy_ms) -> dict:
    """The sharding substrate on the card's 1x1 mesh: qwen2-7b and
    mamba2-130m served with and without the decode policy, granite-3-2b
    trained with and without the training policy (module docstring)."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.policy import make_policy
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="shard_")
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(SHARD_MESH, device_type=device)
        fails, launches = [], {}
        for name in (QWEN, MAMBA):
            got = _shard_serve(torch, card, name, mesh, seed, busy_of)
            fails += got["failures"]
            launches[name] = got["launches"]
        arch = get_arch(GRANITE)
        plain = _shard_train_way(torch, arch, None, device)
        policy = make_policy(arch, ShapeConfig("cli", TRAIN_S, TRAIN_B,
                                               "train"), mesh, training=True)
        sharded = _shard_train_way(torch, arch, policy, device)
        rel = max(abs(a - b) / abs(a) for a, b in
                  zip(plain["losses"], sharded["losses"]))
        if not rel <= SHARD_LOSS_RTOL:
            fails.append(f"train: losses {plain['losses']} / "
                         f"{sharded['losses']} differ by {rel}")
        emit("shard_train", card=card["nvidia_smi"], arch=arch.name,
             batch=TRAIN_B, seq=TRAIN_S, rules=policy.rules,
             max_loss_rel_diff=rel, loss_rtol=SHARD_LOSS_RTOL, plain=plain,
             sharded=sharded)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("shard_phase", card=card["nvidia_smi"],
         phase_host_wall_s=time.monotonic() - t0, failures=fails)
    if fails:
        raise AssertionError("shard: " + "; ".join(fails))
    return launches


# ---------------------------------------------------------------------------
DRYRUN_ARGS_RTOL = 0.01    # dry-run argument bytes against the card's
DRYRUN_PRODUCTION = (("qwen2-7b", "decode_32k", "pod"),
                     ("llama4-scout-17b-a16e", "train_4k", "pod"))
DRYRUN_WAIT_S = 600.0      # the production cells' subprocesses
DRYRUN_REPS = 3            # timed steps of each card cell


def _dryrun_start(cells, tmp: str) -> list:
    """One ``python -m repro_torch.launch.dryrun`` per production cell,
    all started together, with no card visible: they count on ``meta``
    over a ``fake`` group (a second default group cannot live beside this
    process's NCCL one)."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for cell in cells:
        stem = os.path.join(tmp, "__".join(cell))
        log = open(stem + ".log", "w")
        arch, shape, mesh = cell
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out",
             stem + ".json"], env=env, stdout=log, stderr=subprocess.STDOUT)
        procs.append((cell, p, stem, log, time.monotonic()))
    return procs


def _dryrun_finish(card, procs, deadline: float) -> list:
    """Wait for the production cells (killing any past ``deadline``) and
    print each record's roofline row, memory, collectives and seconds."""
    from repro_torch.launch.roofline import PRESET, analyze_record
    fails = []
    for cell, p, stem, log, t0 in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
        wall = time.monotonic() - t0
        rec = {"ok": False, "error": "no record"}
        if os.path.exists(stem + ".json"):
            with open(stem + ".json") as f:
                rec = json.load(f)
        if p.returncode != 0 or not rec.get("ok"):
            with open(stem + ".log") as f:
                tail = f.read()[-1500:]
            fails.append(f"{' x '.join(cell)}: rc {p.returncode}, "
                         f"{rec.get('error')}; {tail}")
        row = analyze_record(rec) or {}
        emit("dryrun_production", card=card["nvidia_smi"], cell=cell,
             ok=bool(rec.get("ok")), returncode=p.returncode,
             subprocess_wall_s=wall, build_s=rec.get("build_s"),
             count_s=rec.get("count_s"), chips=rec.get("chips"),
             attn_mode=rec.get("attn_mode"),
             policy_notes=rec.get("policy_notes"), cost=rec.get("cost"),
             memory=rec.get("memory"), collectives=rec.get("collectives"),
             collective_counts=rec.get("collective_counts"),
             roofline_preset=PRESET,
             roofline={k: row.get(k) for k in (
                 "compute_s", "memory_s", "collective_s", "dominant",
                 "step_time_bound_s", "roofline_fraction",
                 "useful_ratio_6nd", "useful_ratio_fwd")})
    return fails


def _dryrun_card(torch, card, mesh, label: str, arch, shape, kw: dict,
                 base: int, setup, expect: dict) -> list:
    """One card cell: the meta dry-run of ``build_step(arch, shape, mesh,
    **kw)``, then the same step on the card.  ``setup()`` allocates the
    card's step and returns ``(fn, args, timed)``: ``fn(*args)`` is the
    step on the plain versions without a policy, counted by the same
    mode; ``timed()`` runs the timed step once.  The FLOPs must be equal
    and the argument bytes within DRYRUN_ARGS_RTOL of the card's
    allocation over ``base``; ``timed``'s launches are set to 0 just
    before its first run and read just after (``expect``).  The bound is
    that of the path ``timed`` runs: the dry-run's kernel-path count
    where it launches kernels, its plain count where it launches none."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.launch import dryrun
    t0 = time.monotonic()
    fn, args, policy = dryrun.build_step(arch, shape, mesh, **kw)
    meta = dryrun.count_step(fn, args, comm_debug=True)
    del fn, args
    meta_s = time.monotonic() - t0
    fn, args, timed = setup()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    real = dryrun.count_step(fn, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    timed()                                   # warm-up
    torch.cuda.synchronize()
    walls, launches = [], None
    mods = {"flash_attention": fmod, "decode_attention": dmod}
    for _ in range(DRYRUN_REPS):
        for mod in mods.values():
            mod.launches = 0
        t1 = time.monotonic()
        timed()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t1)
        if launches is None:
            launches = {k: mod.launches for k, mod in mods.items()}
    del fn, args, timed
    wall = sorted(walls)[len(walls) // 2]
    _, active = arch.param_count()
    model_flops = (6.0 if shape.kind == "train" else 2.0) * active * \
        shape.tokens
    plain_compute_s = meta["flops"] / PEAK_FLOPS["bfloat16"]
    plain_memory_s = meta["bytes"] / PEAK_BYTES_S
    path = "kernel" if any(expect.values()) else "plain"
    timed_count = meta["kernel_path"] if path == "kernel" else meta
    compute_s = timed_count["flops"] / PEAK_FLOPS["bfloat16"]
    memory_s = timed_count["bytes"] / PEAK_BYTES_S
    bound = max(compute_s, memory_s)
    mem = meta["memory"]
    args_err = abs(mem["argument_size_in_bytes"] - allocated) / allocated
    fails = []
    if meta["flops"] != real["flops"]:
        fails.append(f"{label}: dry-run FLOPs {meta['flops']} != the "
                     f"card step's {real['flops']}")
    if not args_err <= DRYRUN_ARGS_RTOL:
        fails.append(f"{label}: argument bytes {mem['argument_size_in_bytes']}"
                     f" vs {allocated} allocated ({args_err})")
    if launches != expect:
        fails.append(f"{label}: launches {launches} != {expect}")
    emit("dryrun_cell", card=card["nvidia_smi"], cell=label,
         arch=arch.name, kind=shape.kind, batch=shape.global_batch,
         seq=shape.seq_len, build_step_kw=kw, attn_mode=policy.attn_mode,
         dryrun_s=meta_s, flops=meta["flops"], card_flops=real["flops"],
         bytes=meta["bytes"], card_bytes=real["bytes"],
         kernel_path=meta["kernel_path"], timed_path=path,
         collectives=meta["collectives"],
         comm_debug_counts=meta["comm_debug_counts"], memory=mem,
         card_allocated_bytes=allocated, argument_bytes_rel_err=args_err,
         args_rtol=DRYRUN_ARGS_RTOL,
         predicted_peak_bytes=mem["peak_memory_in_bytes"],
         card_peak_bytes_plain_step=peak,
         predicted_temp_bytes=mem["temp_size_in_bytes"],
         launches=launches, expected_launches=expect, step_wall_s=walls,
         median_wall_s=wall, compute_s=compute_s, memory_s=memory_s,
         bound_s=bound, bound_by="operations" if compute_s >= memory_s
         else "bytes", measured_over_bound=wall / bound,
         plain_path_compute_s=plain_compute_s,
         plain_path_memory_s=plain_memory_s,
         plain_path_bound_s=max(plain_compute_s, plain_memory_s),
         model_flops=model_flops,
         roofline_fraction=model_flops / (wall * PEAK_FLOPS["bfloat16"]),
         failures=fails)
    return fails


def phase_dryrun(torch, card, seed: int, device: str = "cuda",
                 backend: str = "nccl", production=DRYRUN_PRODUCTION) -> None:
    """The dry-run (``launch/dryrun.py``, ``roofline.py``) held against the
    card's own steps: three card cells counted on ``meta`` over the 1x1
    mesh and then run (module docstring); then the production cells in
    subprocesses on a ``fake`` group."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.models.kvcache import num_attn_applications
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    procs, fails = [], []
    own_group = not dist.is_initialized()
    try:
        if own_group:
            dist.init_process_group(backend, store=dist.FileStore(
                os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        mesh = make_host_mesh(SHARD_MESH, device_type=device)
        qwen = get_arch(QWEN)
        S = max(len(p) for p in _serve_prompts(seed, qwen.vocab_size))
        n = num_attn_applications(qwen)
        gen = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        model = Model(qwen, device=device, impl="plain").init(gen)

        def serving(step, *inputs):
            """``step(params, *inputs)`` counted on the plain versions,
            timed on the kernels (the model's ``impl`` switched)."""
            params = dict(model.named_parameters())

            def timed():
                model.impl = "kernel"
                step(params, *inputs)
            model.impl = "plain"
            return step, (params,) + inputs, timed

        def prefill_setup():
            tokens = torch.randint(0, qwen.vocab_size, (SERVE_BATCH, S),
                                   generator=gen, device=device)
            return serving(lambda p, t: model.prefill(t), tokens)

        fails += _dryrun_card(
            torch, card, mesh, "qwen2-7b prefill", qwen,
            ShapeConfig("serve_prefill", S, SERVE_BATCH, "prefill"), {},
            base, prefill_setup, {"flash_attention": n,
                                  "decode_attention": 0})

        def decode_setup():
            cache = model.init_cache(SERVE_BATCH, S + SERVE_NEW)
            tokens = torch.randint(0, qwen.vocab_size, (SERVE_BATCH, 1),
                                   generator=gen, device=device)
            return serving(lambda p, c, pos, t: model.decode_step(c, pos, t),
                           cache, S, tokens)

        fails += _dryrun_card(
            torch, card, mesh, "qwen2-7b decode step", qwen,
            ShapeConfig("serve_decode", S + SERVE_NEW, SERVE_BATCH,
                        "decode"), {"cache_len": S}, base, decode_setup,
            {"flash_attention": 0, "decode_attention": n})
        del model
        gc.collect()
        torch.cuda.empty_cache()

        granite = get_arch(GRANITE)
        base = torch.cuda.memory_allocated()

        def train_setup():
            m = Model(granite, device=device, impl="plain")
            cfg = opt.AdamWConfig()
            state = init_train_state(m, gen, cfg)
            tokens = torch.randint(0, granite.vocab_size, (TRAIN_B, TRAIN_S),
                                   generator=gen, device=device)
            batch = {"tokens": tokens, "labels": tokens.clone()}
            step = make_train_step(m, cfg)
            return step, (state, batch), lambda: step(state, batch)

        fails += _dryrun_card(
            torch, card, mesh, "granite-3-2b train step", granite,
            ShapeConfig("train", TRAIN_S, TRAIN_B, "train"),
            {"remat": "none", "microbatches": 1}, base, train_setup,
            {"flash_attention": 0, "decode_attention": 0})
        gc.collect()
        torch.cuda.empty_cache()
        # after the card's timed steps: the counts load the host's cores
        procs = _dryrun_start(production, tmp)
        fails += _dryrun_finish(card, procs, time.monotonic() + DRYRUN_WAIT_S)
    finally:
        for _, p, _, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("dryrun_phase", card=card["nvidia_smi"],
         phase_host_wall_s=time.monotonic() - t0, failures=fails)
    if fails:
        raise AssertionError("dryrun: " + "; ".join(fails))


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serve phase's prompt lengths/tokens")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch, card)
    launches = {}                 # per served model, per kernel
    # (model, layers of its fp32 greedy check; None: no model phase)
    for name, small_layers in ((QWEN, 2), (ZAMBA, 7), (MAMBA, None)):
        model = (phase_model(torch, card, name, small_layers) if small_layers
                 else _model(torch, name))
        launches[name], eng, S = phase_serve(torch, card, model, args.seed)
        phase_profile(torch, card, eng, S)
        if name == QWEN:
            int8_launches = phase_int8(torch, card, model, args.seed)
        del model, eng
        torch.cuda.empty_cache()
    launches.update(phase_moe(torch, card, args.seed))
    planned = phase_plan(torch, card, args.seed)
    compound_launches = phase_compound(torch, card, args.seed, planned)
    phase_control(torch, card, args.seed, planned)
    phase_gateway(torch, card, args.seed, planned)
    del planned                   # the compound engines: the card for training
    gc.collect()
    phase_train(torch, card, args.seed)
    phase_shard(torch, card, args.seed)
    phase_dryrun(torch, card, args.seed)
    for row in rows:
        if row["name"] == "quant_matmul":   # no serve run calls it
            row["launches"] = int8_launches[row["model"]][row["layout"]]
            row["launches_from"] = "int8 phase"
            continue
        if row["model"] in (GEMMA, GRANITE):  # served in the compound phase
            # 0 where the plan serves that arch no call
            row["launches"] = compound_launches.get(row["model"], {}).get(
                row["name"], 0)
            row["launches_from"] = "compound phase"
            continue
        # the serve run of the model row's shape
        row["launches"] = launches[row["model"]][row["name"]]
        row["launches_by_model"] = {m: c[row["name"]]
                                    for m, c in launches.items()}
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
