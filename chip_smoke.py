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
              mamba2-130m, with the kernels' launch counts set to 0 just
              before each and checked just after: one flash launch per
              attention application per prefill, one decode launch per
              application per decode step, one SSD launch per Mamba2 layer
              per prefill (qwen2 28/420/0, zamba2 14/210/81, mamba2 0/0/24).
6. profile -- for each served model, prefill and decode-step times at the
              serve batch's padded shape on the host clock, then under
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
8. compound -- the main path through the port's own ClusterRuntime: the
              social_media app (ingest gemma-2b, classify granite-3-2b,
              caption qwen2-7b, one instance each at batch 8, a hand-built
              plan with measured service times) on EngineBackend at full
              width in bf16, Poisson 4 rps for 10 s of scenario time from
              --seed, deadlines at 4x the app SLO; every root arrival ends
              completed or dropped, and each arch's flash and decode
              launches are exact.

The second-to-last line is ``{"kernels": [...]}``, one row per kernel at
its main serving shape (four for quant_matmul: prefill and decode, each
on both layouts of w_q; the
attention kernels also at gemma-2b's and granite-3-2b's compound shapes),
``launches`` from the serve run of the model whose shape the row names
(``launches_by_model`` gives all three), from the compound phase for
gemma-2b and granite-3-2b, or for quant_matmul from the int8 phase at that
shape; the last is
``{"ok": true, "device": {...}}``.  Exits 2 with no result when
there is no CUDA device or no ``src/repro_torch`` beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
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
    from repro_torch.serving.engine import Engine, EngineConfig

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

    small = _model(torch, name, num_layers=small_layers, dtype=torch.float32,
                   seed=2)
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
    return model


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


def phase_profile(torch, card, eng, S: int) -> None:
    """Where a serve batch's time goes, at the serve phase's padded shape:
    the prefill and each decode step on the host clock (synchronised),
    then the same prefill and steps again under torch.profiler, device
    time summed over kernels only (not over the ops that launch them)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = eng.model
    prompts = np.random.default_rng(3).integers(
        0, model.arch.vocab_size, size=(SERVE_BATCH, S)).astype(np.int32)
    tokens = torch.as_tensor(prompts, device=model.device)

    def prefill():
        logits, cache = model.prefill(tokens, max_seq=SERVE_MAX_SEQ)
        return logits[:, -1].argmax(-1, keepdim=True), cache

    def decode(tok, cache, i):
        logits, cache = model.decode_step(cache, S + i, tok)
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

    def kernels(prof):
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
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

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as p_prefill:
        tok, cache = prefill()
        torch.cuda.synchronize()
    with profile(activities=acts) as p_decode:
        for i in range(SERVE_NEW - 1):
            tok = decode(tok, cache, i)
        torch.cuda.synchronize()
    busy_p, top_p = kernels(p_prefill)
    busy_d, top_d = kernels(p_decode)
    decode_s = sum(steps)
    emit("profile", card=card["nvidia_smi"], arch=model.arch.name,
         padded_prompt_len=S,
         prefill_s=prefill_s, decode_step_s=steps, decode_total_s=decode_s,
         prefill_device_busy_ms=busy_p,
         prefill_idle_share=1.0 - busy_p / 1e3 / prefill_s,
         decode_device_busy_ms=busy_d,
         decode_idle_share=1.0 - busy_d / 1e3 / decode_s,
         prefill_kernels=top_p, decode_kernels=top_d)


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
        self.dispatches.append((server.tup.task, len(batch), service_s))


class _PerArch:
    """An ExecutionBackend around another that files the kernel launches
    of each service call under the arch it served (a call is synchronous,
    so the counters' change during it is its own)."""

    def __init__(self, inner, mods):
        self.inner, self.mods = inner, mods
        self.graphs, self.calls, self.launches = {}, {}, {}

    def bind(self, graph, config, app=""):
        self.graphs[app] = graph
        self.inner.bind(graph, config, app)

    def on_capacity_change(self, servers):
        self.inner.on_capacity_change(servers)

    def service_s(self, server, batch, now_s, rng):
        graph = self.graphs[server.app]
        arch = graph.tasks[server.tup.task].variant(server.tup.variant).arch
        before = {k: m.launches for k, m in self.mods.items()}
        service = self.inner.service_s(server, batch, now_s, rng)
        per = self.launches.setdefault(arch, dict.fromkeys(self.mods, 0))
        for k, m in self.mods.items():
            per[k] += m.launches - before[k]
        self.calls[arch] = self.calls.get(arch, 0) + 1
        return service


COMPOUND_APP = "social_media"
COMPOUND_PLAN = {"ingest": "gemma-2b", "classify": "granite-3-2b",
                 "caption": "qwen2-7b"}
COMPOUND_BATCH, COMPOUND_RPS, COMPOUND_S = 8, 4.0, 10.0
# Deadlines at 4x the app's 700 ms at least: one eager full-width hop of
# 16 new tokens takes about half a second on the card, so at 1x the
# early-drop rule drops every request at ingest and no leaf is served.
# An eager service is bound by the host, whose speed varies from machine
# to machine by 2x and more (granite-3-2b's batch took 0.64-1.30 s), so
# the deadline also leaves COMPOUND_PATH_SLACK times the longest path's
# service measured just before the run; with less than about 2x every
# root may be dropped at ingest.  Attainment within the app's own SLO is
# reported beside it.
COMPOUND_SLO_SCALE = 4.0
COMPOUND_PATH_SLACK = 3.0


def phase_compound(torch, card, seed: int) -> dict:
    """The main path through the port's own control plane: the
    social_media app served by ``repro_torch.runtime.ClusterRuntime`` on
    ``EngineBackend(reduced=False)``, full-width gemma-2b, granite-3-2b and
    qwen2-7b in bf16, one instance each at batch 8, under Poisson traffic
    with deadlines at COMPOUND_SLO_SCALE times the app's SLO, or at
    COMPOUND_PATH_SLACK times the longest path's measured service where
    that is longer.
    The plan is built by hand; each tuple's latency is one measured
    service of a full batch (after the engine's warm-up), so the
    runtime's early drop works from what the card does.  Before that, one
    full-batch service per arch runs with every kernel call held against
    its plain version on the same inputs (``_each_call_checked``), at the
    shapes this path gives the kernels.  Every root arrival must end as
    completed or dropped at each of its leaves, the queues must drain,
    and each arch's launches must be one flash launch per layer per
    service call and one decode launch per layer per decode step.  Returns
    the launches per arch and kernel."""
    import numpy as np
    from types import SimpleNamespace
    from repro_torch.core.apps import get_app
    from repro_torch.core.milp import PlanConfig, TupleVar
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.runtime import ClusterRuntime, EngineBackend, Scenario

    t_phase = time.monotonic()
    graph = get_app(COMPOUND_APP)
    leaves = len(graph.paths)
    if any(f != 1.0 for f in graph.mult.values()):
        raise AssertionError("the per-root accounting assumes fan-out 1")
    backend = EngineBackend(reduced=False, max_batch=COMPOUND_BATCH,
                            max_seq=512, prompt_len=256, max_new=SERVE_NEW)
    backend.bind(graph, None)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed)
    counts, tuples, profiled, archs, checked, bad = {}, {}, {}, {}, {}, {}
    for task, variant in COMPOUND_PLAN.items():
        v = graph.tasks[task].variant(variant)
        probe = SimpleNamespace(app="", tup=TupleVar(
            task, variant, "h100", COMPOUND_BATCH, latency_ms=0.0,
            throughput=0.0, cost=1, accuracy=v.accuracy))
        full = [None] * COMPOUND_BATCH
        backend.service_s(probe, full, 0.0, rng)      # builds and warms
        archs[v.arch] = backend._engines[v.arch].model.arch
        found = {}
        with _each_call_checked(torch, found):
            backend.service_s(probe, full, 0.0, rng)
        checked[v.arch] = {k: {"calls": n, "max_abs_err": worst,
                               "out_of_tol": out}
                           for k, (n, worst, out) in found.items()}
        wrong = _calls_in_tolerance(archs[v.arch], found, 1, SERVE_NEW - 1)
        if wrong:
            bad[v.arch] = wrong
        service = backend.service_s(probe, full, 0.0, rng)
        profiled[variant] = service
        key = (task, variant, "h100", COMPOUND_BATCH)
        tuples[key] = TupleVar(task, variant, "h100", COMPOUND_BATCH,
                               latency_ms=service * 1e3,
                               throughput=COMPOUND_BATCH / service, cost=1,
                               accuracy=v.accuracy)
        counts[key] = 1
    cfg = PlanConfig(graph=graph, counts=counts, tuples=tuples,
                     demand={t: COMPOUND_RPS for t in graph.tasks})
    longest_path_s = max(sum(profiled[COMPOUND_PLAN[t]] for t in path)
                         for path in graph.paths)
    slo_scale = max(COMPOUND_SLO_SCALE, COMPOUND_PATH_SLACK * longest_path_s
                    / (graph.slo_latency_ms / 1e3))
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
        layers = archs[arch_name].num_layers
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
    batches = {}
    for task, n, _ in ledger.dispatches:
        batches.setdefault(task, []).append(n)
    emit("compound", card=card["nvidia_smi"], app=COMPOUND_APP,
         plan={t: v for t, v in COMPOUND_PLAN.items()},
         batch=COMPOUND_BATCH, rate_rps=COMPOUND_RPS,
         scenario_s=COMPOUND_S, seed=seed,
         profiled_service_s_batch8=profiled,
         checked_vs_plain=checked, checked_out_of_tol=bad,
         root_arrivals=ledger.arrivals, leaves_per_root=leaves,
         completions=m.completions, missed=m.missed, dropped=m.dropped,
         drops=ledger.drops, queued_at_end=left, accounted=accounted,
         longest_path_service_s=longest_path_s, slo_scale=slo_scale,
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
    compound_launches = phase_compound(torch, card, args.seed)
    for row in rows:
        if row["name"] == "quant_matmul":   # no serve run calls it
            row["launches"] = int8_launches[row["model"]][row["layout"]]
            row["launches_from"] = "int8 phase"
            continue
        if row["model"] in (GEMMA, GRANITE):  # served in the compound phase
            # an arch whose every request was dropped served no call
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
