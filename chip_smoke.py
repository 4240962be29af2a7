#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure exits non-zero:

1. device  -- the card's name and power limit (nvidia-smi) and the count.
2. build   -- nvcc builds every kernel source of the port, one process per
              source, all started together; ptxas' registers, shared memory
              and spills per kernel.
3. kernels -- each kernel against its plain PyTorch version on the card
              over a sweep of head dims, GQA groups, dtypes, causal flags
              and ragged lengths, including the qwen2-7b serving shapes;
              at those shapes the kernel, plain and library times (CUDA
              events, L2 flushed before each launch) and the roofline bound.
4. model   -- full-width qwen2-7b in bf16 (random weights from a seeded
              generator): prefill logits through the kernels against the
              same model's plain attention; then, at full widths but 2
              layers in fp32, identical greedy tokens from both paths.
5. serve   -- the main path: 8 requests (prompt lengths 256-512 drawn from
              --seed, 16 new tokens each) through Batcher -> Engine on
              full-width qwen2-7b, with the kernels' launch counts set to 0
              just before and checked just after (28 layers: one flash
              launch per layer per prefill, one decode launch per layer per
              decode step).
6. profile -- prefill and decode-step times at the serve batch's padded
              shape on the host clock, then under torch.profiler: device
              time by kernel and the device's idle share in each.

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Exits 2 with no result when there is
no CUDA device or no ``src/repro_torch`` beside this script.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:14-15

QWEN = "qwen2-7b"
SERVE_BATCH, SERVE_MAX_SEQ, SERVE_NEW = 8, 1024, 16
PROMPT_LENS = (256, 512)


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


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.monotonic()
    logs = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "ptxas info" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit("build", seconds=round(time.monotonic() - t0, 2), ptxas=ptxas)


# ---------------------------------------------------------------------------
def _max_err(torch, out, want, tol: float):
    """Max |out - want| and whether every element is within
    atol + rtol * |want| with atol = rtol = tol."""
    o, w = out.float(), want.float()
    err = (o - w).abs()
    ok = bool(torch.isfinite(o).all()) and bool(
        (err <= tol + tol * w.abs()).all())
    return float(err.max()), ok


def _time_ms(torch, fn, flush, iters: int = 20) -> float:
    """Mean device time of one ``fn`` call over ``iters`` calls, each
    between two CUDA events with the L2 cache flushed before it, after two
    warm-up calls.

    A sleep kernel is queued first, so the host has queued every call
    before the card reaches the first: the events then bracket device work
    only, not the host's time to launch it.  If the sleep ended before the
    last call was queued, the card may have waited on the host, so the
    calls are timed again behind a sleep twice as long."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24                 # ~10 ms at 1.7 GHz
    for _ in range(6):
        torch.cuda._sleep(cycles)
        asleep = torch.cuda.Event()
        asleep.record()
        pairs = []
        for _ in range(iters):
            flush.zero_()
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


def phase_kernels(torch, card) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    failures, n_cases = [], 0
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}

    # flash: hd x G x causal x dtype, cycling through ragged (Sq, Skv)
    seqs = [(500, 500), (64, 192), (37, 37), (200, 333)]
    case = 0
    for hd in (64, 128, 256):
        for G in (1, 4, 7, 8):
            for causal in (True, False):
                for dname, dt in dtypes.items():
                    Sq, Skv = seqs[case % len(seqs)]
                    case += 1
                    B, KV = 2, 2
                    q = randn(B, Sq, KV * G, hd, dtype=dt)
                    k = randn(B, Skv, KV, hd, dtype=dt)
                    v = randn(B, Skv, KV, hd, dtype=dt)
                    out = flash_attention(q, k, v, causal=causal)
                    want = ref.flash_attention_ref(q, k, v, causal=causal)
                    err, ok = _max_err(torch, out, want, TOLS[dname])
                    n_cases += 1
                    worst["flash_attention"] = max(worst["flash_attention"],
                                                   err)
                    if not ok:
                        failures.append(dict(kernel="flash", hd=hd, G=G,
                                             causal=causal, dtype=dname,
                                             Sq=Sq, Skv=Skv, err=err))
    # decode: hd x G x fill x dtype on a ragged cache of 1000 positions
    for hd in (64, 128, 256):
        for G in (1, 4, 7, 8):
            for fill in (0.3, 1.0):
                for dname, dt in dtypes.items():
                    B, S, KV = 3, 1000, 2
                    cl = max(1, int(S * fill))
                    q = randn(B, 1, KV * G, hd, dtype=dt)
                    kc = randn(B, S, KV, hd, dtype=dt)
                    vc = randn(B, S, KV, hd, dtype=dt)
                    out = decode_attention(q, kc, vc, cl)
                    want = ref.decode_attention_ref(q, kc, vc, cl)
                    err, ok = _max_err(torch, out, want, TOLS[dname])
                    n_cases += 1
                    worst["decode_attention"] = max(
                        worst["decode_attention"], err)
                    if not ok:
                        failures.append(dict(kernel="decode", hd=hd, G=G,
                                             fill=fill, dtype=dname,
                                             cache_len=cl, err=err))
    torch.cuda.synchronize()
    emit("kernels_sweep", cases=n_cases, failures=failures,
         max_abs_err=worst)
    if failures:
        raise AssertionError(f"{len(failures)} kernel cases out of "
                             f"tolerance: {failures[:5]}")

    # the qwen2-7b serving shapes, bf16
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    B, S, H, KV, hd = SERVE_BATCH, 512, 28, 4, 128
    bf = torch.bfloat16
    q, k, v = (randn(B, S, H, hd, dtype=bf), randn(B, S, KV, hd, dtype=bf),
               randn(B, S, KV, hd, dtype=bf))
    out = flash_attention(q, k, v, causal=True)
    err_f, ok_f = _max_err(torch, out, ref.flash_attention_ref(q, k, v),
                           TOLS["bfloat16"])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = S * (S + 1) // 2                  # causal (query, key) pairs
    flop_f = 4.0 * B * H * hd * pairs
    bytes_f = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    bound_f, by_f = _bound(flop_f, bytes_f, "bfloat16")
    rows = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:86",
        shape=f"q [{B},{S},{H},{hd}] k/v [{B},{S},{KV},{hd}] bf16 causal",
        max_abs_err=max(err_f, worst["flash_attention"]),
        ms=_time_ms(torch, lambda: flash_attention(q, k, v), flush),
        plain_ms=_time_ms(torch, lambda: ref.flash_attention_ref(q, k, v),
                          flush),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush),
        bound_ms=bound_f, bound_by=by_f)]

    Smax, cl = SERVE_MAX_SEQ, 528
    q1 = randn(B, 1, H, hd, dtype=bf)
    kc, vc = randn(B, Smax, KV, hd, dtype=bf), randn(B, Smax, KV, hd, dtype=bf)
    out = decode_attention(q1, kc, vc, cl)
    err_d, ok_d = _max_err(torch, out,
                           ref.decode_attention_ref(q1, kc, vc, cl),
                           TOLS["bfloat16"])
    q1t = q1.transpose(1, 2)
    kct, vct = kc[:, :cl].transpose(1, 2), vc[:, :cl].transpose(1, 2)
    flop_d = 4.0 * B * H * hd * cl
    bytes_d = 2.0 * (2 * B * cl * KV * hd + 2 * q1.numel())
    bound_d, by_d = _bound(flop_d, bytes_d, "bfloat16")
    rows.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:65",
        shape=f"q [{B},1,{H},{hd}] caches [{B},{Smax},{KV},{hd}] bf16 "
              f"cache_len {cl}",
        max_abs_err=max(err_d, worst["decode_attention"]),
        ms=_time_ms(torch, lambda: decode_attention(q1, kc, vc, cl), flush),
        plain_ms=_time_ms(
            torch, lambda: ref.decode_attention_ref(q1, kc, vc, cl), flush),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            q1t, kct, vct, enable_gqa=True), flush),
        bound_ms=bound_d, bound_by=by_d))
    emit("kernels_serving_shapes", card=card["nvidia_smi"],
         rows=rows, ok=[ok_f, ok_d])
    if not (ok_f and ok_d):
        raise AssertionError(f"serving-shape kernels out of tolerance: "
                             f"flash {err_f}, decode {err_d}")
    return rows


# ---------------------------------------------------------------------------
def _qwen(torch, num_layers=None, dtype=None, seed: int = 0):
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    arch = get_arch(QWEN)
    if num_layers is not None:
        arch = arch.scaled(num_layers=num_layers)
    model = Model(arch, device="cuda", dtype=dtype or torch.bfloat16)
    return model.init(torch.Generator(device="cuda").manual_seed(seed))


def phase_model(torch, card):
    import numpy as np
    from repro_torch.serving.engine import Engine, EngineConfig

    model = _qwen(torch)
    arch = model.arch
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(
        rng.integers(0, arch.vocab_size, size=(SERVE_BATCH, 512)),
        device=model.device)
    model.attn_impl = "kernel"
    got, _ = model.prefill(tokens)
    model.attn_impl = "plain"
    want, _ = model.prefill(tokens)
    model.attn_impl = "kernel"
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(got).all())
    # A control reading of the same measure: the plain path with one wrong
    # attention (layer 0 not causal), to show what a broken kernel in one
    # layer of 28 would read against the 2e-2 limit.
    from repro_torch.kernels import ref
    plain, calls = ref.flash_attention_ref, [0]

    def broken(q, k, v, *, causal=True, scale=None):
        calls[0] += 1
        return plain(q, k, v, causal=causal and calls[0] > 1, scale=scale)

    model.attn_impl = "plain"
    ref.flash_attention_ref = broken
    try:
        bad, _ = model.prefill(tokens)
    finally:
        ref.flash_attention_ref = plain
        model.attn_impl = "kernel"
    control = float((bad - want).abs().max() / want.abs().max())
    emit("model_prefill", card=card["nvidia_smi"], arch=arch.name,
         params=sum(p.numel() for p in model.parameters()),
         logits_shape=list(got.shape), rel_err=rel, top1_agreement=top1,
         finite=finite, control_rel_err_layer0_not_causal=control,
         control_top1_agreement=float(
             (bad.argmax(-1) == want.argmax(-1)).float().mean()))
    if not (finite and rel < 2e-2):
        raise AssertionError(f"prefill logits: rel err {rel}, finite {finite}")

    small = _qwen(torch, num_layers=2, dtype=torch.float32, seed=2)
    prompts = rng.integers(0, arch.vocab_size,
                           size=(SERVE_BATCH, 300)).astype(np.int32)
    outs = {}
    for impl in ("kernel", "plain"):
        small.attn_impl = impl
        eng = Engine(small, EngineConfig(max_batch=SERVE_BATCH,
                                         max_seq=SERVE_MAX_SEQ))
        outs[impl] = eng.generate(prompts, max_new=SERVE_NEW)
    same = bool(np.array_equal(outs["kernel"], outs["plain"]))
    emit("model_greedy_fp32_2layer", card=card["nvidia_smi"],
         identical_tokens=same, tokens_kernel=outs["kernel"][0].tolist(),
         tokens_plain=outs["plain"][0].tolist())
    if not same:
        raise AssertionError("kernel and plain greedy tokens differ")
    del small
    torch.cuda.empty_cache()
    return model


def phase_serve(torch, card, model, seed: int) -> dict:
    import numpy as np
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.serving.batcher import Batcher, ServeRequest
    from repro_torch.serving.engine import Engine, EngineConfig

    rng = np.random.default_rng(seed)
    V, L = model.arch.vocab_size, model.arch.num_layers
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=SERVE_BATCH)
    eng = Engine(model, EngineConfig(max_batch=SERVE_BATCH,
                                     max_seq=SERVE_MAX_SEQ))
    eng.generate(np.zeros((SERVE_BATCH, int(lens.max())), np.int32),
                 max_new=2)                          # warm-up, not counted
    torch.cuda.synchronize()
    clock = [0.0]
    batcher = Batcher(eng, timeout_ms=1e9, max_new=SERVE_NEW,
                      clock=lambda: clock[0])
    for i, n in enumerate(lens):
        batcher.submit(ServeRequest(i, rng.integers(0, V, size=int(n))
                                    .astype(np.int32),
                                    deadline_s=1e9, submitted_s=0.0))
    torch.cuda.reset_peak_memory_stats()
    fmod.launches = 0
    dmod.launches = 0
    done, walls = [], []
    while batcher.queue:
        t0 = time.monotonic()
        served = batcher.pump()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        if not served:
            raise AssertionError("the batcher launched nothing")
        done += served
    counts = {"flash_attention": fmod.launches,
              "decode_attention": dmod.launches}
    n_batches = len(walls)
    expect = {"flash_attention": L * n_batches,
              "decode_attention": L * n_batches * (SERVE_NEW - 1)}
    results_ok = all(r.result is not None and r.result.shape == (SERVE_NEW,)
                     and int(r.result.min()) >= 0
                     and int(r.result.max()) < V for r in done)
    emit("serve", card=card["nvidia_smi"], arch=model.arch.name,
         requests=SERVE_BATCH, served=len(done), dropped=batcher.dropped,
         prompt_lens=lens.tolist(), batches=n_batches,
         wall_s_per_batch=walls,
         tokens_per_s=len(done) * SERVE_NEW / sum(walls),
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches=counts, expected_launches=expect)
    if len(done) != SERVE_BATCH or not results_ok:
        raise AssertionError(f"served {len(done)} of {SERVE_BATCH} "
                             f"(results ok: {results_ok})")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
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
        top = sorted(evs, key=lambda e: e.self_device_time_total,
                     reverse=True)[:8]
        return busy, [{"name": e.key[:90], "calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
                      for e in top]

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
    emit("profile", card=card["nvidia_smi"], padded_prompt_len=S,
         prefill_s=prefill_s, decode_step_s=steps, decode_total_s=decode_s,
         prefill_device_busy_ms=busy_p,
         prefill_idle_share=1.0 - busy_p / 1e3 / prefill_s,
         decode_device_busy_ms=busy_d,
         decode_idle_share=1.0 - busy_d / 1e3 / decode_s,
         prefill_kernels=top_p, decode_kernels=top_d)


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
    model = phase_model(torch, card)
    counts, eng, S = phase_serve(torch, card, model, args.seed)
    phase_profile(torch, card, eng, S)
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
