"""Generates the data-driven dry-run tables from
results/dryrun_torch/*.json (+ the baseline snapshot in
results/dryrun_torch_baseline/, when there is one).

PyTorch counterpart of ``repro.launch.report``: "fits" compares a rank's
net bytes with one H100's 80 GB (``hwspec.device.H100_SXM.hbm_bytes``),
and the hints name the port's levers (the flash and decode kernels,
``wgmma`` tiles, NCCL).

    PYTHONPATH=src python -m repro_torch.launch.report > /tmp/report.md
"""
import glob
import json
import os

from repro_torch.hwspec.device import H100_SXM
from repro_torch.launch.roofline import PRESET, fmt_s, load_all

RES = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results")
GB = 10 ** 9


def _records(sub: str):
    for p in sorted(glob.glob(os.path.join(RES, sub, "*.json"))):
        with open(p) as f:
            yield json.load(f)


def dryrun_table(mesh: str) -> str:
    rows = []
    cap = H100_SXM.hbm_bytes / GB
    for r in _records("dryrun_torch"):
        if r["mesh"] != mesh:
            continue
        if r.get("skipped"):
            rows.append(f"| {r['arch']} | {r['shape']} | SKIP (long_500k "
                        "needs sub-quadratic attention) | — | — | — |")
            continue
        if not r["ok"]:
            rows.append(f"| {r['arch']} | {r['shape']} | FAIL | — | — | — |")
            continue
        m = r["memory"]
        args, temp = m["argument_size_in_bytes"], m["temp_size_in_bytes"]
        out = m["output_size_in_bytes"]
        alias = m.get("alias_size_in_bytes", 0)
        net = (args + temp + out - alias) / GB
        fits = "yes" if net <= cap else "NO"
        rows.append(
            f"| {r['arch']} | {r['shape']} | OK "
            f"| {args/GB:.2f} + {temp/GB:.2f} | {net:.2f} | {fits} |")
    head = ("| arch | shape | step | args+temp GB/rank | net GB/rank | "
            f"fits {H100_SXM.name} {cap:g} GB |\n|---|---|---|---|---|---|")
    return head + "\n" + "\n".join(rows)


def roofline_table(mesh: str = "pod") -> str:
    rows = load_all(os.path.join(RES, "dryrun_torch"))
    lines = [
        f"roofline per rank on {PRESET}",
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL/counted | what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|",
    ]
    hints = {
        ("memory", "train"): "fused AdamW and attention backward "
                             "(bytes are an upper bound before fusion)",
        ("memory", "decode"): "the split-KV decode kernel on a sharded "
                              "cache (no gather); int8 KV cache",
        ("memory", "prefill"): "the flash kernel (the plain attention "
                               "counted here writes its S×S scores)",
        ("compute", "train"): "wgmma-aligned tiles; fewer remat "
                              "recomputes",
        ("compute", "prefill"): "causal block skipping in the flash kernel",
        ("compute", "decode"): "speculative/multi-token decode",
        ("collective", "train"): "overlap NCCL's gradient reduce with the "
                                 "backward; int8 gradient compression",
        ("collective", "prefill"): "context-parallel K/V gathers; an "
                                   "expert all-to-all island for MoE",
        ("collective", "decode"): "flash-decode over the sharded cache "
                                  "(log-sum-exp merge, no cache gather)",
    }
    for r in rows:
        if r["mesh"] != mesh:
            continue
        ratio = (r["useful_ratio_6nd"] if r["kind"] == "train"
                 else r["useful_ratio_fwd"])
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s']).strip()} "
            f"| {fmt_s(r['memory_s']).strip()} | "
            f"{fmt_s(r['collective_s']).strip()} | {r['dominant']} | "
            f"{ratio:.2f} | {hints.get((r['dominant'], r['kind']), '—')} |")
    return "\n".join(lines)


def before_after() -> str:
    """Collective-term comparison baseline vs final for every cell."""
    base = {}
    for r in _records("dryrun_torch_baseline"):
        if r.get("ok") and not r.get("skipped") and "extrapolation" in r:
            base[(r["arch"], r["shape"], r["mesh"])] = \
                r["extrapolation"]["est_collective_total"]
    if not base:
        return ("no baseline: results/dryrun_torch_baseline/ holds no "
                "record")
    lines = ["| cell | collective B/rank before | after | Δ |",
             "|---|---|---|---|"]
    for r in _records("dryrun_torch"):
        if not (r.get("ok") and not r.get("skipped")
                and "extrapolation" in r):
            continue
        key = (r["arch"], r["shape"], r["mesh"])
        if key not in base or r["mesh"] != "pod":
            continue
        b = base[key]
        a = r["extrapolation"]["est_collective_total"]
        if b <= 0:
            continue
        lines.append(f"| {key[0]} × {key[1]} | {b:.2e} | {a:.2e} | "
                     f"{a/b:.2f}x |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "dryrun"):
        print("### dry-run pod\n" + dryrun_table("pod"))
        print("\n### dry-run multipod\n" + dryrun_table("multipod"))
    if which in ("all", "roofline"):
        print("\n### roofline\n" + roofline_table("pod"))
    if which in ("all", "perf"):
        print("\n### before/after\n" + before_after())
