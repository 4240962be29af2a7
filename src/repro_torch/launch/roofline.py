"""Roofline analysis over the port's dry-run records.

PyTorch counterpart of ``repro.launch.roofline``.  Reads
``results/dryrun_torch/*.json`` and derives, per (arch × shape × mesh),
against the port's ``hwspec.device.H100_SXM`` preset:

    compute_s    = FLOPs_per_rank / peak bf16 FLOP/s            (989e12)
    memory_s     = bytes_per_rank / HBM bandwidth               (3.35e12)
    collective_s = collective_bytes_per_rank / link bandwidth   (900e9,
                   NVLink 4's aggregate)

The counts are per rank (``launch.dryrun``'s ``StepCounter`` counts the
local ops), over every layer (``extrapolation`` holds the direct count).
The link constant is NVLink's, which joins the cards of one node only: on
a mesh of 256 or 512 ranks most collectives would cross a slower network,
so ``collective_s`` is a lower bound there.

Also reports MODEL_FLOPS = 6·N·D (6·N_active·D for MoE) and the usefulness
ratio MODEL_FLOPS / counted FLOPs.  For serve steps (forward-only) the
analogous forward count 2·N·D is reported alongside, since 6ND bakes in a
backward pass that inference does not run.
"""
import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.hwspec.device import H100_SXM

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
PEAK_FLOPS_BF16 = H100_SXM.peak_flops["bf16"]
HBM_BW = H100_SXM.hbm_bw
LINK_BW = H100_SXM.ici_bw_per_link
PRESET = (f"{H100_SXM.name}: {PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s bf16, "
          f"{HBM_BW / 1e12:g} TB/s HBM, {LINK_BW / 1e9:g} GB/s link")


def model_flops(arch_name: str, shape_name: str) -> Dict[str, float]:
    from repro_torch.configs import get_arch, get_shape
    arch = get_arch(arch_name)
    shape = get_shape(shape_name)
    total, active = arch.param_count()
    D = shape.tokens  # decode shapes: one token per sequence
    return {"model_flops_6nd": 6.0 * active * D,
            "model_flops_fwd_2nd": 2.0 * active * D,
            "tokens": float(D), "params_active": float(active),
            "params_total": float(total)}


def analyze_record(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if rec.get("skipped") or not rec.get("ok"):
        return None
    ext = rec.get("extrapolation")
    if ext is None:
        return None
    chips = rec["chips"]
    flops_dev = ext["est_flops"]
    bytes_dev = ext["est_bytes"]
    coll_dev = ext["est_collective_total"]

    compute_s = flops_dev / PEAK_FLOPS_BF16
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops(rec["arch"], rec["shape"])
    counted_global = flops_dev * chips
    out = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"], "chips": chips,
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collective_breakdown": ext.get("est_collective_bytes", {}),
        **terms,
        "dominant": dominant.replace("_s", ""),
        "step_time_bound_s": max(terms.values()),
        "hlo_flops_global": counted_global,
        **mf,
        "useful_ratio_6nd": mf["model_flops_6nd"] / max(counted_global, 1.0),
        "useful_ratio_fwd": mf["model_flops_fwd_2nd"]
        / max(counted_global, 1.0),
        "attn_mode": rec.get("attn_mode"),
        "notes": rec.get("policy_notes", []),
        "preset": H100_SXM.name,
    }
    # roofline fraction: useful model flops over the time the dominant
    # term implies, vs the cards' peak
    t = out["step_time_bound_s"]
    ref = (mf["model_flops_6nd"] if rec["kind"] == "train"
           else mf["model_flops_fwd_2nd"])
    out["roofline_fraction"] = ref / (t * chips * PEAK_FLOPS_BF16) \
        if t > 0 else 0.0
    return out


def load_all(results_dir: str = RESULTS_DIR) -> List[Dict[str, Any]]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        row = analyze_record(rec)
        if row is not None:
            rows.append(row)
    return rows


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:7.2f}s "
    if x >= 1e-3:
        return f"{x*1e3:7.2f}ms"
    return f"{x*1e6:7.1f}µs"


def table(rows: List[Dict[str, Any]], mesh: str = "pod") -> str:
    lines = [
        f"roofline per rank on {PRESET}",
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL/counted | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        ratio = (r["useful_ratio_6nd"] if r["kind"] == "train"
                 else r["useful_ratio_fwd"])
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['dominant']} | {ratio:.3f} | "
            f"{r['roofline_fraction']*100:.1f}% |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--json-out")
    args = ap.parse_args()
    rows = load_all(args.dir)
    print(table(rows, args.mesh))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
