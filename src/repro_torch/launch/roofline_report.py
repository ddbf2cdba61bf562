"""Aggregate results/dryrun_torch/*.json into the dry-run and roofline
tables (markdown) of the port's analysis on H100 constants (PyTorch port
of ``repro.launch.roofline_report``, which imports no JAX; this is its
own copy, reading the port's results and reporting 80 GB cards)."""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = [
    "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "llama3.2-1b",
    "llama3.2-3b", "glm4-9b", "minitron-4b", "zamba2-2.7b", "xlstm-1.3b",
    "whisper-small", "llama-3.2-vision-11b"]


def load(results_dir: str) -> List[Dict]:
    recs = []
    for path in glob.glob(os.path.join(results_dir, "*.json")):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_sec(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def dryrun_table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | traced | fits 80GB | peak GB | "
            "grad accum |",
            "|---|---|---|---|---|---|---|"]
    key = lambda r: (ARCH_ORDER.index(r["arch"]),
                     SHAPE_ORDER.index(r["shape"]), r["mesh"])
    for r in sorted(recs, key=key):
        if not r.get("applicable", True):
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"SKIP | — | — | — |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{'yes' if r.get('fits_hbm_80gb') else 'NO'} | "
            f"{r['memory']['peak_per_device_gb']} | "
            f"{r.get('grad_accum', '—')} |")
    return "\n".join(rows)


def roofline_table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | compute | memory | collective | bottleneck | "
            "MODEL_FLOPS | useful ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    key = lambda r: (ARCH_ORDER.index(r["arch"]),
                     SHAPE_ORDER.index(r["shape"]))
    for r in sorted([r for r in recs if r["mesh"] == "16x16"], key=key):
        if not r.get("applicable", True) or "roofline" not in r:
            continue
        rl = r["roofline"]
        t = rl["terms_s"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_sec(t['compute'])} | "
            f"{fmt_sec(t['memory'])} | {fmt_sec(t['collective'])} | "
            f"**{rl['bottleneck']}** | {rl['model_flops']:.2e} | "
            f"{rl['useful_flops_ratio']:.2f} | "
            f"{rl['roofline_fraction']*100:.1f}% |")
    return "\n".join(rows)


def summary(recs: List[Dict]) -> str:
    ok = [r for r in recs if r.get("applicable", True)]
    skips = [r for r in recs if not r.get("applicable", True)]
    fits = [r for r in ok if r.get("fits_hbm_80gb")]
    lines = [
        f"cells: {len(recs)} total = {len(ok)} traced + "
        f"{len(skips)} skipped (long_500k on full-attention archs)",
        f"fits 80GB HBM: {len(fits)}/{len(ok)}",
    ]
    worst = sorted((r for r in ok if "roofline" in r),
                   key=lambda r: r["roofline"]["roofline_fraction"])[:3]
    for r in worst:
        lines.append(f"worst roofline: {r['arch']}/{r['shape']} "
                     f"{r['roofline']['roofline_fraction']*100:.1f}% "
                     f"({r['roofline']['bottleneck']}-bound)")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results",
        "dryrun_torch"))
    args = ap.parse_args()
    recs = load(args.results)
    print("## Dry-run (H100 SXM, modelled)\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16x16, per assigned cell)\n")
    print(roofline_table(recs))
    print("\n## Summary\n")
    print(summary(recs))


if __name__ == "__main__":
    main()
