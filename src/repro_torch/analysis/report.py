"""Markdown report generator for the dry-run and roofline tables, a copy of
``src/repro/analysis/report.py`` (which imports no JAX; the port keeps its
own copy and never imports the JAX package).

    PYTHONPATH=src python -m repro_torch.analysis.report [--root reports/dryrun]

Reads per-cell JSON records (one directory per mesh, one file per cell, as
the JAX package's ``launch/dryrun.py`` writes them; the port's dry run
comes with a later slice) and emits the two tables.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(root: str) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for mesh_dir in sorted(glob.glob(os.path.join(root, "*"))):
        mesh = os.path.basename(mesh_dir)
        recs = []
        for p in sorted(glob.glob(os.path.join(mesh_dir, "*.json"))):
            with open(p) as f:
                recs.append(json.load(f))
        out[mesh] = recs
    return out


def _f(x, nd=3):
    if x is None:
        return "-"
    if isinstance(x, (int,)):
        return str(x)
    if abs(x) >= 1000 or (abs(x) < 0.001 and x != 0):
        return f"{x:.2e}"
    return f"{x:.{nd}f}"


def _gb(x):
    return f"{x/2**30:.2f}" if x is not None else "-"


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | status | lower s | compile s | arg GiB/dev | "
        "temp GiB/dev | collective mix |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("variant"):
            continue
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:70]
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']}: "
                         f"{reason} | | | | | |")
            continue
        ma = r.get("memory_analysis", {})
        pc = r.get("per_collective", {})
        tot = sum(pc.values()) or 1.0
        mix = " ".join(f"{k.replace('all-','a').replace('reduce-scatter','rs').replace('collective-permute','cp')}:"
                       f"{100*v/tot:.0f}%" for k, v in
                       sorted(pc.items(), key=lambda kv: -kv[1])[:3])
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r.get('lower_s','-')} | "
            f"{r.get('compile_s','-')} | {_gb(ma.get('argument_size_in_bytes'))} | "
            f"{_gb(ma.get('temp_size_in_bytes'))} | {mix or '-'} |")
    return "\n".join(lines)


def roofline_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | T_comp s | T_mem s | T_coll s | bottleneck | "
        "MODEL_FLOPS | useful | MFU-bound | one-line fix |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok" or r.get("variant"):
            continue
        rl = r["roofline"]
        fix = suggest_fix(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_f(rl['t_comp_s'])} | "
            f"{_f(rl['t_mem_s'])} | {_f(rl['t_coll_s'])} | "
            f"{rl['bottleneck']} | {_f(rl['model_flops'],2)} | "
            f"{_f(rl['useful_ratio'],2)} | {_f(rl['mfu_bound'],3)} | {fix} |")
    return "\n".join(lines)


def suggest_fix(r: dict) -> str:
    rl = r["roofline"]
    b = rl["bottleneck"]
    pc = r.get("per_collective", {})
    top = max(pc, key=pc.get) if pc else ""
    if b == "collective":
        if r["arch"] == "egnn":
            return ("partition edges by destination shard so segment_sum "
                    "scatters stay local (halo exchange instead of "
                    f"{top} of full node arrays)")
        if "train" in r["shape"]:
            return ("sequence-parallel activations: turn per-layer TP "
                    "all-reduces into reduce-scatter/all-gather pairs")
        return f"reduce {top} volume (bf16 payloads, fuse merges)"
    if b == "memory":
        if "decode" in r["shape"] or "500k" in r["shape"]:
            return ("decode is KV-bound by nature; quantize cache to int8 "
                    "and fuse the GQA expand into the attention kernel")
        if "prefill" in r["shape"]:
            return "flash-attention Pallas kernel (no HBM score tile)"
        return ("larger q_chunk / flash kernel; drop fp32 copies the CPU "
                "backend inserts (bf16 on TPU)")
    return "increase per-device work (larger batch) or cast GEMMs to bf16"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="reports/dryrun")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    data = load(args.root)
    parts = []
    for mesh, recs in data.items():
        n_ok = sum(r["status"] == "ok" for r in recs)
        n_skip = sum(r["status"] == "skipped" for r in recs)
        n_err = len(recs) - n_ok - n_skip
        parts.append(f"\n### Mesh {mesh} — {n_ok} ok / {n_skip} skipped / "
                     f"{n_err} errors\n")
        parts.append(dryrun_table(recs))
    parts.append("\n\n### Roofline (single-pod 16x16)\n")
    if "pod16x16" in data:
        parts.append(roofline_table(data["pod16x16"]))
    text = "\n".join(parts)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)


if __name__ == "__main__":
    main()
