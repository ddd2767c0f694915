"""Dry-run and roofline tables from ``launch/dryrun``'s JSONs.

  PYTHONPATH=src python -m repro_torch.analysis.report experiments/dryrun

The tables render a record as the reference's do, a mesh at a time: one
card (``h100x1``) and the reference's production meshes (``pod16x16``,
``pod2x16x16``, traced over a fake process group, every count a rank's).
A production mesh adds ``mesh_table``: per-rank temp and argument bytes,
whether the rank's peak fits the card, the collective bytes and
``t_collective`` (priced at NVLink's rate: a lower bound), the dominant
term and the trace's seconds.  Below the tables, the cells whose traced
peak exceeds the card's memory.
"""
from __future__ import annotations

import glob
import json
import os
import sys

MESHES = (("h100x1", "one card (NVIDIA H100 80GB)"),
          ("pod16x16", "single pod (16x16 = 256 ranks, per rank)"),
          ("pod2x16x16", "multi-pod (2x16x16 = 512 ranks, per rank)"))


def load(out_dir: str, mesh: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(out_dir, f"*__{mesh}.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_bytes(n):
    if n is None:
        return "-"
    return f"{n/2**30:.2f}GiB"


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | status | per-device temp | args | compile |",
        "|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "ok":
            mem = r["memory_analysis"]
            lines.append(
                f"| {r['arch']} | {r['shape']} | ok | "
                f"{fmt_bytes(mem.get('temp_size_in_bytes'))} | "
                f"{fmt_bytes(mem.get('argument_size_in_bytes'))} | "
                f"{r['t_compile_s']:.0f}s |")
        else:
            reason = r.get("reason", r.get("error", ""))[:60]
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']} | "
                         f"{reason} | | |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | dominant | "
        "useful | frac | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['status']} | — | — | |")
            continue
        rf = r["roofline"]
        note = _note(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['t_compute_s']:.3g}s | "
            f"{rf['t_memory_s']:.3g}s | {rf['t_collective_s']:.3g}s | "
            f"{rf['dominant']} | {rf['useful_ratio']:.2f} | "
            f"{rf['roofline_fraction']:.3f} | {note} |")
    return "\n".join(lines)


def _note(r) -> str:
    rf = r["roofline"]
    bd = rf["coll_breakdown"]
    if rf["dominant"] == "collective" and bd:
        top = max(bd, key=bd.get)
        return f"{top} {bd[top]/2**30:.0f}GiB/dev dominates"
    if rf["dominant"] == "compute":
        return "compute-bound (good)"
    return "HBM-bound"


def mesh_table(recs) -> str:
    """A production mesh's cells: the rank's bytes, fit, collectives and
    trace seconds."""
    lines = [
        "| arch | shape | status | chips | per-rank temp | per-rank args | fits | "
        "coll bytes | t_collective | dominant | trace |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:60]
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']} | {reason} "
                         f"| | | | | | | |")
            continue
        mem, rf = r["memory_analysis"], r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['chips']} | "
            f"{fmt_bytes(mem['temp_size_in_bytes'])} | "
            f"{fmt_bytes(mem['argument_size_in_bytes'])} | "
            f"{'yes' if r['fits_device_memory'] else 'no'} | {rf['coll_bytes']:.3g} | "
            f"{rf['t_collective_s']:.3g}s | {rf['dominant']} | {r['t_lower_s']:.0f}s |")
    return "\n".join(lines)


def fit_lines(recs) -> list[str]:
    """One line for each traced cell whose peak exceeds the card's memory."""
    return [f"{r['arch']} x {r['shape']}: peak "
            f"{fmt_bytes(r['memory_analysis']['peak_size_in_bytes'])} > "
            f"{fmt_bytes(r['device_memory_bytes'])}"
            for r in recs if r["status"] == "ok" and not r["fits_device_memory"]]


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"
    counts = {"ok": 0, "skipped-by-rule": 0, "FAILED": 0}
    for mesh, title in MESHES:
        recs = load(out_dir, mesh)
        if not recs:
            continue
        print(f"\n### Dry-run — {title}\n")
        print(dryrun_table(recs))
        print(f"\n### Roofline — {title}\n")
        print(roofline_table(recs))
        if mesh != "h100x1":
            print(f"\n### Per rank — {title}\n")
            print(mesh_table(recs))
        over = fit_lines(recs)
        print(f"\ncells whose peak exceeds the card's memory: {len(over)}")
        for line in over:
            print(f"- {line}")
        for r in recs:
            counts[r["status"]] = counts.get(r["status"], 0) + 1
    print(f"\ncells: ok={counts['ok']} skipped-by-rule={counts['skipped-by-rule']} "
          f"failed={counts['FAILED']}")


if __name__ == "__main__":
    main()
