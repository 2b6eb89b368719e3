"""Tabulate the port's dry-run records into markdown tables (the port of
``repro.launch.report``).

Usage:  PYTHONPATH=src python -m repro_torch.launch.report [--dir artifacts/dryrun]

The records are ``repro_torch.launch.dryrun``'s: the same fields as the
reference's, with the eager step's seconds (``step_seconds``) where the
reference has XLA's compile seconds, and the roofline against the H100.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(directory: str) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        r["_file"] = os.path.basename(path)
        r["_tag"] = (
            r["_file"].split("__")[3].removesuffix(".json")
            if r["_file"].count("__") >= 3 else ""
        )
        rows.append(r)
    return rows


def _fmt_bytes(b) -> str:
    if not b:
        return "-"
    return f"{b/2**30:.1f}"


def dryrun_table(rows: list[dict]) -> str:
    out = [
        "| arch | shape | mesh | fits | HBM GiB/chip | step s | knobs | "
        "collectives (count) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["_tag"]:
            continue
        mesh = "x".join(str(v) for v in r["mesh"].values())
        rl = r.get("roofline", {})
        kn = r.get("knobs", {})
        knob_s = (
            f"{kn.get('remat','-')[:9]}/mb{kn.get('microbatch',1)}"
            + ("/z1" if kn.get("zero1") else "")
        )
        out.append(
            f"| {r['arch']} | {r['shape']} | {mesh} "
            f"| {'Y' if rl.get('fits_hbm') else 'n/a' if rl.get('fits_hbm') is None else 'N'} "
            f"| {_fmt_bytes(rl.get('hbm_need_bytes'))} "
            f"| {r.get('step_seconds','-')} | {knob_s} "
            f"| {int(r.get('counted',{}).get('coll_count',0))} |"
        )
    return "\n".join(out)


def roofline_table(rows: list[dict], mesh_filter: str = "single") -> str:
    out = [
        "| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | dominant | "
        "MODEL_FLOPS | useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["_tag"]:
            continue
        mesh = r["mesh"]
        is_single = "pod" not in mesh
        if (mesh_filter == "single") != is_single:
            continue
        rl = r.get("roofline", {})
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {rl.get('t_compute_s', 0):.4f} "
            f"| {rl.get('t_memory_s', 0):.4f} "
            f"| {rl.get('t_collective_s', 0):.4f} "
            f"| **{rl.get('dominant','-')}** "
            f"| {rl.get('model_flops_total', 0):.2e} "
            f"| {rl.get('useful_compute_ratio', 0):.3f} "
            f"| {rl.get('roofline_fraction', 0):.3f} |"
        )
    return "\n".join(out)


def worst_cells(rows: list[dict], n: int = 5):
    cells = [
        r for r in rows
        if "pod" not in r["mesh"] and not r["_tag"] and "roofline" in r
    ]
    by_frac = sorted(cells, key=lambda r: r["roofline"]["roofline_fraction"])
    by_coll = sorted(
        cells,
        key=lambda r: -(
            r["roofline"]["t_collective_s"]
            / max(sum((r["roofline"]["t_compute_s"],
                       r["roofline"]["t_memory_s"],
                       r["roofline"]["t_collective_s"])), 1e-30)
        ),
    )
    return by_frac[:n], by_coll[:n]


def perf_table(rows: list[dict], arch: str, shape: str) -> str:
    """Hillclimb variants (tagged artifacts) vs the baseline for one cell."""
    cell = [
        r for r in rows
        if r["arch"] == arch and r["shape"] == shape and "pod" not in r["mesh"]
    ]
    base = next((r for r in cell if not r["_tag"]), None)
    out = [
        "| variant | t_comp | t_mem | t_coll | dominant | roofline frac | "
        "Δ dominant vs baseline |",
        "|---|---|---|---|---|---|---|",
    ]
    if base is None:
        return "(no baseline artifact)"
    bdom = base["roofline"]["dominant"]
    key = {"memory": "t_memory_s", "compute": "t_compute_s",
           "collective": "t_collective_s"}[bdom]
    bval = base["roofline"][key]
    for r in sorted(cell, key=lambda r: r["_tag"]):
        rl = r["roofline"]
        delta = (rl[key] - bval) / bval if bval else 0.0
        out.append(
            f"| {r['_tag'] or 'baseline'} "
            f"| {rl['t_compute_s']:.3f} | {rl['t_memory_s']:.3f} "
            f"| {rl['t_collective_s']:.3f} | {rl['dominant']} "
            f"| {rl['roofline_fraction']:.4f} "
            f"| {delta*100:+.1f}% |"
        )
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--perf", nargs=2, metavar=("ARCH", "SHAPE"))
    args = ap.parse_args()
    if args.perf:
        print(perf_table(load(args.dir), *args.perf))
        return
    rows = load(args.dir)
    print(f"### Dry-run ({len([r for r in rows if not r['_tag']])} cells)\n")
    print(dryrun_table(rows))
    print("\n### Roofline (single-pod 16x16, H100)\n")
    print(roofline_table(rows, "single"))
    print("\n### Roofline (multi-pod 2x16x16, H100)\n")
    print(roofline_table(rows, "multi"))
    frac, coll = worst_cells(rows)
    print("\nworst roofline fractions:",
          [(r["arch"], r["shape"]) for r in frac])
    print("most collective-bound:",
          [(r["arch"], r["shape"]) for r in coll])


if __name__ == "__main__":
    main()
