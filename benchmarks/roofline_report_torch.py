"""Aggregate the port's dry-run JSONs (`python -m repro_torch.launch.dryrun
--out DIR`) into a roofline table on the H100 SXM: the twin of
`benchmarks/roofline_report.py`, which reads the JAX dry run's.

    PYTHONPATH=src python -m benchmarks.roofline_report_torch [DIR]
"""
from __future__ import annotations

import glob
import json
import os


def load(results_dir="results_torch"):
    rows = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(p) as f:
            d = json.load(f)
        if "error" in d:
            d["status"] = "FAIL"
        elif "skip" in d:
            d["status"] = "skip"
        else:
            d["status"] = "ok"
        rows.append(d)
    return rows


def fmt_row(d):
    if d["status"] == "skip":
        return (f"| {d.get('arch','?')} | {d.get('shape','?')} | - | skip | "
                f"{d.get('skip','')[:40]} | | | | | |")
    if d["status"] == "FAIL":
        return (f"| {d.get('arch','?')} | {d.get('shape','?')} | - | FAIL | "
                f"{d.get('error','')[:40]} | | | | | |")
    r = d["roofline"]
    mesh = "x".join(str(x) for x in d["mesh"])
    return ("| {arch} | {shape} | {mesh} | {c:.4f} | {m:.4f} | {n:.4f} | "
            "{dom} | {useful:.2f} | {frac:.3f} | {t} |".format(
                arch=d["arch"], shape=d["shape"], mesh=mesh,
                c=r["compute_s"], m=r["memory_s"], n=r["collective_s"],
                dom=r["dominant"], useful=r["useful_flops_ratio"],
                frac=r["roofline_fraction"], t=d.get("trace_s")))


def main(results_dir="results_torch"):
    rows = load(results_dir)
    card = next((d["roofline"].get("card") for d in rows
                 if d["status"] == "ok"), None)
    if card:
        print(f"# per-card terms on {card}; counts divided evenly over "
              "the mesh's ranks")
    print("| arch | shape | mesh | compute_s | memory_s | collective_s |"
          " dominant | model/counted flops | roofline_frac | trace_s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for d in rows:
        if not d.get("multi_pod"):
            print(fmt_row(d))
    ok = [d for d in rows if d["status"] == "ok"]
    mp = [d for d in rows if d.get("multi_pod")]
    print(f"\n# cells: {len(rows)} total, {len(ok)} counted, "
          f"{len([d for d in rows if d['status'] == 'skip'])} skipped, "
          f"{len([d for d in rows if d['status'] == 'FAIL'])} failed; "
          f"multi-pod counted: {len([d for d in mp if d['status'] == 'ok'])}")
    return rows


if __name__ == "__main__":
    import sys
    main(sys.argv[1] if len(sys.argv) > 1 else "results_torch")
