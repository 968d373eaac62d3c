"""Tables over the dry run's JSON (``launch/dryrun.py``).

The port's counterpart of ``repro.launch.report``: the roofline table of
one mesh, the dry-run table of every record, and a summary.

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--json build/dryrun_torch.json] [--mode roofline|dryrun|summary]
"""

from __future__ import annotations

import argparse
import json

def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def fmt_s(x: float) -> str:
    if x >= 0.1:
        return f"{x:.2f}"
    if x >= 1e-3:
        return f"{1e3 * x:.1f}m"
    return f"{1e6 * x:.0f}u"


def roofline_table(results: dict, mesh: str) -> str:
    rows = ["| arch/shape | kind | compute s | memory s | collective s | "
            "bottleneck | useful ratio | roofline frac | args GiB/dev | "
            "temp GiB/dev |",
            "|" + "---|" * 10]
    for key in sorted(results):
        r = results[key]
        if not r.get("ok") or r["mesh"] != mesh:
            continue
        rows.append(
            f"| {r['arch']}/{r['shape']} | {r['kind']} "
            f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} | **{r['bottleneck']}** "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {fmt_bytes(r['memory']['argument_size_b'])} "
            f"| {fmt_bytes(r['memory']['temp_size_b'])} |")
    return "\n".join(rows)


def dryrun_table(results: dict) -> str:
    rows = ["| arch/shape | mesh | trace s | GFLOP/dev | GiB/dev |"
            " coll GiB/dev | collectives (count) |",
            "|" + "---|" * 7]
    for key in sorted(results):
        r = results[key]
        if not r.get("ok"):
            continue
        colls = ", ".join(f"{op}:{d['count']}" for op, d in
                          sorted(r["collectives"].items())) or "-"
        rows.append(
            f"| {r['arch']}/{r['shape']} | {r['mesh']} | {r['trace_s']:.1f}"
            f" | {r['flops_per_device'] / 1e9:.1f}"
            f" | {fmt_bytes(r['bytes_per_device'])}"
            f" | {fmt_bytes(r['collective_wire_bytes_per_device'])}"
            f" | {colls} |")
    return "\n".join(rows)


def summarize(results: dict) -> dict:
    ok = [r for r in results.values() if r.get("ok")]
    per_mesh = {}
    for mesh in ("16x16", "2x16x16"):
        sub = [r for r in ok if r["mesh"] == mesh]
        per_mesh[mesh] = {
            "cells": len(sub),
            "bottlenecks": {b: sum(1 for r in sub if r["bottleneck"] == b)
                            for b in ("compute", "memory", "collective")},
            "worst_fraction": sorted(
                ((r["roofline_fraction"], f"{r['arch']}/{r['shape']}")
                 for r in sub))[:5],
            "most_collective_bound": sorted(
                ((r["collective_s"] / max(r["step_time_bound_s"], 1e-30),
                  r["collective_s"], f"{r['arch']}/{r['shape']}")
                 for r in sub), reverse=True)[:5],
        }
    return per_mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="build/dryrun_torch.json")
    ap.add_argument("--mode", choices=["roofline", "dryrun", "summary"],
                    default="summary")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    with open(args.json) as f:
        results = json.load(f)
    if args.mode == "roofline":
        print(roofline_table(results, args.mesh))
    elif args.mode == "dryrun":
        print(dryrun_table(results))
    else:
        print(json.dumps(summarize(results), indent=1, default=str))


if __name__ == "__main__":
    main()
