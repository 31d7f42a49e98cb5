"""Render dry-run JSON into the roofline and dry-run tables (the JAX
package's ``roofline/report.py``; given the same records it prints the
same text).  A port record's count time (``count_s``) stands where the
reference's ``compile_s`` does.

  PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun.json
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List


def fmt_t(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def fmt_b(x) -> str:
    if x is None:
        return "-"
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def dryrun_table(records: List[Dict]) -> str:
    rows = []
    for r in records:
        status = str(r.get("status", ""))
        full = r.get("full", {})
        mem = full.get("memory", {}) or {}
        temp = mem.get("temp_bytes")
        args_b = mem.get("argument_bytes")
        cnt = (full.get("collectives", {}) or {}).get("count", {})
        rows.append("| {a} | {s} | {st} | {c} | {t} | {ar} | {coll} |".format(
            a=r["arch"], s=r["shape"],
            st="ok" if status == "ok" else status[:40],
            c=full.get("compile_s", full.get("count_s", "-")), t=fmt_b(temp),
            ar=fmt_b(args_b),
            coll=" ".join(f"{k.split('-')[-1][:4]}:{v}"
                          for k, v in sorted(cnt.items())) or "-"))
    head = ("| arch | shape | status | compile_s | temp/dev | args/dev | "
            "collectives |\n|---|---|---|---|---|---|---|")
    return head + "\n" + "\n".join(rows)


def roofline_table(records: List[Dict]) -> str:
    rows = []
    for r in records:
        rl = r.get("roofline")
        if not rl:
            continue
        rows.append(
            "| {a} | {s} | {tc} | {tm} | {tl} | {b} | {uf:.2f} | {rf:.3f} |"
            .format(a=r["arch"], s=r["shape"], tc=fmt_t(rl["t_compute_s"]),
                    tm=fmt_t(rl["t_memory_s"]), tl=fmt_t(rl["t_collective_s"]),
                    b=rl["bottleneck"], uf=rl["useful_fraction"],
                    rf=rl["roofline_fraction"]))
    head = ("| arch | shape | t_compute | t_memory | t_collective | "
            "bottleneck | useful(6ND/HLO) | roofline_frac |\n"
            "|---|---|---|---|---|---|---|---|")
    return head + "\n" + "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("json_path")
    ap.add_argument("--mode", choices=["dryrun", "roofline", "both"],
                    default="both")
    args = ap.parse_args()
    with open(args.json_path) as f:
        records = json.load(f)
    if args.mode in ("dryrun", "both"):
        print("### Dry-run\n")
        print(dryrun_table(records))
    if args.mode in ("roofline", "both"):
        print("\n### Roofline\n")
        print(roofline_table(records))


if __name__ == "__main__":
    main()
