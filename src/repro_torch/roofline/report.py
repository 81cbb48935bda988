"""Format the dry-run's JSON records as markdown roofline tables (the port of
``repro.roofline.report``; the figures are projections for the H100).

    PYTHONPATH=src python -m repro_torch.roofline.report dryrun.json
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def _fmt_b(x: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def markdown_table(records: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | compute | memory | collective | dominant | useful-FLOPs | HBM/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "skip":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | SKIP: {r['reason']} | — | — | — |"
            )
            continue
        if r["status"] == "error":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | {r['error'][:60]} | | | | | |")
            continue
        ratio = r.get("useful_flops_ratio", 0.0)
        lines.append(
            "| {arch} | {shape} | {mesh} | {c} | {m} | {k} | **{dom}** | {ratio:.2f} | {hbm} | {fits} |".format(
                arch=r["arch"],
                shape=r["shape"],
                mesh=r["mesh"],
                c=_fmt_s(r["compute_s"]),
                m=_fmt_s(r["memory_s"]),
                k=_fmt_s(r["collective_s"]),
                dom=r["dominant"],
                ratio=ratio,
                hbm=_fmt_b(r["peak_bytes_per_device"]),
                fits="✓" if r["fits_hbm"] else "✗",
            )
        )
    return "\n".join(lines)


def collective_breakdown(records: List[Dict]) -> str:
    lines = [
        "| arch | shape | all-gather | all-reduce | reduce-scatter | all-to-all | permute |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] != "ok":
            continue
        c = r["collectives"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_b(c['all-gather'])} | {_fmt_b(c['all-reduce'])} "
            f"| {_fmt_b(c['reduce-scatter'])} | {_fmt_b(c['all-to-all'])} | {_fmt_b(c['collective-permute'])} |"
        )
    return "\n".join(lines)


def main() -> None:
    records: List[Dict] = []
    for path in sys.argv[1:]:
        with open(path) as f:
            records.extend(json.load(f))
    print("### Roofline terms (one step, per the three-term model)\n")
    print(markdown_table(records))
    print("\n### Collective-bytes breakdown (per device, per step)\n")
    print(collective_breakdown([r for r in records if r.get("mesh") == "16x16"]))


if __name__ == "__main__":
    main()
