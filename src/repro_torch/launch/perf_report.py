"""Before/after table of two dry runs (``launch/dryrun.py --out`` files):
the roofline bound, the step time of its dominant term, the roofline MFU
and the peak memory a card, per cell.  The port of
``repro.launch.perf_report``; the records come from a dispatch trace of
fake tensors on H100 meshes, not from HLO.

    PYTHONPATH=src python -m repro_torch.launch.perf_report results/dryrun_before.json results/dryrun_after.json
"""
from __future__ import annotations

import json
import sys

from repro_torch.launch.roofline import analyze_cell


def load(path: str) -> dict:
    with open(path) as f:
        cells = json.load(f)
    return {(c["arch"], c["shape"]): c for c in cells
            if c.get("status") == "ok" and "costs" in c}


def report(base_path: str, opt_path: str) -> str:
    base, opt = load(base_path), load(opt_path)
    rows = ["| arch | shape | bound (b→o) | dom term s (b→o) | roofline MFU "
            "(b→o) | peak GB (b→o) | fits |",
            "|---|---|---|---|---|---|---|"]
    for key in sorted(opt):
        if key not in base:
            continue
        b, o = analyze_cell(base[key]), analyze_cell(opt[key])
        bm = base[key]["memory"]["peak_device_bytes"] / 1e9
        om = opt[key]["memory"]["peak_device_bytes"] / 1e9
        rows.append(
            f"| {key[0]} | {key[1]} | {b['bound']}→{o['bound']} | "
            f"{b['step_time']:.3g}→{o['step_time']:.3g} | "
            f"{b['mfu']:.1%}→{o['mfu']:.1%} | {bm:.1f}→{om:.1f} | "
            f"{'Y' if opt[key]['fits_hbm'] else 'N'} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(report(sys.argv[1], sys.argv[2]))
