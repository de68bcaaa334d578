"""``python -m repro_torch.analysis`` — run the port's checkers, gate on
its baseline (``analysis-baseline-torch.json``).

Exit codes: 0 = no unsuppressed findings, 1 = unsuppressed findings,
2 = a checker crashed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

from . import report as report_mod

CHECKS = ("prng-discipline", "kernel-contract", "lock-discipline",
          "collective-contract", "dtype-flow")
BASELINE = "analysis-baseline-torch.json"


def _checker(name):
    if name == "prng-discipline":
        from . import prng
        return prng.run
    if name == "kernel-contract":
        from . import kernel_contract
        return kernel_contract.run
    if name == "lock-discipline":
        from . import locks
        return locks.run
    if name == "collective-contract":
        from . import collectives
        return collectives.run
    if name == "dtype-flow":
        from . import dtypes
        return dtypes.run
    raise KeyError(name)


def _default_root() -> Path:
    p = Path.cwd()
    for cand in (p, *p.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return p


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static-analysis suite: generator "
                    "discipline, CUDA launch-geometry contracts, engine "
                    "lock discipline, collective contracts, dtype-flow "
                    "overflow witnesses.")
    ap.add_argument("--checks", nargs="+", choices=CHECKS, metavar="CHECK",
                    help=f"subset of checkers to run (default: all of "
                         f"{', '.join(CHECKS)})")
    ap.add_argument("--root", help="repo root (default: nearest ancestor "
                                   "containing src/repro_torch)")
    ap.add_argument("--json", dest="json_out", metavar="PATH",
                    help="write the repro-analysis/v1 report here")
    ap.add_argument("--baseline", metavar="PATH",
                    help="suppression file (default: "
                         f"<root>/{BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to suppress every current "
                         "finding (then exit 0)")
    ap.add_argument("--list-checks", action="store_true",
                    help="list checker names and exit")
    ap.add_argument("--max-seconds", type=float, metavar="S",
                    help="wall-clock budget for the whole run; exceeding it "
                         "is itself a failure (exit 1) so the suite stays "
                         "cheap enough to gate every PR")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.list_checks:
        for name in CHECKS:
            print(name)
        return 0

    root = Path(args.root).resolve() if args.root else _default_root()
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)

    selected = list(args.checks) if args.checks else list(CHECKS)
    findings = []
    timings: dict[str, float] = {}
    t_start = time.perf_counter()
    for name in selected:
        t0 = time.perf_counter()
        try:
            got = _checker(name)(root)
        except Exception:
            traceback.print_exc()
            print(f"[analysis] checker '{name}' crashed", file=sys.stderr)
            return 2
        timings[name] = time.perf_counter() - t0
        print(f"[analysis] {name}: {len(got)} finding(s) "
              f"[{timings[name]:.1f}s]")
        findings += got
    elapsed = time.perf_counter() - t_start
    timings["total"] = elapsed

    baseline_path = (Path(args.baseline) if args.baseline
                     else root / BASELINE)
    rep = report_mod.build_report(findings, selected, baseline_path,
                                  timings=timings)

    if args.update_baseline:
        report_mod.write_baseline(baseline_path, rep["findings"])
        print(f"[analysis] baseline updated: {baseline_path} "
              f"({rep['summary']['total']} suppression(s))")
        rep = report_mod.build_report(findings, selected, baseline_path,
                                      timings=timings)

    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rep, indent=1) + "\n")

    for r in rep["findings"]:
        if not r["suppressed"]:
            print(f"{r['path']}:{r['line']}: {r['code']} [{r['scope']}] "
                  f"{r['message']}")

    s = rep["summary"]
    print(f"[analysis] {s['total']} finding(s): {s['suppressed']} "
          f"suppressed, {s['unsuppressed']} unsuppressed "
          f"[{elapsed:.1f}s total]")
    if args.max_seconds is not None and elapsed > args.max_seconds:
        print(f"[analysis] wall-clock budget exceeded: {elapsed:.1f}s > "
              f"{args.max_seconds:.0f}s — the suite must stay cheap enough "
              "to gate every PR", file=sys.stderr)
        return 1
    return 0 if s["unsuppressed"] == 0 else 1
