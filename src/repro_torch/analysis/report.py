"""Finding/report/baseline data model for the analysis suite (the port's
own copy of ``repro.analysis.report``).

A ``Finding`` is one checker hit.  Findings are fingerprinted WITHOUT
line numbers — ``checker:code:path:scope#occurrence`` — so a baseline
suppression survives unrelated edits to the same file (the occurrence
index only moves when findings of the same kind are added/removed in the
same scope).

The JSON report (schema ``repro-analysis/v1``) is what CI uploads as an
artifact; the committed baseline (schema ``repro-analysis-baseline/v1``,
``analysis-baseline-torch.json`` at the repo root for the port) lists
suppressed fingerprints, each with a human justification — an empty
suppression list means the tree is clean.

Baseline hygiene: a suppression that no longer matches any finding is not
just noise — it means the code it excused moved or was fixed, and leaving
it in place would silently re-excuse the *next* finding that lands on the
same fingerprint.  Stale entries therefore become BASE001 error findings
(checker ``baseline``), counted as unsuppressed and hence gating; the fix
path is ``--update-baseline`` (which drops them — BASE001 rows themselves
are never written back into the baseline).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

REPORT_SCHEMA = "repro-analysis/v1"
BASELINE_SCHEMA = "repro-analysis-baseline/v1"


@dataclasses.dataclass
class Finding:
    """One checker hit.  ``scope`` is the function/class/case context the
    fingerprint anchors to (line numbers deliberately excluded from it)."""

    checker: str
    code: str      # e.g. "PRNG001"
    path: str      # repo-relative, posix separators
    line: int
    message: str
    scope: str = ""


def finalize(findings: list[Finding]) -> list[dict]:
    """Findings -> report dicts with stable fingerprints.

    The occurrence counter runs per (checker, code, path, scope) in checker
    order, so two identical-kind findings in one scope stay distinguishable
    without baking line numbers into the fingerprint."""
    seen: dict[tuple, int] = {}
    out = []
    for f in findings:
        key = (f.checker, f.code, f.path, f.scope)
        occ = seen.get(key, 0)
        seen[key] = occ + 1
        out.append(dict(
            checker=f.checker, code=f.code, path=f.path, line=f.line,
            scope=f.scope, message=f.message,
            fingerprint=f"{f.checker}:{f.code}:{f.path}:{f.scope}#{occ}",
        ))
    return out


def load_baseline(path: Path) -> dict[str, str]:
    """Baseline file -> {fingerprint: justification}.  Missing file = empty
    baseline; a malformed file is an error (a silently-ignored baseline
    would un-suppress everything on a typo)."""
    if not Path(path).exists():
        return {}
    doc = json.loads(Path(path).read_text())
    if doc.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"{path}: expected schema {BASELINE_SCHEMA!r}, "
                         f"got {doc.get('schema')!r}")
    out = {}
    for s in doc.get("suppressions", []):
        out[s["fingerprint"]] = s.get("justification", "")
    return out


def write_baseline(path: Path, finding_dicts: list[dict]) -> None:
    doc = dict(
        schema=BASELINE_SCHEMA,
        suppressions=[
            dict(fingerprint=f["fingerprint"],
                 justification=f.get("justification")
                 or "TODO: justify or fix")
            for f in finding_dicts
            # BASE001 rows describe the baseline itself; writing them back
            # would suppress the staleness error with the stale entry
            if f.get("checker") != "baseline"
        ],
    )
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def build_report(findings: list[Finding], checks: list[str],
                 baseline_path: Path, timings: dict[str, float] | None = None
                 ) -> dict:
    """Assemble the ``repro-analysis/v1`` report: every finding tagged
    suppressed/unsuppressed against the baseline.  Baseline entries that
    matched nothing surface twice — in ``stale_suppressions`` (kept for
    report consumers) and as unsuppressible BASE001 findings, so a stale
    baseline gates exactly like a real finding.  ``timings`` (seconds per
    checker) is recorded verbatim when given."""
    baseline = load_baseline(baseline_path)
    rows = finalize(findings)
    matched = set()
    for r in rows:
        r["suppressed"] = r["fingerprint"] in baseline
        if r["suppressed"]:
            r["justification"] = baseline[r["fingerprint"]]
            matched.add(r["fingerprint"])
    stale = sorted(set(baseline) - matched)
    rows += finalize([
        Finding("baseline", "BASE001", Path(baseline_path).name, 0,
                f"stale suppression {fp!r} matches no finding — run "
                "--update-baseline (or delete the entry) so it cannot "
                "excuse a future finding with the same fingerprint",
                scope=fp)
        for fp in stale
    ])
    for r in rows:
        r.setdefault("suppressed", False)
    unsup = [r for r in rows if not r["suppressed"]]
    rep = dict(
        schema=REPORT_SCHEMA,
        checks=list(checks),
        findings=rows,
        stale_suppressions=stale,
        summary=dict(total=len(rows), suppressed=len(rows) - len(unsup),
                     unsuppressed=len(unsup)),
    )
    if timings is not None:
        rep["timings"] = {k: round(v, 3) for k, v in timings.items()}
    return rep
