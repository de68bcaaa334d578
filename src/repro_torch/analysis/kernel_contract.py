"""kernel-contract: executed checks over the CUDA kernels' launch geometry.

Each kernel package ships a ``contract.py`` (built on
``analysis.contracts``) whose cases are derived from the same Python
functions the launches use.  For every case this checker verifies:

- **KC001** — shared memory: a CTA's dynamic shared memory within the
  kernel's budget (Hopper: 232,448 bytes a block).
- **KC002** — launch limits: threads a CTA in [32, 1024] and a multiple of
  32; grid x <= 2^31 - 1, y and z <= 65,535; CTAs a cluster <= 8 and
  dividing grid x.
- **KC003** — coverage: every output element written exactly once (the
  segment tables of K2 and K4: each tile in one segment, each phi row
  written whole or zeroed).
- **KC004** — kernel-specific invariants via ``case.extra_checks``.
"""
from __future__ import annotations

import importlib
from pathlib import Path

from .contracts import MAX_CLUSTER, MAX_GRID_X, MAX_GRID_YZ, MAX_THREADS
from .report import Finding

CHECKER = "kernel-contract"
CONTRACT_MODULES = (
    "repro_torch.kernels.lda_sample.contract",
    "repro_torch.kernels.fold_in.contract",
    "repro_torch.kernels.phi_update.contract",
)


def check_contract(contract, relpath: str) -> list[Finding]:
    findings: list[Finding] = []

    def emit(code, scope, message):
        findings.append(Finding(checker=CHECKER, code=code, path=relpath,
                                line=1, scope=scope, message=message))

    for case in contract.cases:
        scope = f"{contract.kernel}:{case.name}"
        if case.smem_bytes > contract.smem_budget_bytes:
            emit("KC001", scope,
                 f"{case.smem_bytes} B of shared memory a CTA exceeds the "
                 f"{contract.smem_budget_bytes} B budget of "
                 f"{contract.kernel}")
        gx, gy, gz = case.grid
        bad = []
        if not (32 <= case.threads <= MAX_THREADS and case.threads % 32 == 0):
            bad.append(f"{case.threads} threads a CTA")
        if not (1 <= gx <= MAX_GRID_X and 1 <= gy <= MAX_GRID_YZ
                and 1 <= gz <= MAX_GRID_YZ):
            bad.append(f"grid {case.grid}")
        if not 1 <= case.cluster <= MAX_CLUSTER or gx % case.cluster:
            bad.append(f"cluster of {case.cluster} CTAs over grid x {gx}")
        if bad:
            emit("KC002", scope, "launch outside Hopper's limits: "
                 + "; ".join(bad))
        for chk in case.coverage:
            for msg in chk():
                emit("KC003", scope, msg)
        for chk in case.extra_checks:
            for msg in chk():
                emit("KC004", scope, msg)
    return findings


def run(root: Path) -> list[Finding]:
    findings = []
    for name in CONTRACT_MODULES:
        mod = importlib.import_module(name)
        rel = Path(mod.__file__).resolve().relative_to(
            Path(root).resolve()).as_posix()
        findings += check_contract(mod.contract(), rel)
    return findings
