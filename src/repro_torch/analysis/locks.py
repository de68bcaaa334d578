"""lock-discipline: AST race detector for the serving engine (the same
rules as ``repro.analysis.locks``, pointed at the port).

For each class in the target modules, infer which attributes are lock
instances (``self.x = threading.Lock()/RLock()/Condition()``), then which
attributes are *guarded* — assigned inside a ``with self.<lock>:`` block in
any non-``__init__`` method.  Every access to a guarded attribute outside a
with-lock context is flagged:

- **LD001** — write outside the lock (lost-update race)
- **LD002** — read outside the lock (torn/stale read)

``__init__`` is exempt (no concurrent access before the constructor
returns).  The runtime half of this checker is
``analysis.runtime.assert_lock_held``, which the engine calls inside its
guarded sections when the sanitizer is enabled.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .report import Finding

CHECKER = "lock-discipline"
# The continuous-batching engine's Condition-guarded scheduler state
# (``_cond``: pending queue, deadline heap, worker liveness flags; the
# stats lock ``_slock``; the sanitize-mode ``_sync_turn``), the fault
# plan's per-site counters, the hot-swap double buffer, and the metric
# families the admission counters live in.
TARGETS = (
    "src/repro_torch/serve/engine.py",
    "src/repro_torch/serve/faults.py",
    "src/repro_torch/serve/snapshot.py",
    "src/repro_torch/obs/metrics.py",
)
# threading.Condition guards like a lock (acquire/release delegate to the
# underlying lock); with-blocks on it are locked regions
LOCK_TYPES = frozenset({"Lock", "RLock", "Condition"})


def _callee_tail(call: ast.Call) -> str | None:
    fn = call.func
    while isinstance(fn, ast.Attribute):
        last = fn.attr
        fn = fn.value
        if not isinstance(fn, (ast.Attribute, ast.Name)):
            return None
        if isinstance(fn, ast.Name):
            return last
    return fn.id if isinstance(fn, ast.Name) else None


def _self_attr(node) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _makes_lock(value) -> bool:
    """``threading.Lock()`` and the like, or a conditional expression with
    one in either branch (``Lock() if sanitize else nullcontext()``: a lock
    whenever it locks)."""
    if isinstance(value, ast.IfExp):
        return _makes_lock(value.body) or _makes_lock(value.orelse)
    return isinstance(value, ast.Call) and _callee_tail(value) in LOCK_TYPES


def _lock_attrs(cls: ast.ClassDef) -> set[str]:
    locks = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            if _makes_lock(node.value):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr:
                        locks.add(attr)
    return locks


def _with_locks(stmt, locks: set[str]) -> bool:
    if not isinstance(stmt, (ast.With, ast.AsyncWith)):
        return False
    for item in stmt.items:
        if _self_attr(item.context_expr) in locks:
            return True
    return False


def _walk_method(fn, locks, on_write, on_read):
    """Visit every self-attr access in ``fn`` with lock-held context."""

    def visit(node, held):
        if _with_locks(node, locks):
            for item in node.items:
                visit(item.context_expr, held)
            for sub in node.body:
                visit(sub, True)
            return
        if isinstance(node, ast.Assign):
            visit(node.value, held)
            for t in node.targets:
                attr = _self_attr(t)
                if attr:
                    on_write(attr, t, held)
                else:
                    visit(t, held)
            return
        if isinstance(node, ast.AugAssign):
            visit(node.value, held)
            attr = _self_attr(node.target)
            if attr:
                # aug-assign is a read-modify-write
                on_read(attr, node.target, held)
                on_write(attr, node.target, held)
            else:
                visit(node.target, held)
            return
        attr = _self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            on_read(attr, node, held)
            return
        # nested defs/lambdas inherit: a closure made inside a locked
        # section typically RUNS later, unlocked — treat as not held
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            body = node.body if isinstance(node.body, list) else [node.body]
            for sub in body:
                visit(sub, False)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fn.body:
        visit(stmt, False)


def check_source(source: str, relpath: str) -> list[Finding]:
    tree = ast.parse(source)
    findings: list[Finding] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        locks = _lock_attrs(cls)
        if not locks:
            continue
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        # pass 1: attributes assigned under the lock anywhere outside
        # __init__ are the guarded set
        guarded: set[str] = set()
        for m in methods:
            if m.name == "__init__":
                continue
            _walk_method(
                m, locks,
                on_write=lambda a, n, held: guarded.add(a) if held else None,
                on_read=lambda a, n, held: None)
        if not guarded:
            continue
        # pass 2: flag unguarded accesses
        for m in methods:
            if m.name == "__init__":
                continue
            scope = f"{cls.name}.{m.name}"

            def flag_write(attr, node, held, scope=scope):
                if attr in guarded and not held:
                    findings.append(Finding(
                        checker=CHECKER, code="LD001", path=relpath,
                        line=node.lineno, scope=scope,
                        message=f"write to self.{attr} outside "
                                f"{'/'.join(sorted(locks))} — attribute is "
                                f"lock-guarded elsewhere (lost-update race)"))

            def flag_read(attr, node, held, scope=scope):
                if attr in guarded and not held:
                    findings.append(Finding(
                        checker=CHECKER, code="LD002", path=relpath,
                        line=node.lineno, scope=scope,
                        message=f"read of self.{attr} outside "
                                f"{'/'.join(sorted(locks))} — attribute is "
                                f"lock-guarded elsewhere (stale/torn read)"))

            _walk_method(m, locks, on_write=flag_write, on_read=flag_read)
    return findings


def run(root: Path) -> list[Finding]:
    findings = []
    for rel in TARGETS:
        p = Path(root) / rel
        if p.exists():
            findings += check_source(p.read_text(), rel)
    return findings
