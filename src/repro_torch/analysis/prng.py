"""prng-discipline: AST checker for random draws in the port (torch's
idiom: ``torch.Generator`` objects passed explicitly, not keys).

Rules (fingerprint codes):

- **PRNG001** — a draw without an explicit ``generator=``:
  ``torch.rand``/``randint``/``randn``/``multinomial``/``bernoulli``/
  ``randperm``/``normal``/``poisson`` and their ``*_like`` forms, the
  ``Tensor.multinomial``/``bernoulli`` methods and the in-place
  ``uniform_``/``normal_``/``random_``/``exponential_``/``bernoulli_``/
  ``geometric_``/``cauchy_``/``log_normal_``.  Without one the draw comes
  from the process-wide default generator: its stream depends on every
  other caller's draws, so a run is neither reproducible nor resumable.
- **PRNG002** — ``torch.manual_seed`` (or ``torch.cuda.manual_seed[_all]``,
  ``torch.random.manual_seed``, ``torch.seed``) inside the package:
  reseeding the default generator changes every other caller's stream.
  Seed a ``torch.Generator`` instead.
- **PRNG003** — a draw inside the sampling modules outside the shared draw
  helpers.  The kernel / plain-version parity contract needs every
  sampling draw shaped by one routine (``draw_sweep_uniforms``,
  ``draw_dense_uniforms``, ``draw_fold_in_randoms``,
  ``draw_initial_topics``); a raw draw forks it.

The reference's key-flow rules (reused or discarded keys, double splits)
have no counterpart: a generator advances its own state on every draw.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .astutil import ScopedVisitor, dotted
from .report import Finding

CHECKER = "prng-discipline"

PACKAGE = "src/repro_torch"
# torch.<name>(...) draws
TORCH_DRAWS = frozenset({
    "rand", "randint", "randn", "multinomial", "bernoulli", "randperm",
    "normal", "poisson", "rand_like", "randint_like", "randn_like",
})
# Tensor methods that draw (called on a tensor, any receiver)
METHOD_DRAWS = frozenset({
    "multinomial", "bernoulli", "uniform_", "normal_", "random_",
    "exponential_", "bernoulli_", "geometric_", "cauchy_", "log_normal_",
})
SEEDERS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
})
# PRNG003 scope: the sampling paths (repo-relative posix paths)
SAMPLING_PATHS = (
    "src/repro_torch/core/sampler.py",
    "src/repro_torch/core/dense_sampler.py",
    "src/repro_torch/core/trainer.py",
    "src/repro_torch/serve/infer.py",
    "src/repro_torch/kernels/lda_sample/ops.py",
    "src/repro_torch/kernels/fold_in/ops.py",
    "src/repro_torch/kernels/phi_update/ops.py",
    "src/repro_torch/distributed/partition.py",
)
DRAW_HELPERS = frozenset({
    "draw_sweep_uniforms", "draw_dense_uniforms", "draw_fold_in_randoms",
    "draw_initial_topics",
})


class _Visitor(ScopedVisitor):
    def __init__(self, relpath: str):
        super().__init__()
        self.relpath = relpath
        self.in_sampling = relpath in SAMPLING_PATHS
        self.torch_names: dict[str, str] = {}   # bare name -> torch.<name>
        self.findings: list[Finding] = []

    def collect_imports(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in (
                    "torch", "torch.random", "torch.cuda"):
                for a in node.names:
                    self.torch_names[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def _emit(self, code: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            checker=CHECKER, code=code, path=self.relpath, line=node.lineno,
            message=message, scope=self.scope or "<module>"))

    def _draw_name(self, call: ast.Call) -> str | None:
        """The draw a call makes (``torch.rand``, ``.uniform_``), else
        None."""
        f = call.func
        name = dotted(f)
        if name is not None and name in self.torch_names:
            name = self.torch_names[name]
        if name is not None and name.startswith("torch."):
            leaf = name.rsplit(".", 1)[1]
            return name if leaf in TORCH_DRAWS and name.count(".") == 1 \
                else None
        if isinstance(f, ast.Attribute) and f.attr in METHOD_DRAWS:
            return f".{f.attr}"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        if name is not None:
            name = self.torch_names.get(name, name)
            if name in SEEDERS:
                self._emit("PRNG002", node,
                           f"{name}() reseeds the process-wide generator, "
                           "changing every other caller's stream — seed a "
                           "torch.Generator and pass it")
        draw = self._draw_name(node)
        if draw is not None:
            if not any(kw.arg == "generator" for kw in node.keywords):
                self._emit("PRNG001", node,
                           f"{draw} draws without generator= — the default "
                           "generator's stream depends on every other "
                           "caller; pass an explicit torch.Generator")
            in_helper = any(s in DRAW_HELPERS for s in self._stack)
            if self.in_sampling and not in_helper:
                self._emit("PRNG003", node,
                           f"raw {draw} draw in sampling code outside the "
                           "shared helpers "
                           f"({', '.join(sorted(DRAW_HELPERS))}) — raw draws"
                           " fork the kernel / plain-version parity "
                           "contract")
        self.generic_visit(node)


def check_source(source: str, relpath: str) -> list[Finding]:
    tree = ast.parse(source)
    v = _Visitor(relpath)
    v.collect_imports(tree)
    v.visit(tree)
    return v.findings


def run(root: Path) -> list[Finding]:
    findings = []
    base = Path(root) / PACKAGE
    for path in sorted(base.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        findings += check_source(path.read_text(), rel)
    return findings
