"""repro_torch.analysis — the port's static analysis and runtime
sanitizers (the counterpart of ``repro.analysis``, its own code: nothing
of the JAX package is imported).

Five checkers gate the port (``python -m repro_torch.analysis``):

- ``prng-discipline`` — AST pass: every draw passes an explicit
  ``torch.Generator``, no ``torch.manual_seed`` in the package, and the
  sampling paths draw only through the shared helpers.
- ``kernel-contract`` — executed checks over each CUDA kernel's launch
  geometry (shared memory a CTA, Hopper's grid / block / cluster limits,
  the segment tables' coverage), derived from the same Python functions
  the launches use; they replace the reference's Pallas BlockSpec / VMEM
  contracts.
- ``lock-discipline`` — race detector for the serving engine's
  lock-guarded attributes, plus the runtime ``assert_lock_held`` probe.
- ``collective-contract`` — every ``torch.distributed`` call checked
  against its declared group and wire type (no int16 on a wire, F4), plus
  executed checks on the CPU: the training step's groups, the byte wire's
  bytes, the all2all routing round trip and the serving byte accounting.
- ``dtype-flow`` — integer-width pass over ``core/`` and ``kernels/``:
  every narrowing cast and flattened index is a declared site backed by an
  executed witness at Table-3 scale of both configs, and every flat offset
  the CUDA kernels form fits int32 or is formed in int64.

The reference's ``jit-cache`` checker has no counterpart: the port jits
nothing (PyTorch runs eagerly), and its only run-time builds are the
kernels, keyed by source hash and defines in ``kernels/_build.py``.

Findings are suppressible via ``analysis-baseline-torch.json`` (empty on a
clean tree); stale suppressions are BASE001 errors.  The JSON report is the
``repro-analysis/v1`` schema with per-checker timings.  Runtime sanitizers
live in ``repro_torch.analysis.runtime``.
"""
from .contracts import KernelContract, LaunchCase
from .report import Finding
from .runtime import (LockNotHeldError, assert_lock_held,
                      enable_lock_sanitizer, lock_sanitizer_enabled,
                      sync_guard)

__all__ = [
    "KernelContract", "LaunchCase", "Finding", "LockNotHeldError",
    "assert_lock_held", "enable_lock_sanitizer", "lock_sanitizer_enabled",
    "sync_guard", "main",
]


def main(argv=None) -> int:
    from .cli import main as _main
    return _main(argv)
