"""Public wrapper for the fold-in kernel.

The serving path gathers the phi rows of every request token once and hands
the (B, L, K) rows, the initial assignments and every sweep's uniforms to
the sweeps as data (the port's parity seam: the same arrays fed to the JAX
package give the same draws).  ``fold_in_sweeps_drawn`` dispatches on the
tensors' device: CUDA tensors go to the hand-written kernel, CPU tensors
to its plain PyTorch version.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def draw_fold_in_randoms(generator: torch.Generator, batch: int, length: int,
                         num_topics: int, n_sweeps: int, device):
    """The fold-in's entire randomness budget, drawn up front on ``device``
    (the generator must live there too): the initial assignments, then
    every sweep's uniforms.

    Returns (z0 (B, L) int32, uniforms (n_sweeps, B, L, 2) float32 in
    [0, 1))."""
    z0 = torch.randint(0, num_topics, (batch, length), generator=generator,
                       dtype=torch.int32, device=device)
    return z0, torch.rand((n_sweeps, batch, length, 2), generator=generator,
                          dtype=torch.float32, device=device)


def _hyper(alpha, beta, device) -> torch.Tensor:
    if isinstance(alpha, torch.Tensor) and isinstance(beta, torch.Tensor):
        return torch.stack([alpha, beta]).to(torch.float32)
    return torch.tensor([float(alpha), float(beta)], dtype=torch.float32,
                        device=device)


def fold_in_sweeps_drawn(
    phi_tok,       # (b, L, K) int32 — gathered phi rows
    phi_sum,       # (K,) int32
    mask,          # (b, L) bool
    z0,            # (b, L) int32 — pre-drawn initial assignments
    uniforms,      # (n_sweeps, b, L, 2) float32 — pre-drawn per-sweep draws
    alpha,         # floats, or 0-d tensors already on the device
    beta,
    *,
    num_words_total: int,
    burn_in: int,
    samples: int,
    ell_capacity: int,
    impl: str = "kernel",
):
    """The sweeps on pre-drawn randomness; returns per-doc partials over the
    kept sweeps: (theta_sum (b, K) int32, sparse_draws (b,) int32,
    ssq_sum (b,) float32).

    ``impl="kernel"`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``impl="ref"`` forces the plain version
    (parity checks only)."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown fold-in impl {impl!r} "
                         "(expected 'kernel' or 'ref')")
    args = (phi_tok.to(torch.int32).contiguous(),
            phi_sum.to(torch.int32).contiguous(),
            _hyper(alpha, beta, phi_tok.device),
            uniforms.transpose(0, 1).contiguous(),        # (b, n_sweeps, L, 2)
            mask.to(torch.int32).contiguous(),
            z0.to(torch.int32).contiguous())
    kw = dict(num_words_total=num_words_total, burn_in=burn_in,
              samples=samples, ell_capacity=ell_capacity)
    if impl == "kernel" and phi_tok.device.type == "cuda":
        return kernel.fold_in_docs(*args, **kw)[:3]
    return ref.fold_in_docs_ref(*args, **kw)[:3]
