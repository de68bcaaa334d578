"""CUDA fold-in kernel for Hopper: the wrapper around ``csrc/fold_in.cu``.

Replaces ``repro/kernels/fold_in/kernel.py::fold_in_docs`` (the Pallas TPU
kernel).  One CTA per request document runs every burn-in and sample sweep
on-chip; see the source note in ``csrc/fold_in.cu`` for the design.

What bounds it: the per-token searches — each token and sweep reads P ELL
entries plus, on the dense side, nb block sums and one block's p*, gathered
from the (B, L, K) int32 rows in device memory / L2.  The bytes floor is
reading those rows once (33.5 MB at B = 32, L = 256, K = 1024, ~10 us at
3.35 TB/s); the design keeps the small per-doc state (theta, ELL, block
sums, z) in shared memory and recomputes p* rather than staging its 1 MB
table, so the searches, not the bytes, set its time.

Built with ``nvcc`` for ``sm_90a`` at first launch (``kernels/_build.py``)
and bound with ctypes.  The wrapper refuses CPU tensors: ``ops.py`` sends
those to the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sampler import pick_search_block
from repro_torch.kernels import _build

_vp, _i = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("fold_in")
    fn = lib.fold_in_docs_launch
    if fn.argtypes is None:   # pointers and the stream as c_void_p, not int
        fn.argtypes = [_vp] * 10 + [_i] * 8 + [_vp]
        fn.restype = _i
    return lib


def fold_in_docs(
    phi_tok,       # (B, L, K) int32 — pre-gathered phi rows
    phi_sum,       # (K,) int32
    hyper,         # (2,) float32 — [alpha, beta] on the device
    uniforms,      # (B, n_sweeps, L, 2) float32
    mask,          # (B, L) int32
    z0,            # (B, L) int32
    *,
    num_words_total: int,
    burn_in: int,
    samples: int,
    ell_capacity: int,
):
    """Launch the kernel on the current stream; does not synchronise.

    Returns (theta_sum (B, K) int32, sparse_draws (B,) int32, ssq_sum (B,)
    float32, z (B, L) int32 — the final assignments)."""
    dev = _build.require_cuda(phi_tok, "fold_in_docs",
                              "ref.fold_in_docs_ref")
    B, L, K = phi_tok.shape
    n_sweeps = burn_in + samples
    P = int(ell_capacity)
    if not 1 <= P <= min(L, K):
        raise ValueError(f"ell_capacity {P} must be in [1, min(L, K)]")
    _build.check_tensor("phi_tok", phi_tok, torch.int32, (B, L, K), dev)
    _build.check_tensor("phi_sum", phi_sum, torch.int32, (K,), dev)
    _build.check_tensor("hyper", hyper, torch.float32, (2,), dev)
    _build.check_tensor("uniforms", uniforms, torch.float32,
                        (B, n_sweeps, L, 2), dev)
    _build.check_tensor("mask", mask, torch.int32, (B, L), dev)
    _build.check_tensor("z0", z0, torch.int32, (B, L), dev)
    theta_sum = torch.empty((B, K), dtype=torch.int32, device=dev)
    sp = torch.empty((B,), dtype=torch.int32, device=dev)
    ssq = torch.empty((B,), dtype=torch.float32, device=dev)
    z = torch.empty((B, L), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = _build.current_stream(dev)
        err = lib.fold_in_docs_launch(
            phi_tok.data_ptr(), phi_sum.data_ptr(), hyper.data_ptr(),
            uniforms.data_ptr(), mask.data_ptr(), z0.data_ptr(),
            theta_sum.data_ptr(), sp.data_ptr(), ssq.data_ptr(), z.data_ptr(),
            B, L, K, P, burn_in, samples, int(num_words_total),
            pick_search_block(K), stream)
    if err != 0:
        raise RuntimeError(f"fold_in_docs launch failed: CUDA error {err}")
    fold_in_docs.launches += 1
    return theta_sum, sp, ssq, z


fold_in_docs.launches = 0   # kernel launches since the last reset
