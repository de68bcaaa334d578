"""CUDA fold-in kernel for Hopper: the wrapper around ``csrc/fold_in.cu``.

Replaces ``repro/kernels/fold_in/kernel.py::fold_in_docs`` (the Pallas TPU
kernel).  A thread-block cluster of CTAs per request document runs every
burn-in and sample sweep on-chip: the doc's tokens split across the
cluster, one warp per token with its lanes across the token's row, each
new topic counted into every CTA of the cluster through distributed
shared memory and the ELL re-selected in every CTA.  The CTAs a document
gets and the warps a CTA has are chosen at launch (``launch_shape``) so
that the batch runs in one wave; see the source note in
``csrc/fold_in.cu``.

What bounds it: the bytes floor is reading the gathered (B, L, K) int32
rows once (33.5 MB at B = 32, L = 256, K = 1024, ~10 us at 3.35 TB/s);
its time is the chain of sweeps, each an ELL select, a warp's scans and
searches per token over rows held in L2, and a cluster-wide recount.

Built with ``nvcc`` for ``sm_90a`` at first launch (``kernels/_build.py``)
and bound with ctypes.  The wrapper refuses CPU tensors: ``ops.py`` sends
those to the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sampler import pick_search_block
from repro_torch.kernels import _build

_vp, _i = ctypes.c_void_p, ctypes.c_int


def _lib(defines: tuple[str, ...] = ()):
    """The built library; ``defines`` (``NAME=VALUE``) select a build
    variant of the source, which only ``kernel_probe.py`` asks for."""
    lib = _build.load("fold_in", defines)
    fn = lib.fold_in_docs_launch
    if fn.argtypes is None:   # pointers and the stream as c_void_p, not int
        fn.argtypes = [_vp] * 10 + [_i] * 8 + [_vp]
        fn.restype = _i
        lib.fold_in_docs_shape.argtypes = [_i] * 5 + [ctypes.POINTER(_i)] * 2
        lib.fold_in_docs_shape.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def launch_shape(B: int, L: int, K: int, P: int) -> tuple[int, int]:
    """(CTAs a document, warps a CTA) that a (B, L) batch is launched with:
    the most warps on each document's tokens with which the whole batch
    runs in one wave.  The launch picks it itself; this reports it."""
    C, warps = _i(), _i()
    _lib().fold_in_docs_shape(B, L, K, P, pick_search_block(K),
                              ctypes.byref(C), ctypes.byref(warps))
    return C.value, warps.value


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
    out = fold_in_variant((), phi_tok, phi_sum, hyper, uniforms, mask, z0,
                          num_words_total=num_words_total, burn_in=burn_in,
                          samples=samples, ell_capacity=ell_capacity)
    fold_in_docs.launches += 1
    return out


def fold_in_variant(defines, phi_tok, phi_sum, hyper, uniforms, mask, z0, *,
                    num_words_total, burn_in, samples, ell_capacity):
    """``fold_in_docs`` through the build of the source with ``defines``
    (``()``: the shipped one), without counting the launch."""
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
    with torch.cuda.device(dev):
        stream = _build.current_stream(dev)
        err = _lib(defines).fold_in_docs_launch(
            phi_tok.data_ptr(), phi_sum.data_ptr(), hyper.data_ptr(),
            uniforms.data_ptr(), mask.data_ptr(), z0.data_ptr(),
            theta_sum.data_ptr(), sp.data_ptr(), ssq.data_ptr(), z.data_ptr(),
            B, L, K, P, burn_in, samples, int(num_words_total),
            pick_search_block(K), stream)
    if err != 0:   # 1 (invalid value): among others, no launch shape fits
        raise RuntimeError(f"fold_in_docs launch failed at B {B}, L {L}, "
                           f"K {K}, P {P}: CUDA error {err}")
    return theta_sum, sp, ssq, z


fold_in_docs.launches = 0   # kernel launches since the last reset
