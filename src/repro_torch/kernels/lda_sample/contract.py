"""kernel-contract metadata for the training-sweep kernel K1
(``csrc/lda_sample.cu``).

A CTA of 256 threads takes ``TILES_PER_CTA`` consecutive tiles, so the
grid is ceil(n / TILES_PER_CTA) CTAs; its dynamic shared memory is the
layout of ``lda_sample.cu::layout``, which ``kernel.smem_bytes`` asks the
built library for.  ``smem_bytes`` below mirrors it in Python (the GPU
tests hold the two equal over ``cases()``), and the wrapper refuses a shape
over ``kernel.MAX_SMEM_BYTES``.  Cases: NYTimes and PubMed at Table-3
``FULL`` scale (K = 1024, 256-token tiles, P and the ELL type from the
longest document), the worst ELL the trainer can pick (P = K, int32), and
the shapes the GPU tests launch.
"""
from __future__ import annotations

from repro_torch.analysis.contracts import (CORPORA, KernelContract,
                                            LaunchCase, table3_geometry)
from repro_torch.core.sampler import pick_search_block
from repro_torch.core.updates import ell_dtype
from repro_torch.kernels.lda_sample.kernel import MAX_SMEM_BYTES

THREADS = 256                    # kThreads
WARPS = THREADS // 32
TILES_PER_CTA = 8                # LDA_SAMPLE_TILES_PER_CTA, as shipped
PAD = 8                          # kPad: P rounded up for buffer strides


def smem_bytes(t: int, K: int, P: int, bw: int, ell_bytes: int) -> int:
    """``lda_sample.cu::layout(t, K, P, bw, ell_bytes).total``: two ELL rows
    (counts and topics) double-buffered a warp, a prefix a warp, the runs
    (int4 a slot), p* and its cumulative sums, the block sums, the
    uniforms, token docs and mask, and two ints a warp."""
    Pv = -(-P // PAD) * PAD
    return (WARPS * 2 * 2 * Pv * ell_bytes + WARPS * Pv * 4 + t * 16
            + 2 * K * 4 + (K // bw) * 4 + 2 * t * 4 + 2 * t * 4
            + 2 * WARPS * 4)


def cases() -> tuple[tuple[str, int, int, int, int, int], ...]:
    """(name, tiles, t, K, P, ELL bytes) of every launch the contract
    covers."""
    out = []
    for name in CORPORA:
        g = table3_geometry(name)
        dt = ell_dtype(g.num_topics, g.max_doc_length)
        out.append((f"{name}-full", g.num_tiles, g.tile_tokens, g.num_topics,
                    g.ell_capacity, dt.itemsize))
    out.append(("worst-ell-int32", 1 << 20, 256, 1024, 1024, 4))
    # tests/test_torch_gpu.py: SWEEP_CASES at K = 256 and 1024 (45 tiles of
    # 64), the run-length test (48 tiles) and K = 90
    for K in (256, 1024):
        for P, eb in ((512, 2), (300, 2), (300, 4), (64, 2), (64, 4),
                      (62, 4), (60, 2)):
            out.append((f"gpu-test-K{K}-P{min(P, K)}-e{eb}", 45, 64, K,
                        min(P, K), eb))
    out.append(("gpu-test-K90", 45, 64, 90, 64, 2))
    return tuple(out)


def contract() -> KernelContract:
    launches = []
    for name, n, t, K, P, eb in cases():
        launches.append(LaunchCase(
            name=name, grid=(-(-n // TILES_PER_CTA), 1, 1), threads=THREADS,
            smem_bytes=smem_bytes(t, K, P, pick_search_block(K), eb)))
    return KernelContract(kernel="lda_sample",
                          smem_budget_bytes=MAX_SMEM_BYTES,
                          cases=tuple(launches))
