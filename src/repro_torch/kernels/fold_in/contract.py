"""kernel-contract metadata for the serving fold-in kernel K3
(``csrc/fold_in.cu``).

A (B, L) batch launches a (C, B) grid in clusters of C CTAs a document,
each of ``warps`` warps; ``fold_in.cu::shape_for`` picks (C, warps) among
the candidates below by the occupancy calculator (on the card only:
``kernel.launch_shape`` reports the pick) and falls back to one CTA of up
to 16 warps, which must therefore always fit.  ``smem_bytes`` mirrors
``fold_in.cu::layout`` (the GPU tests launch every case).  Cases: every
serving bucket (B in the engine's batch buckets, L in its length buckets,
P = min(L, K)) at both configs' K, every doc slice the sharded all2all
path launches (``distributed/partition.py::doc_slice_bounds``, 1-8
shards), and the shapes the GPU tests launch.
"""
from __future__ import annotations

from repro_torch.analysis.contracts import (CORPORA, MAX_CLUSTER,
                                            MAX_GRID_YZ, MAX_SMEM_BYTES,
                                            MAX_THREADS, KernelContract,
                                            LaunchCase, table3_geometry)
from repro_torch.core.sampler import pick_search_block
from repro_torch.distributed.partition import doc_slice_bounds
from repro_torch.serve.engine import EngineConfig

SMEM_BUDGET = MAX_SMEM_BYTES - 1024   # kMaxSmem: less the static arrays
MAX_WARPS = 16                        # kMaxWarps
MAX_CTAS = 8                          # kMaxCluster
MIN_TOKENS = 16                       # kMinTokens: slots a CTA at least
MAX_SEARCH_BLOCK = 32 * 4             # 32 lanes x kE entries


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(L: int, K: int, P: int, bw: int, warps: int, C: int) -> int:
    """``fold_in.cu::layout(L, K, P, bw, warps, C).total`` (4-byte
    entries)."""
    Lc = _cdiv(L, C)
    width = _cdiv(max(P, bw), 4) * 4               # prefix_width
    entries = (K + 2 * K + _cdiv(K, C) + min(L, K) + 2 * (L + 1) + 2 * P
               + 4 * Lc + 4 * Lc + Lc * (K // bw) + warps * width)
    return 4 * entries


def warps_for(L: int, C: int, cap: int) -> int:
    Lc = _cdiv(L, C)
    return 4 if Lc < 4 else min(Lc, cap)


def candidate_shapes(L: int) -> list[tuple[int, int]]:
    """Every (CTAs a doc, warps a CTA) ``shape_for`` may pick at length L;
    the first is its fallback."""
    most = min(L // MIN_TOKENS, MAX_CTAS)
    out = [(1, warps_for(L, 1, MAX_WARPS))]
    cap = MAX_WARPS
    while cap >= MAX_WARPS // 2:
        out += [(C, warps_for(L, C, cap)) for C in range(1, max(most, 1) + 1)]
        cap //= 2
    return out


def cases() -> tuple[tuple[str, int, int, int, int], ...]:
    """(name, B, L, K, P) of every launch the contract covers."""
    eng = EngineConfig()
    out = []
    for K in sorted({table3_geometry(n).num_topics for n in CORPORA}):
        for L in eng.length_buckets:
            P = min(L, K)
            for B in eng.batch_buckets():
                out.append((f"serve-B{B}-L{L}-K{K}", B, L, K, P))
            seen = set()
            for S in range(1, 9):
                per = doc_slice_bounds(eng.max_batch, S)[1]
                if per not in seen:
                    seen.add(per)
                    out.append((f"slice-S{S}-B{per}-L{L}-K{K}", per, L, K, P))
    # tests/test_torch_gpu.py: B = 1 / 33, L = 60 / 256, P below the live
    # topics, K = 90 (scalar rows)
    out += [("gpu-test-B33-L256", 33, 256, 1024, 256),
            ("gpu-test-B1-L60-P8", 1, 60, 1024, 8),
            ("gpu-test-B3-L64", 3, 64, 1024, 64),
            ("gpu-test-K90", 4, 60, 90, 60)]
    return tuple(out)


def _launch(name: str, B: int, L: int, K: int, P: int) -> LaunchCase:
    bw = pick_search_block(K)
    C, warps = candidate_shapes(L)[0]

    def limits():
        msgs = []
        if not (K % bw == 0 and bw <= MAX_SEARCH_BLOCK and K < 1 << 16
                and 1 <= P <= min(L, K)):
            msgs.append(f"the launch refuses K={K}, bw={bw}, P={P}, L={L}")
        for c, w in candidate_shapes(L):
            if c > MAX_CLUSTER or 32 * w > MAX_THREADS:
                msgs.append(f"candidate shape ({c} CTAs, {w} warps) is "
                            f"past Hopper's cluster / block limits")
        if B > MAX_GRID_YZ:
            msgs.append(f"B={B} docs exceed grid.y's {MAX_GRID_YZ}")
        return msgs

    return LaunchCase(name=name, grid=(C, B, 1), threads=32 * warps,
                      smem_bytes=smem_bytes(L, K, P, bw, warps, C),
                      cluster=C, extra_checks=(limits,))


def contract() -> KernelContract:
    return KernelContract(kernel="fold_in", smem_budget_bytes=SMEM_BUDGET,
                          cases=tuple(_launch(*c) for c in cases()))
