"""kernel-contract metadata for the phi count kernels K2 (delta) and K4
(full rebuild) (``csrc/phi_update.cu``).

Both walk the segment table (``ops.segment_table``: at most
``SEGMENT_TILES`` consecutive tiles of one word) a warp a segment, each CTA
of as many warps (up to 8) as K-bin histograms fit its shared memory; K4
first zeroes ``ops.rows_to_zero`` and writes each sole word's row whole.
So every tile must lie in exactly one segment and every phi row be either
one sole word's (written whole) or listed to zero (KC003).  The tilings
are NYTimes' and PubMed's word-major tilings at Table-3 ``FULL`` scale
(each word's expected Zipf share, ``analysis.contracts.table3_geometry``)
and the GPU tests' tiling; ``SEGMENT_TILES`` mirrors the library's
``kernel.segment_tiles()`` (a GPU test holds them equal).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.contracts import (CORPORA, MAX_SMEM_BYTES,
                                            KernelContract, LaunchCase,
                                            table3_geometry)
from repro_torch.kernels.phi_update import ops

SEGMENT_TILES = 128              # kSegTiles
MAX_WARPS = 8                    # kThreads / 32


def count_warps(K: int) -> int:
    """Warps a CTA of the count kernel: K-bin int32 histograms in shared
    memory, at most 8 (``phi_update.cu::count_grid``)."""
    return min(MAX_SMEM_BYTES // (4 * K), MAX_WARPS)


def _tiling(tiles_per_word: np.ndarray):
    """Word-major tiles: (tile_word, tile_first) for a word's tiles in a
    row, the first flagged."""
    tpw = torch.from_numpy(np.asarray(tiles_per_word, dtype=np.int64))
    words = torch.arange(tpw.numel(), dtype=torch.int32)
    tile_word = torch.repeat_interleave(words, tpw)
    first = torch.zeros(tile_word.numel(), dtype=torch.bool)
    starts = torch.cumsum(tpw, 0) - tpw
    first[starts[tpw > 0]] = True
    return tile_word, first


def _coverage(name: str, tile_word, tile_first, V: int):
    seg = ops.segment_table(tile_word, tile_first, SEGMENT_TILES)
    n = tile_word.numel()

    def check():
        msgs = []
        first, tiles, word, sole = (seg[:, i].long() for i in range(4))
        hits = torch.zeros(n + 1, dtype=torch.int64)
        hits.index_add_(0, first, torch.ones_like(first))
        hits.index_add_(0, first + tiles, -torch.ones_like(first))
        per_tile = torch.cumsum(hits, 0)[:n]
        if not bool((per_tile == 1).all()):
            msgs.append(f"{int((per_tile != 1).sum())} of {n} tiles lie in "
                        "no segment or in several")
        if bool(((tiles < 1) | (tiles > SEGMENT_TILES)).any()):
            msgs.append(f"a segment spans outside [1, {SEGMENT_TILES}] tiles")
        tw = tile_word.long()
        ends = first + tiles - 1
        if not bool(((tw[first] == word) & (tw[ends] == word)).all()):
            msgs.append("a segment spans two words")
        rows = ops.rows_to_zero(seg, V).long()
        whole = torch.zeros(V, dtype=torch.int64)
        whole.index_add_(0, word[sole != 0], torch.ones_like(word[sole != 0]))
        listed = torch.zeros(V, dtype=torch.int64)
        listed[rows] += 1
        if bool((whole > 1).any()):
            msgs.append("a sole word owns more than one segment")
        if not bool(((whole + listed) == 1).all()):
            msgs.append(f"{int(((whole + listed) != 1).sum())} phi rows are "
                        "neither written whole by one sole segment nor "
                        "zeroed once (K4)")
        return msgs

    return seg, check


def cases():
    """(name, tile_word, tile_first, V, K) of every tiling covered."""
    out = []
    for name in CORPORA:
        g = table3_geometry(name)
        out.append((f"{name}-full", *_tiling(g.tiles_per_word), g.num_words,
                    g.num_topics))
    # tests/test_torch_gpu.py's tiling: a word over 5 segments
    # (640 tiles), single-tile words, a split word, no tiles for some rows
    rng = np.random.default_rng(0)
    tpw = rng.integers(0, 3, 200)
    tpw[7] = 5 * SEGMENT_TILES
    tpw[11] = SEGMENT_TILES + 1
    tpw[20] = 3
    tw, tf = _tiling(tpw)
    tf[int(tpw[:20].sum()) + 1] = True     # word 20 split into two runs
    out.append(("gpu-test", tw, tf, 240, 90))
    return out


def contract() -> KernelContract:
    launches = []
    for name, tw, tf, V, K in cases():
        seg, check = _coverage(name, tw, tf, V)
        warps = count_warps(K)
        launches.append(LaunchCase(
            name=name, grid=(max(1, -(-seg.shape[0] // max(warps, 1))), 1, 1),
            threads=32 * max(warps, 1), smem_bytes=4 * K * warps,
            coverage=(check,),
            extra_checks=(lambda w=warps, K=K: [] if w >= 1 else
                          [f"K={K} leaves no room for one K-bin histogram"],)))
    return KernelContract(kernel="phi_update",
                          smem_budget_bytes=MAX_SMEM_BYTES,
                          cases=tuple(launches))
