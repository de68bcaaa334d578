"""Public wrappers for the phi count kernels, as
``repro/kernels/phi_update/ops.py``.

Both dispatch on the tensors' device: CUDA tensors go to the hand-written
kernels (``kernel.py``), CPU tensors to their plain versions (``ref.py``).
The kernels read the tiling's run structure from a segment table
(``segment_table``) and K4 also the rows it zeroes (``rows_to_zero``),
each built once per tiling.
There is no fallback: a failed build or launch raises.  The contract holds
on both: rows that no tile visits are zero.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def _args(tile_word, token_mask, *zs):
    z_dtype = zs[0].dtype if zs[0].dtype in kernel.Z_DTYPES else torch.int32
    return (tile_word.to(torch.int32).contiguous(),
            *(z.to(z_dtype).contiguous() for z in zs),
            (token_mask != 0).contiguous())


def segment_table(tile_word, tile_first, max_tiles: int) -> torch.Tensor:
    """(S, 4) int32 rows ``(first tile, tiles, word, sole)``: the tiling cut
    into segments of at most ``max_tiles`` consecutive tiles of one word,
    in tile order, cut wherever the word changes or ``tile_first`` (may be
    None) is set; ``sole`` is 1 where the word owns exactly one segment.
    Every tile lies in exactly one segment; padding tiles (which alias the
    last word) join its last run.  Built on the tiles' device, with one
    host sync: build it once per tiling."""
    n = tile_word.shape[0]
    dev = tile_word.device
    if n == 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=dev)
    tw = tile_word.to(torch.int64)
    cut = torch.ones(n, dtype=torch.bool, device=dev)
    cut[1:] = tw[1:] != tw[:-1]
    if tile_first is not None:
        cut |= tile_first.to(device=dev, dtype=torch.bool)
    starts = torch.nonzero(cut).flatten()
    lens = torch.diff(starts, append=starts.new_tensor([n]))
    per_run = (lens + max_tiles - 1) // max_tiles
    run = torch.repeat_interleave(per_run)
    k = (torch.arange(run.numel(), device=dev)
         - (torch.cumsum(per_run, 0) - per_run)[run])
    first = starts[run] + k * max_tiles
    tiles = torch.clamp(lens[run] - k * max_tiles, max=max_tiles)
    word = tw[first]
    _, inverse, owned = torch.unique(word, return_inverse=True,
                                     return_counts=True)
    sole = (owned[inverse] == 1).to(torch.int64)
    return torch.stack([first, tiles, word, sole], 1).to(
        torch.int32).contiguous()


def rows_to_zero(segments, num_words: int) -> torch.Tensor:
    """(R,) int32, ascending: the rows of a (num_words, K) count that no
    sole segment of ``segments`` writes whole, so that K4 zeroes them
    first: the rows of words that own several segments (their segments add
    into them) and the rows that no segment names (words without tiles,
    and ``num_words`` beyond the tiles' words).  Built on the table's
    device, with one host sync: build it once per tiling."""
    sole = torch.zeros(num_words, dtype=torch.bool, device=segments.device)
    sole[segments[:, 2][segments[:, 3] != 0].long()] = True
    return torch.nonzero(~sole).flatten().to(torch.int32)


def shard_segments(shard):
    """K2's and K4's segment table for a shard on a CUDA device, built on
    first use and kept with the shard (its tiling does not change across
    iterations); None for a shard on the CPU, whose plain version needs
    none.  The build syncs with the host once: ``fit`` calls this at
    set-up, before its sync-guarded iterations."""
    if shard.device.type != "cuda":
        return None
    return shard.cached("phi_delta_segments", lambda: segment_table(
        shard.tile_word, shard.tile_first, kernel.segment_tiles()))


def shard_chunk_segments(shard, micro_chunks: int):
    """K2's segment tables of a shard's ``micro_chunks`` micro-chunks on a
    CUDA device, one per chunk, for the per-chunk delta of
    ``LDAConfig.sync_overlap``; None on the CPU.  The trainer cuts the
    tiles padded to a multiple of ``micro_chunks`` with masked tiles of
    word 0 (``trainer._pad_tiles``); chunk m's table indexes its own
    tiles.  Built on first use and kept with the shard, with one host sync
    a chunk: set-up calls this before the sync-guarded iterations."""
    if shard.device.type != "cuda":
        return None

    def build():
        n = shard.tile_word.shape[0]
        n_pad = -n % micro_chunks
        nc = (n + n_pad) // micro_chunks
        pad = torch.zeros(n_pad, dtype=torch.bool, device=shard.device)
        tw = torch.cat([shard.tile_word, pad.to(shard.tile_word.dtype)])
        tf = torch.cat([shard.tile_first.to(torch.bool), pad])
        return tuple(segment_table(tw[m * nc:(m + 1) * nc],
                                   tf[m * nc:(m + 1) * nc],
                                   kernel.segment_tiles())
                     for m in range(micro_chunks))
    return shard.cached(f"phi_delta_segments_{micro_chunks}_chunks", build)


def shard_rows_to_zero(shard):
    """K4's ``rows_to_zero`` for a shard on a CUDA device and its
    ``num_words`` rows, built on first use and kept with the shard; None
    for a shard on the CPU."""
    if shard.device.type != "cuda":
        return None
    return shard.cached("phi_rebuild_zero_rows", lambda: rows_to_zero(
        shard_segments(shard), shard.num_words))


def phi_update(tile_word, tile_first, z, token_mask, *, num_words: int,
               num_topics: int, segments: torch.Tensor | None = None,
               zero_rows: torch.Tensor | None = None) -> torch.Tensor:
    """(V, K) int32 counts(z) per word row: a full rebuild of phi (K4).

    ``segments`` and ``zero_rows``: the kernel's ``segment_table`` of this
    tiling and its ``rows_to_zero`` for ``num_words``, kept by the caller
    (``shard_segments``, ``shard_rows_to_zero``).  On CUDA tensors the
    ones not given are built here, with a host sync each: K4 runs once a
    training run, outside the sync-guarded iterations.  The plain version
    uses neither."""
    tw, zz, tm = _args(tile_word, token_mask, z)
    if zz.device.type == "cuda":
        if segments is None:
            segments = segment_table(tw, tile_first, kernel.segment_tiles())
        if zero_rows is None:
            zero_rows = rows_to_zero(segments, num_words)
        return kernel.phi_update_tiles(segments, zero_rows, zz, tm,
                                       num_words, num_topics)
    return ref.phi_update_tiles_ref(tw, tile_first, zz, tm, num_words,
                                    num_topics)


def phi_delta(tile_word, tile_first, z_old, z_new, token_mask, *,
              num_words: int, num_topics: int,
              segments: torch.Tensor | None = None) -> torch.Tensor:
    """Per-iteration phi DELTA (V, K) int32: counts(z_new) - counts(z_old)
    (K2).  The trainer adds it to the iteration-start phi, so that
    ``phi_old + delta == phi_update(z_new)`` exactly.

    ``segments``: the kernel's ``segment_table`` of this tiling, built
    once by the caller (``shard_segments``); required on CUDA tensors,
    unused by the plain version."""
    tw, zn, zo, tm = _args(tile_word, token_mask, z_new, z_old)
    if zn.device.type == "cuda":
        if segments is None:
            raise ValueError("phi_delta on CUDA tensors needs the tiling's "
                             "segment table (segment_table or "
                             "shard_segments, built once per tiling)")
        return kernel.phi_delta_tiles(segments, zn, zo, tm, num_words,
                                      num_topics)
    return ref.phi_delta_tiles_ref(tw, tile_first, zn, zo, tm, num_words,
                                   num_topics)
