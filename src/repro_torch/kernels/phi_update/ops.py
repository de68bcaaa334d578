"""Public wrappers for the phi count kernels, as
``repro/kernels/phi_update/ops.py``.

Both dispatch on the tensors' device: CUDA tensors go to the hand-written
kernels (``kernel.py``), CPU tensors to their plain versions (``ref.py``).
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


def phi_update(tile_word, tile_first, z, token_mask, *, num_words: int,
               num_topics: int) -> torch.Tensor:
    """(V, K) int32 counts(z) per word row: a full rebuild of phi (K4)."""
    tw, zz, tm = _args(tile_word, token_mask, z)
    if zz.device.type == "cuda":
        return kernel.phi_update_tiles(tw, zz, tm, num_words, num_topics)
    return ref.phi_update_tiles_ref(tw, tile_first, zz, tm, num_words,
                                    num_topics)


def phi_delta(tile_word, tile_first, z_old, z_new, token_mask, *,
              num_words: int, num_topics: int) -> torch.Tensor:
    """Per-iteration phi DELTA (V, K) int32: counts(z_new) - counts(z_old)
    (K2).  The trainer adds it to the iteration-start phi, so that
    ``phi_old + delta == phi_update(z_new)`` exactly."""
    tw, zn, zo, tm = _args(tile_word, token_mask, z_new, z_old)
    if zn.device.type == "cuda":
        return kernel.phi_delta_tiles(tw, zn, zo, tm, num_words, num_topics)
    return ref.phi_delta_tiles_ref(tw, tile_first, zn, zo, tm, num_words,
                                   num_topics)
