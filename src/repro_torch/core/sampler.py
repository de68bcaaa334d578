"""Sampler building blocks shared with serving: p*, and the two-level
blocked search (paper C5/C7), as in ``repro.core.sampler``.

The level-1 block width policy must match the reference exactly (128 when
it divides K, else the largest power of two that does), or draws diverge.
"""
from __future__ import annotations

import torch

SEARCH_BLOCK = 128  # level-1 tree arity


def pstar(phi_col: torch.Tensor, phi_sum: torch.Tensor, beta: float,
          num_words_total: int) -> torch.Tensor:
    """C7: p*(k) = (phi + beta) / (phi_sum + beta * V), float32."""
    return (phi_col.to(torch.float32) + beta) / (
        phi_sum.to(torch.float32) + beta * num_words_total)


def _pick_block(K: int) -> int:
    for b in (128, 64, 32, 16, 8, 4, 2, 1):
        if K % b == 0:
            return b
    return 1


def pick_search_block(K: int) -> int:
    """Level-1 block width: ``SEARCH_BLOCK`` when it divides K, else the
    largest power of two that does."""
    return SEARCH_BLOCK if K % SEARCH_BLOCK == 0 else _pick_block(K)


def blocked_search(pstar: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """C5: draw k ~ multinomial(pstar) by the two-level blocked search.

    pstar: (K,) non-negative weights; u: (t,) uniforms in [0, 1).  Returns
    (t,) int32 topics."""
    K = pstar.shape[0]
    B = pick_search_block(K)
    nb = K // B
    blocks = pstar.reshape(nb, B)
    bcum = torch.cumsum(blocks.sum(dim=1), dim=0)
    target = u * bcum[-1]
    b_idx = torch.clamp((bcum[None, :] <= target[:, None]).sum(1), max=nb - 1)
    prev = torch.where(b_idx > 0, bcum[(b_idx - 1).clamp(min=0)],
                       torch.zeros((), dtype=bcum.dtype, device=bcum.device))
    seg_cum = torch.cumsum(blocks[b_idx], dim=1) + prev[:, None]
    in_b = torch.clamp((seg_cum <= target[:, None]).sum(1), max=B - 1)
    return (b_idx * B + in_b).to(torch.int32)
