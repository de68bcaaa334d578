"""Count-matrix updates: exact int32 scatter-adds, and the ELL slice of theta.

phi is stored **word-major**, shape (V, K), as in ``repro.core.updates``.
"""
from __future__ import annotations

import torch


def phi_from_z(z: torch.Tensor, tile_word: torch.Tensor,
               token_mask: torch.Tensor, num_words: int,
               num_topics: int) -> torch.Tensor:
    """(V, K) int32 topic-word counts from tiled assignments.

    z: (n, t) topic per token; tile_word: (n,); token_mask: (n, t)."""
    n, t = z.shape
    words = tile_word.long()[:, None].expand(n, t).reshape(-1)
    flat = words * num_topics + z.reshape(-1).long()
    phi = torch.zeros(num_words * num_topics, dtype=torch.int32,
                      device=z.device)
    phi.index_add_(0, flat, token_mask.reshape(-1).to(torch.int32))
    return phi.view(num_words, num_topics)


def theta_from_z(z: torch.Tensor, token_doc: torch.Tensor,
                 token_mask: torch.Tensor, num_docs: int,
                 num_topics: int) -> torch.Tensor:
    """(D, K) int32 doc-topic counts from assignments (masked slots add 0)."""
    flat = token_doc.reshape(-1).long() * num_topics + z.reshape(-1).long()
    theta = torch.zeros(num_docs * num_topics, dtype=torch.int32,
                        device=z.device)
    theta.index_add_(0, flat, token_mask.reshape(-1).to(torch.int32))
    return theta.view(num_docs, num_topics)


def ell_topk(theta: torch.Tensor, capacity: int):
    """Dense counts (..., K) -> ELL ``(counts, topics)`` (..., P), int32.

    The order of ``jax.lax.top_k``: count descending, ties to the lower
    topic id, zero counts last in id order — a *stable* sort on -count.
    ``torch.topk`` breaks ties in another order, which would reorder the
    sparse prefix sum and change draws, so it is not used."""
    order = torch.sort(-theta.to(torch.int64), dim=-1, stable=True).indices
    topics = order[..., :capacity]
    counts = torch.gather(theta, -1, topics)
    return counts.to(torch.int32), topics.to(torch.int32)
