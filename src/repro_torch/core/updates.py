"""Count-matrix updates: exact int32 scatter-adds, and the ELL slice of theta.

phi is stored **word-major**, shape (V, K), as in ``repro.core.updates``.
Every function here is plain PyTorch; the count kernels of the training
path (phi's per-iteration delta and its full rebuild) live in
``repro_torch.kernels.phi_update``.
"""
from __future__ import annotations

import torch


def _scatter_counts(rows: torch.Tensor, z: torch.Tensor, inc: torch.Tensor,
                    num_rows: int, num_topics: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Add ``inc`` at (rows, z) of a flat (num_rows * K) int32 count array."""
    flat = rows.reshape(-1).long() * num_topics + z.reshape(-1).long()
    if out is None:
        out = torch.zeros(num_rows * num_topics, dtype=torch.int32,
                          device=z.device)
    out.index_add_(0, flat, inc.reshape(-1).to(torch.int32))
    return out


def _tile_rows(tile_word: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    n, t = z.shape
    return tile_word[:, None].expand(n, t)


def phi_from_z(z: torch.Tensor, tile_word: torch.Tensor,
               token_mask: torch.Tensor, num_words: int,
               num_topics: int) -> torch.Tensor:
    """(V, K) int32 topic-word counts from tiled assignments.

    z: (n, t) topic per token; tile_word: (n,); token_mask: (n, t)."""
    return _scatter_counts(_tile_rows(tile_word, z), z, token_mask,
                           num_words, num_topics).view(num_words, num_topics)


def theta_from_z(z: torch.Tensor, token_doc: torch.Tensor,
                 token_mask: torch.Tensor, num_docs: int,
                 num_topics: int) -> torch.Tensor:
    """(D, K) int32 doc-topic counts from assignments (masked slots add 0)."""
    return _scatter_counts(token_doc, z, token_mask, num_docs,
                           num_topics).view(num_docs, num_topics)


def phi_delta(z_old: torch.Tensor, z_new: torch.Tensor,
              tile_word: torch.Tensor, token_mask: torch.Tensor,
              num_words: int, num_topics: int) -> torch.Tensor:
    """Incremental phi update: counts(z_new) - counts(z_old) per word row,
    so that ``phi_old + phi_delta == phi_from_z(z_new)`` exactly."""
    rows = _tile_rows(tile_word, z_new)
    inc = token_mask.to(torch.int32)
    d = _scatter_counts(rows, z_new, inc, num_words, num_topics)
    return _scatter_counts(rows, z_old, -inc, num_words, num_topics,
                           out=d).view(num_words, num_topics)


def theta_delta(z_old: torch.Tensor, z_new: torch.Tensor,
                token_doc: torch.Tensor, token_mask: torch.Tensor,
                num_docs: int, num_topics: int) -> torch.Tensor:
    """Incremental theta update for the micro-chunk refresh (WorkSchedule2)."""
    inc = token_mask.to(torch.int32)
    d = _scatter_counts(token_doc, z_new, inc, num_docs, num_topics)
    return _scatter_counts(token_doc, z_old, -inc, num_docs, num_topics,
                           out=d).view(num_docs, num_topics)


INT16_MAX = 32767


def ell_dtype(num_topics: int, max_doc_length: int) -> torch.dtype:
    """C7 for the ELL: int16 counts and topics when K and the longest
    document (the largest count) fit, else int32."""
    fits = num_topics <= INT16_MAX and max_doc_length <= INT16_MAX
    return torch.int16 if fits else torch.int32


def ell_topk(theta: torch.Tensor, capacity: int, dtype=torch.int32):
    """Dense counts (..., K) -> ELL ``(counts, topics)`` (..., P) of
    ``dtype`` (int32 unless asked; the cast is the one pass that writes
    them).

    The order of ``jax.lax.top_k``: count descending, ties to the lower
    topic id, zero counts last in id order — a *stable* sort on -count.
    ``torch.topk`` breaks ties in another order, which would reorder the
    sparse prefix sum and change draws, so it is not used."""
    order = torch.sort(-theta.to(torch.int64), dim=-1, stable=True).indices
    topics = order[..., :capacity]
    counts = torch.gather(theta, -1, topics)
    return counts.to(dtype), topics.to(dtype)


def theta_to_ell(theta: torch.Tensor, capacity: int, dtype=torch.int32):
    """Dense theta -> ELL: (counts (D, P), topics (D, P), both of ``dtype``,
    overflowed (D,) bool).

    Rows with more than ``capacity`` non-zeros are flagged; callers either
    guarantee capacity >= max K_d (exact mode) or route flagged docs to the
    dense sampler.  Padding entries have count 0 and add 0 to p1."""
    counts, topics = ell_topk(theta, capacity, dtype)
    nnz = (theta > 0).sum(dim=-1)
    return counts, topics, nnz > capacity


def phi_totals(phi_vk: torch.Tensor) -> torch.Tensor:
    """phi_sum (K,) int32 — per-topic token totals (the Eq. 1 denominator)."""
    return phi_vk.sum(dim=0, dtype=torch.int32)
