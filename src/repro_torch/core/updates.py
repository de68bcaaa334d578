"""Count-matrix updates: exact int32 scatter-adds, and the ELL slice of theta.

phi is stored **word-major**, shape (V, K), as in ``repro.core.updates``.
The scatter-adds here are plain PyTorch; the count kernels of the training
path (phi's per-iteration delta and its full rebuild) live in
``repro_torch.kernels.phi_update``.  The ELL of theta (``ell_topk``,
``theta_to_ell``) dispatches on the device: CUDA tensors go to the kernel
in ``repro_torch.kernels.ell_select``, CPU tensors to the plain stable
sort here (``ell_topk_plain``, ``theta_to_ell_plain``).  The functions an iteration runs
cut and write blocks with ``narrow`` and ``fill_block``, not with Python
indexing or ``Tensor.copy_``: the dry run (``launch/dryrun.py``) traces
the iteration on fake ``cuda`` tensors on a CPU-only build of torch,
whose Python bindings for those take a CUDA device guard and raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ell_select import kernel as ell_kernel


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


def fill_block(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` (a cast as ``.to(dst.dtype)`` casts) through the
    aten op: the Python bindings of ``Tensor.copy_`` and of indexing take
    a device guard, which a CPU-only build of torch refuses for the dry
    run's fake ``cuda`` tensors."""
    torch.ops.aten.copy_.default(dst, src)


def ell_dtype(num_topics: int, max_doc_length: int) -> torch.dtype:
    """C7 for the ELL: int16 counts and topics when K and the longest
    document (the largest count) fit, else int32."""
    fits = num_topics <= INT16_MAX and max_doc_length <= INT16_MAX
    return torch.int16 if fits else torch.int32


# Rows a block of the plain PyTorch passes over a dense (D, K) theta (the
# plain ELL's sort and non-zero count, the likelihood's doc term): the
# sort's int64 keys, sorted keys and indices take 24 bytes a (doc, topic), a
# bool sum or a float32 lgamma 8 or 12, which at PubMed's D = 8.2M docs and
# K = 1024 would be 100-200 GB; a block of 2^16 rows bounds each at 1.6 GB.
THETA_ROW_BLOCK = 1 << 16


def ell_topk(theta: torch.Tensor, capacity: int, dtype=torch.int32):
    """Dense counts (..., K) -> ELL ``(counts, topics)`` (..., P) of
    ``dtype`` (int32 unless asked), P = min(capacity, K).

    The order of ``jax.lax.top_k``: count descending, ties to the lower
    topic id, zero counts last in id order.  ``torch.topk`` breaks ties in
    another order, which would reorder the sparse prefix sum and change
    draws, so it is not used.  On the card one kernel launch gives every
    row (``kernels/ell_select``, int32 contiguous theta); on the CPU
    ``ell_topk_plain``.  Both give the same output."""
    if theta.device.type == "cuda":
        counts, topics, _ = ell_kernel.ell_select(theta, capacity, dtype)
        return counts, topics
    return ell_topk_plain(theta, capacity, dtype)


def ell_topk_plain(theta: torch.Tensor, capacity: int, dtype=torch.int32):
    """``ell_topk`` in plain PyTorch on any device: a *stable* sort on
    -count, its indices and gathered counts cast to ``dtype`` (the cast is
    the one pass that writes them).  The rows are sorted
    ``THETA_ROW_BLOCK`` at a time (each row's order is its own, so the ELL
    is the same), which bounds the sort's temporaries.  The blocks are cut
    with ``narrow`` and written with ``fill_block``, not with Python
    indexing (module docstring)."""
    K = theta.shape[-1]
    capacity = min(capacity, K)
    flat = theta.reshape(-1, K)
    rows = flat.shape[0]
    counts = torch.empty((rows, capacity), dtype=dtype, device=theta.device)
    topics = torch.empty_like(counts)
    for r in range(0, rows, THETA_ROW_BLOCK):
        m = min(THETA_ROW_BLOCK, rows - r)
        block = flat.narrow(0, r, m)
        order = torch.sort(-block.to(torch.int64), dim=-1,
                           stable=True).indices.narrow(-1, 0, capacity)
        fill_block(counts.narrow(0, r, m),
                   torch.gather(block, -1, order).to(dtype))
        fill_block(topics.narrow(0, r, m), order.to(dtype))
    lead = theta.shape[:-1]
    return counts.view(*lead, capacity), topics.view(*lead, capacity)


def theta_to_ell(theta: torch.Tensor, capacity: int, dtype=torch.int32):
    """Dense theta (D, K) -> ELL (counts (D, P), topics (D, P),
    overflowed (D,) bool).

    Rows with more than ``capacity`` non-zeros are flagged; callers either
    guarantee capacity >= max K_d (exact mode) or route flagged docs to the
    dense sampler.  Padding entries have count 0 and add 0 to p1.  On the
    card one kernel launch writes all three (``ell_topk``)."""
    if theta.device.type == "cuda":
        return ell_kernel.ell_select(theta, capacity, dtype)
    return theta_to_ell_plain(theta, capacity, dtype)


def theta_to_ell_plain(theta: torch.Tensor, capacity: int,
                       dtype=torch.int32):
    """``theta_to_ell`` in plain PyTorch on any device: ``ell_topk_plain``
    and a count of each row's non-zeros."""
    counts, topics = ell_topk_plain(theta, capacity, dtype)
    flat = theta.reshape(-1, theta.shape[-1])
    rows = flat.shape[0]
    over = torch.empty(rows, dtype=torch.bool, device=theta.device)
    for r in range(0, rows, THETA_ROW_BLOCK):
        m = min(THETA_ROW_BLOCK, rows - r)
        fill_block(over.narrow(0, r, m), torch.count_nonzero(
            flat.narrow(0, r, m), dim=-1) > capacity)
    return counts, topics, over.view(theta.shape[:-1])


def phi_totals(phi_vk: torch.Tensor) -> torch.Tensor:
    """phi_sum (K,) int32 — per-topic token totals (the Eq. 1 denominator)."""
    return phi_vk.sum(dim=0, dtype=torch.int32)
