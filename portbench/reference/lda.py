"""The plain reference of one collapsed-Gibbs LDA iteration, in canonical
token order (the corpus's own order: token i is ``doc_ids[i]``,
``word_ids[i]``).

Plain PyTorch; it imports nothing of the program.  Everything it needs it
works out again from the benchmark's corpus and the topics z that the
program reports: the counts (phi, phi_sum, a document's topics), the ELL
order, the per-word sampling tables, the sweep's draws and the joint
log-likelihood.

Origins, and what differs from them:

* the counts: ``repro_torch/core/updates.py`` (``phi_from_z``,
  ``theta_from_z``) -- here by ``bincount`` / ``unique`` over canonical
  tokens, never a dense (D, K) theta;
* the ELL: ``updates.ell_topk`` (count descending, ties to the lower
  topic, zero counts last) -- here by one sort of (doc, -count, topic)
  keys; only the live (non-zero) entries are defined;
* the draw: ``repro_torch/kernels/lda_sample/ref.py`` ->
  ``core/sampler.py::sample_tiles`` (the S/Q split, the sparse prefix
  search, the two-level blocked search of width 128) -- the same float32
  arithmetic, token by token in blocks instead of tile by tile, with the
  per-word tables built once;
* the uniforms: ``core/trainer.py::iteration_uniforms`` /
  ``seeded_generator`` (the program's stated scheme: iteration i of rank g
  draws ``torch.rand((n, t, 2))`` from a generator seeded with
  ``SeedSequence([seed, i(, g)])``), frozen here;
* the log-likelihood: ``core/likelihood.py`` (Eq. of the paper's Fig. 8)
  -- here in float64, over the non-zero counts only;
* ``flip_margins`` has no origin in the program: it is the benchmark's
  measure of how far a draw that differs from the reference's lies from
  a boundary of the reference's own distribution.
"""
from __future__ import annotations

import numpy as np
import torch

SEARCH_BLOCK = 128


def seeded_generator(entropy, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from a list of integers, as
    the program seeds each iteration's draws."""
    seed = np.random.SeedSequence([int(e) for e in entropy]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def iteration_uniforms(seed: int, iteration: int, rank, rows: int, t: int,
                       device) -> torch.Tensor:
    """The (rows, t, 2) float32 uniforms of one iteration (of one rank of a
    mesh: ``rank`` not None)."""
    entropy = [seed, iteration] + ([] if rank is None else [rank])
    return torch.rand((rows, t, 2), generator=seeded_generator(entropy,
                                                               device),
                      dtype=torch.float32, device=device)


def search_block(K: int) -> int:
    """The dense side's block width: 128 where it divides K, else the
    largest power of two that does."""
    b = SEARCH_BLOCK
    while K % b:
        b //= 2
    return b


def topic_word_counts(word: torch.Tensor, z: torch.Tensor, num_words: int,
                      num_topics: int) -> torch.Tensor:
    """(V, K) int64 counts of (word, topic) over the given tokens."""
    key = word.long() * num_topics + z.long()
    return torch.bincount(key, minlength=num_words * num_topics).view(
        num_words, num_topics)


def doc_topic_pairs(doc: torch.Tensor, z: torch.Tensor, num_topics: int):
    """The non-zero document-topic counts: (doc, topic, count) int64, one
    row per pair, in (doc, topic) order."""
    key, count = torch.unique(doc.long() * num_topics + z.long(),
                              return_counts=True)
    return key // num_topics, key % num_topics, count


def ell(doc: torch.Tensor, z: torch.Tensor, num_docs: int, num_topics: int):
    """The ELL of the documents' topic counts: (counts (D, P) int64, topics
    (D, P) int64, live (D,) int64), each row's non-zero entries first,
    count descending, ties to the lower topic; P the longest live row.
    Entries past ``live`` are 0 / 0 and undefined in the program."""
    d, k, c = doc_topic_pairs(doc, z, num_topics)
    cmax = int(c.max()) + 1 if c.numel() else 1
    order = torch.argsort((d * cmax + (cmax - 1 - c)) * num_topics + k)
    d, k, c = d[order], k[order], c[order]
    live = torch.bincount(d, minlength=num_docs)
    start = torch.cumsum(live, 0) - live
    pos = torch.arange(d.numel(), device=d.device) - start[d]
    P = max(int(live.max()) if live.numel() else 0, 1)
    counts = torch.zeros((num_docs, P), dtype=torch.int64, device=d.device)
    topics = torch.zeros_like(counts)
    counts[d, pos] = c
    topics[d, pos] = k
    return counts, topics, live


class WordTables:
    """Per-word sampling tables of one iteration's frozen phi, in ``dtype``
    (float32, as the program computes; bfloat16 for the control):
    p*(w, k) = (phi + b) / (phi_sum + b V), Q(w) = a sum_k p*, and the
    blocked search's block prefix sums and in-block prefix sums."""

    def __init__(self, phi: torch.Tensor, phi_sum: torch.Tensor,
                 alpha: float, beta: float, num_words_total: int,
                 dtype=torch.float32):
        V, K = phi.shape
        self.K, self.B = K, search_block(K)
        self.nb = K // self.B
        self.ps = (phi.to(dtype) + beta) / (phi_sum.to(dtype)
                                            + beta * num_words_total)
        self.Q = alpha * self.ps.sum(dim=-1)
        blocks = self.ps.view(V, self.nb, self.B)
        self.bcum = torch.cumsum(blocks.sum(dim=-1), dim=-1)      # (V, nb)
        self.seg = torch.cumsum(blocks, dim=-1).view(V, K)        # in-block


def sample(tables: WordTables, ell_counts, ell_topics, word, doc,
           uniforms, block: int = 1 << 18):
    """The sweep's draws of the given tokens (canonical order) against the
    frozen tables and the documents' ELL: (z (T,) int64, sparse (T,)
    bool), the S/Q rule of ``core/sampler.py::sample_tiles``."""
    T = word.numel()
    dev = word.device
    K, B, nb = tables.K, tables.B, tables.nb
    ps_flat, seg_flat = tables.ps.reshape(-1), tables.seg.reshape(-1)
    z = torch.empty(T, dtype=torch.int64, device=dev)
    sparse = torch.empty(T, dtype=torch.bool, device=dev)
    in_block = torch.arange(B, device=dev)
    P = ell_counts.shape[1]
    for a in range(0, T, block):
        w = word[a:a + block].long()
        d = doc[a:a + block].long()
        u = uniforms[a:a + block].to(tables.ps.dtype)
        u1, u2 = u[:, 0], u[:, 1]
        tpc = ell_topics[d]
        cnt = ell_counts[d].to(tables.ps.dtype)
        p1 = cnt * ps_flat[w[:, None] * K + tpc]
        p1_cum = torch.cumsum(p1, dim=-1)
        S = p1_cum[:, -1]
        use_sparse = u1 * (S + tables.Q[w]) < S
        j = torch.clamp((p1_cum <= (u2 * S)[:, None]).sum(-1), max=P - 1)
        k_sparse = torch.gather(tpc, 1, j[:, None])[:, 0]
        bc = tables.bcum[w]
        target = u2 * bc[:, -1]
        b_idx = torch.clamp((bc <= target[:, None]).sum(-1), max=nb - 1)
        prev = torch.where(
            b_idx > 0, torch.gather(bc, 1, (b_idx - 1).clamp(min=0)[:, None])
            [:, 0], torch.zeros((), dtype=bc.dtype, device=dev))
        seg = seg_flat[(w * K + b_idx * B)[:, None] + in_block] \
            + prev[:, None]
        in_b = torch.clamp((seg <= target[:, None]).sum(-1), max=B - 1)
        z[a:a + block] = torch.where(use_sparse, k_sparse, b_idx * B + in_b)
        sparse[a:a + block] = use_sparse
    return z, sparse


def flip_margins(phi, phi_sum, alpha: float, beta: float,
                 num_words_total: int, ell_counts, ell_topics, word, doc,
                 uniforms, z_prog) -> torch.Tensor:
    """For tokens whose drawn topic ``z_prog`` differs from the reference's:
    the least shift of the token's two uniforms (the larger of the two
    shifts, in units of [0, 1)) under which the reference's own rule, in
    exact (float64) arithmetic, draws ``z_prog``.  A draw that differs by
    float rounding at a boundary needs a shift of the order of float32's
    rounding; a topic the rule could not have drawn at these uniforms
    needs a large one (inf where no shift can).  (F,) float64."""
    f64 = torch.float64
    ps = (phi[word.long()].to(f64) + beta) / (phi_sum.to(f64)
                                              + beta * num_words_total)
    u1, u2 = uniforms[:, 0].to(f64), uniforms[:, 1].to(f64)
    k = z_prog.long()[:, None]
    cum = torch.cumsum(ps, dim=-1)
    total = cum[:, -1]
    hi = torch.gather(cum, 1, k)[:, 0]
    lo = hi - torch.gather(ps, 1, k)[:, 0]
    Q = alpha * total
    tpc = ell_topics[doc.long()]
    cnt = ell_counts[doc.long()].to(f64)
    c1 = torch.cumsum(cnt * torch.gather(ps, 1, tpc), dim=-1)
    S = c1[:, -1]
    r = S / (S + Q)

    def dist(u, a, b):
        return torch.clamp(torch.maximum(a - u, u - b), min=0.0)

    dense = torch.maximum(torch.clamp(r - u1, min=0.0),
                          dist(u2, lo / total, hi / total))
    hit = (tpc == k) & (cnt > 0)
    j = torch.argmax(hit.to(torch.int8), dim=1)[:, None]
    s_hi = torch.gather(c1, 1, j)[:, 0]
    s_lo = s_hi - torch.gather(cnt * torch.gather(ps, 1, tpc), 1, j)[:, 0]
    sp = torch.maximum(torch.clamp(u1 - r, min=0.0),
                       dist(u2, s_lo / S, s_hi / S))
    sp = torch.where(hit.any(1), sp, torch.full_like(sp, float("inf")))
    return torch.minimum(sp, dense)


def doc_log_likelihood(doc, z, doc_length, num_topics: int,
                       alpha: float, dtype=torch.float64) -> torch.Tensor:
    """The documents' side of the joint log-likelihood over the given
    tokens' documents (every token of each of them): sum_d [lgamma(K a) -
    lgamma(L_d + K a) + sum_k (lgamma(n_dk + a) - lgamma(a))], in
    ``dtype``.  ``doc_length``: the lengths of those documents only."""
    _, _, c = doc_topic_pairs(doc, z, num_topics)
    a = torch.tensor(alpha, dtype=dtype, device=c.device)
    Ka = num_topics * a
    inner = (torch.lgamma(c.to(dtype) + a) - torch.lgamma(a)).sum()
    return (inner + (torch.lgamma(Ka)
                     - torch.lgamma(doc_length.to(dtype) + Ka)).sum())


def word_log_likelihood(phi, phi_sum, beta: float, num_words_total: int,
                        dtype=torch.float64) -> torch.Tensor:
    """The words' side: sum_kv (lgamma(phi_kv + b) - lgamma(b)) + sum_k
    (lgamma(V b) - lgamma(phi_sum_k + V b)), in ``dtype``."""
    b = torch.tensor(beta, dtype=dtype, device=phi.device)
    Vb = num_words_total * b
    nz = phi[phi > 0].to(dtype)
    return ((torch.lgamma(nz + b) - torch.lgamma(b)).sum()
            + (torch.lgamma(Vb) - torch.lgamma(phi_sum.to(dtype) + Vb)).sum())
