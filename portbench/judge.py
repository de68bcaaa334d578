"""The comparison that decides ``correct`` for an LDA training cell.

After the window, the program's last step is judged against the plain
reference (``reference/lda.py``), which works everything out again from
the benchmark's corpus and the topics the program reports:

* ``layout_errors``: the program's tiling read back against the corpus:
  every real slot's token index (``token_uid``) names a token of the
  corpus, every token is held by exactly one slot over all ranks, and
  the slot's word and document (``tile_word``, ``doc_global[token_doc]``)
  are that token's.  Only then can the program's topics be read per
  token.  Exact: limit 0.
* ``phi_errors``: entries of the program's phi_vk and phi_sum after the
  last step (every rank's replica) that differ from the counts of its
  topics: the phi advance (K2) and, on several ranks, the sync.  Exact.
* ``ell_errors``: entries of the ELL the program builds from the topics
  before the last step (``trainer.theta_and_ell``) that differ from the
  reference's, over each document's live entries and live length.
  Exact.
* ``flip_rate``: the share of tokens whose new topic differs from the
  reference's draw, the reference drawing with the same uniforms against
  its own counts of the topics before the step (K1, with theta, the ELL
  and phi it read).
* ``flip_margin``: over those tokens, the largest shift of the uniforms
  that the reference's rule needs, in exact arithmetic, to draw the
  program's topic (``reference.flip_margins``): float rounding at a
  boundary needs a shift of the order of float32's rounding, a draw
  altered or drawn from other counts a large one.
* ``ll_rel_err``: the program's last log-likelihood against the
  reference's, computed in float64 from the counts of the program's
  topics, as a share of the reference's.

On several ranks each rank judges its own tokens and replica; the readings
are summed (errors, flips) or their largest taken (margin, LL) over the
ranks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from portbench.reference import lda as ref

MARGIN_CAP = 1 << 16     # flipped tokens whose margin is computed
UNREADABLE = 1e300       # a reading that a broken layout leaves unknown
EXACT = ("layout_errors", "phi_errors", "ell_errors")
NAMES = EXACT + ("flip_rate", "flip_margin", "ll_rel_err")


@dataclasses.dataclass
class Problem:
    """What the judge reads: the benchmark's corpus and the program's
    setting (from the cell's files and the seed)."""
    doc_ids: np.ndarray
    word_ids: np.ndarray
    num_docs: int
    num_words: int
    num_topics: int
    alpha: float
    beta: float
    seed: int
    ranks: int
    rank: int


@dataclasses.dataclass
class Outputs:
    """One rank's program outputs around its last step."""
    prev_z: torch.Tensor        # (n, t) topics before the step
    z: torch.Tensor             # (n, t) after
    phi: torch.Tensor           # (V, K) after
    phi_sum: torch.Tensor       # (K,) after
    ell_counts: torch.Tensor    # (D_local, P) built from prev_z
    ell_topics: torch.Tensor
    ll_per_token: float         # the log-likelihood after the step
    iteration: int              # the step's iteration
    rows: int                   # the uniforms' rows (the padded tiles)
    tile_word: torch.Tensor
    token_doc: torch.Tensor
    token_mask: torch.Tensor
    token_uid: torch.Tensor
    doc_global: torch.Tensor


def _sum(x: torch.Tensor, pb: Problem, op=None) -> torch.Tensor:
    if pb.ranks > 1:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM)
    return x


def canonical(pb: Problem, out: Outputs, doc_d, word_d):
    """Read the program's tiled topics per token: (layout_errors, this
    rank's token indices in corpus order, their topics before and after
    the step, their uniforms)."""
    dev = out.z.device
    T = doc_d.numel()
    mask = out.token_mask.bool()
    uid = out.token_uid[mask].long()
    errors = ((uid < 0) | (uid >= T)).sum()
    uid = uid.clamp(0, T - 1)
    held = torch.bincount(uid, minlength=T).clamp(max=2).to(torch.uint8)
    _sum(held, pb)
    if pb.rank == 0:
        errors = errors + (held != 1).sum()
    n, t = out.z.shape
    word_slot = out.tile_word[:, None].expand(n, t)[mask]
    doc_slot = out.doc_global.long()[out.token_doc[mask].long()]
    errors = errors + (word_d[uid] != word_slot).sum() \
        + (doc_d[uid] != doc_slot).sum()
    order = torch.argsort(uid)
    uniforms = ref.iteration_uniforms(pb.seed, out.iteration,
                                      pb.rank if pb.ranks > 1 else None,
                                      out.rows, t, dev)
    u = uniforms[:n][mask][order]
    del uniforms
    return (errors, uid[order], out.prev_z[mask][order].long(),
            out.z[mask][order].long(), u)


def global_topics(pb: Problem, tok, z_r, T: int) -> torch.Tensor:
    """(T,) the corpus's topics from every rank's tokens (-1 where none
    holds the token)."""
    g = torch.zeros(T, dtype=torch.int32, device=z_r.device)
    g[tok] = z_r.int() + 1
    return _sum(g, pb).long() - 1


def judge(pb: Problem, doc_d, word_d, tok, zp_r, zn_r, u_r, phi, phi_sum,
          ell_counts, ell_topics, doc_rows, ll_per_token: float,
          layout_errors, counts: bool = False):
    """The readings of one step (see the module docstring), reduced over
    the ranks; with ``counts`` also this rank's least-work inputs
    (``roofline/counts.py``).  ``layout_errors`` is this rank's count."""
    dev = doc_d.device
    T, D, V, K = doc_d.numel(), pb.num_docs, pb.num_words, pb.num_topics
    layout = _sum(torch.tensor([float(layout_errors)], dtype=torch.float64,
                               device=dev), pb)
    if layout[0] > 0:       # the topics cannot be read per token
        return dict(dict.fromkeys(NAMES, UNREADABLE),
                    layout_errors=float(layout[0])), None
    exact = torch.zeros(2, dtype=torch.float64, device=dev)
    zp_g = global_topics(pb, tok, zp_r, T)
    zn_g = global_topics(pb, tok, zn_r, T)
    phi_prev = ref.topic_word_counts(word_d, zp_g, V, K)
    phi_new = ref.topic_word_counts(word_d, zn_g, V, K)
    psum_new = phi_new.sum(0)
    exact[0] = ((phi.long() != phi_new).sum()
                + (phi_sum.long() != psum_new).sum())

    rc, rt, live = ref.ell(doc_d, zp_g, D, K)
    rows = doc_rows.long()
    live_p = (ell_counts > 0).sum(1)
    W = min(ell_counts.shape[1], rc.shape[1])
    held = ell_counts[:, :W] > 0
    exact[1] = ((live_p != live[rows]).sum()
                + (ell_counts[:, :W].long() != rc[rows, :W]).sum()
                + ((ell_topics[:, :W].long() != rt[rows, :W]) & held).sum())

    tables = ref.WordTables(phi_prev, phi_prev.sum(0), pb.alpha, pb.beta, V)
    w_r, d_r = word_d[tok], doc_d[tok]
    z_ref, sparse = ref.sample(tables, rc, rt, w_r, d_r, u_r)
    del tables
    flipped = torch.nonzero(z_ref != zn_r).flatten()
    flips = flipped.numel()
    if flips > MARGIN_CAP:
        gen = torch.Generator(device=dev)
        gen.manual_seed(pb.seed % (1 << 63))
        flipped = flipped[torch.randperm(flips, generator=gen,
                                         device=dev)[:MARGIN_CAP]]
    margin = 0.0
    if flipped.numel():
        margin = float(ref.flip_margins(
            phi_prev, phi_prev.sum(0), pb.alpha, pb.beta, V, rc, rt,
            w_r[flipped], d_r[flipped], u_r[flipped], zn_r[flipped]).max())

    lengths = torch.bincount(doc_d.long(), minlength=D)
    ll_ref = float(ref.doc_log_likelihood(doc_d, zn_g, lengths, K, pb.alpha)
                   + ref.word_log_likelihood(phi_new, psum_new, pb.beta, V))
    ll_rel = abs(ll_per_token * T - ll_ref) / abs(ll_ref)

    least = None
    if counts:
        least = dict(
            tokens=int(tok.numel()),
            words=int(torch.unique(w_r).numel()),
            docs_live=int(live[torch.unique(d_r)].sum()),
            pairs_live=int(live[torch.unique(w_r.long() * D + d_r.long())
                                % D].sum()),
            sparse_steps=int(torch.ceil(torch.log2(
                live[d_r.long()][sparse].double() + 1)).sum()),
            dense_tokens=int((~sparse).sum()),
            changed_entries=int(torch.count_nonzero(
                ref.topic_word_counts(w_r, zn_r, V, K)
                - ref.topic_word_counts(w_r, zp_r, V, K))))

    _sum(exact, pb)
    sums = _sum(torch.tensor([float(flips), float(tok.numel())],
                             dtype=torch.float64, device=dev), pb)
    worst = _sum(torch.tensor([margin, ll_rel], dtype=torch.float64,
                              device=dev), pb, dist.ReduceOp.MAX)
    readings = dict(layout_errors=0.0,
                    phi_errors=float(exact[0]), ell_errors=float(exact[1]),
                    flip_rate=float(sums[0] / sums[1]),
                    flip_margin=float(worst[0]), ll_rel_err=float(worst[1]))
    return readings, least

