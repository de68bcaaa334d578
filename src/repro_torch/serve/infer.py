"""Fold-in Gibbs inference for unseen documents (the serving hot path).

The port's counterpart of ``repro.serve.infer``.  Given a
*frozen* topic-word model (phi_vk, phi_sum) from a snapshot, estimate the
doc-topic mixture theta of documents the model never trained on: assign
random topics, then run delayed-count Gibbs sweeps where only the document
side moves.  The per-token distribution is the training sampler's Eq. 1
with frozen phi,

    p(z = k | w, d) ∝ theta_dk * p*_w(k)  +  alpha * p*_w(k)
                      `-- p1: sparse --'     `-- p2: dense --'

with the S/Q split over an ELL top-P slice of theta and the two-level
blocked search on the dense side (``kernels/fold_in``).

The (V, K) -> (B, L, K) row gather is a torch index, done once per batch;
everything after it consumes only the gathered rows.  Randomness is data:
the initial assignments and every sweep's uniforms are drawn up front
(``kernels/fold_in/ops.draw_fold_in_randoms``) from a ``torch.Generator``,
or handed in, so the same arrays fed to the JAX package give the same
draws.  On the card the sweeps run the CUDA kernel; on the CPU its plain
PyTorch version (``InferConfig.impl``).

A ``ShardedModelSnapshot`` (phi word-sharded over several devices, all
driven from this one process) assembles the rows under one of two comm
strategies (``InferConfig.comm``, section at the end), each bit-identical
to the dense path on the same randoms.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import updates
from repro_torch.distributed.partition import (doc_slice_bounds,
                                               doc_slice_owner,
                                               plan_token_routing,
                                               route_buckets)
from repro_torch.kernels.fold_in import ops as foldin_ops
from repro_torch.serve.snapshot import ShardedModelSnapshot


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Fold-in schedule: ``burn_in`` discarded sweeps, then ``samples``
    sweeps whose thetas are averaged (posterior-mean estimate)."""

    burn_in: int = 8
    samples: int = 4
    top_k: int = 8
    ell_capacity: int | None = None  # P; None -> min(L, K)
    impl: str = "kernel"             # "kernel" | "ref" (plain version)
    # How a V-sharded snapshot assembles the per-token phi rows:
    #   "psum"    — every shard gathers its own words' rows at full
    #               (B, L, K), zeros elsewhere; the lead device sums them;
    #   "all2all" — request-side token routing: each shard sweeps a doc
    #               slice and fetches only its real tokens' rows from their
    #               owners (bytes scale with tokens, not B*L*K);
    #   "auto"    — the snapshot's own ``comm`` tag.
    comm: str = "auto"               # "auto" | "psum" | "all2all"


class FoldInResult(NamedTuple):
    theta: torch.Tensor        # (B, K) float32 — normalized posterior mean
    top_topics: torch.Tensor   # (B, top_k) int32 — heaviest topics per doc
    top_weights: torch.Tensor  # (B, top_k) float32 — their theta mass
    sparse_frac: torch.Tensor  # () — fraction of draws on the sparse S side
    mean_s_over_sq: torch.Tensor  # () — mean S/(S+Q) over real tokens


def _theta_counts(z: torch.Tensor, mask: torch.Tensor,
                  num_topics: int) -> torch.Tensor:
    """(B, L) assignments -> (B, K) per-doc topic counts."""
    B = z.shape[0]
    rows = torch.arange(B, dtype=torch.int32, device=z.device)[:, None]
    return updates.theta_from_z(z, rows.expand(z.shape), mask, B, num_topics)


def _draw(randoms, B: int, L: int, K: int, n_sweeps: int, device):
    """``randoms`` is a ``torch.Generator`` (drawn here, on ``device``) or
    an already drawn ``(z0 (B, L), uniforms (n_sweeps, B, L, 2))`` pair."""
    if isinstance(randoms, torch.Generator):
        return foldin_ops.draw_fold_in_randoms(randoms, B, L, K, n_sweeps,
                                               device)
    z0, uniforms = randoms
    return (torch.as_tensor(z0, dtype=torch.int32, device=device),
            torch.as_tensor(uniforms, dtype=torch.float32, device=device))


def _fold_in_rows(
    phi_tok: torch.Tensor,   # (B, L, K) int32 — gathered phi rows
    phi_sum: torch.Tensor,   # (K,) int32
    mask: torch.Tensor,      # (B, L) bool — False on padding slots
    randoms,                 # torch.Generator or (z0, uniforms)
    alpha,                   # floats, or 0-d tensors on the device
    beta,
    *,
    num_words_total: int,
    burn_in: int,
    samples: int,
    top_k: int,
    ell_capacity: int | None,
    impl: str,
) -> FoldInResult:
    """The fold-in sweeps, downstream of the per-token phi gather."""
    B, L = mask.shape
    K = phi_sum.shape[0]
    P = min(ell_capacity or L, L, K)
    z0, uniforms = _draw(randoms, B, L, K, burn_in + samples, phi_tok.device)
    tsum, sps, ssqs = foldin_ops.fold_in_sweeps_drawn(
        phi_tok, phi_sum, mask, z0, uniforms, alpha, beta,
        num_words_total=num_words_total, burn_in=burn_in, samples=samples,
        ell_capacity=P, impl=impl)
    n_real = mask.sum().clamp(min=1).to(torch.float32)
    return _assemble(tsum, sps.sum(), ssqs.sum(), alpha, samples, min(top_k, K),
                     n_real * samples)


def _assemble(theta_sum, sp_total, ssq_total, alpha, samples: int, kk: int,
              denom) -> FoldInResult:
    """Sweep partials -> FoldInResult.  The top-k takes ``lax.top_k``'s
    order — value descending, exact ties to the lower topic id, which are
    common (every topic with the same count has the same theta) — by a
    stable sort, not ``torch.topk``."""
    theta_mean = theta_sum.to(torch.float32) / samples + alpha      # (B, K)
    theta_mean = theta_mean / theta_mean.sum(-1, keepdim=True)
    order = torch.sort(-theta_mean, dim=-1, stable=True).indices[:, :kk]
    return FoldInResult(
        theta=theta_mean,
        top_topics=order.to(torch.int32),
        top_weights=torch.gather(theta_mean, 1, order),
        sparse_frac=sp_total / denom,
        mean_s_over_sq=ssq_total / denom,
    )


def _checked_tokens(tokens, mask, num_words: int, device):
    """Word ids -> a (B, L) int64 tensor safe to gather with.

    Raises ValueError on an out-of-vocabulary id under the mask, before the
    gather: on the card an out-of-range index is a device-side assert that
    kills the context (the JAX package clamps it silently instead).  Padding
    slots may hold anything; they gather row 0."""
    tok = torch.as_tensor(tokens).to(device=device, dtype=torch.int64)
    m = torch.as_tensor(mask).to(device=device, dtype=torch.bool)
    real = tok[m]
    if real.numel() and (int(real.min()) < 0 or int(real.max()) >= num_words):
        raise ValueError(f"word ids must be in [0, {num_words})")
    return torch.where(m, tok, torch.zeros_like(tok)), m


def fold_in(
    phi_vk: torch.Tensor,    # (V, K) int32 — frozen topic-word counts
    phi_sum: torch.Tensor,   # (K,) int32
    tokens,                  # (B, L) word ids (anything under mask=False)
    mask,                    # (B, L) bool
    randoms,                 # torch.Generator or (z0, uniforms)
    alpha,
    beta,
    *,
    num_words_total: int,
    burn_in: int = 8,
    samples: int = 4,
    top_k: int = 8,
    ell_capacity: int | None = None,
    impl: str = "kernel",
) -> FoldInResult:
    """Estimate theta for a batch of unseen documents against frozen phi,
    on phi's device.  Validates word ids on the host side of the gather
    (one device->host read when the tokens live on the card)."""
    tok, m = _checked_tokens(tokens, mask, phi_vk.shape[0], phi_vk.device)
    return _fold_in_rows(
        phi_vk[tok], phi_sum, m, randoms, alpha, beta,
        num_words_total=num_words_total, burn_in=burn_in, samples=samples,
        top_k=top_k, ell_capacity=ell_capacity, impl=impl)


# ---------------------------------------------------------------------------
# packed request buffer: ONE host->device transfer per engine batch
# ---------------------------------------------------------------------------
#     row i < B :  [tok_0, ..., tok_{L-1}, doc_length_i]
#     row B     :  [batch_seed, 0, ...]
# The mask is derived on the device (iota < length).  The seed also rides in
# the buffer; the engine, which packed it, seeds the batch's generator from
# its host copy, so no device->host read is needed.


def pack_request_buffer(docs: Sequence[np.ndarray], batch: int, length: int,
                        seed: int) -> np.ndarray:
    """Per-doc word-id arrays -> one (batch+1, length+1) int32 buffer."""
    buf = np.zeros((batch + 1, length + 1), np.int32)
    for i, d in enumerate(docs):
        d = np.asarray(d, np.int32)[:length]
        buf[i, : len(d)] = d
        buf[i, length] = len(d)
    buf[batch, 0] = seed
    return buf


def _unpack_request_buffer(buf: torch.Tensor):
    """(B+1, L+1) device buffer -> tokens (B, L), mask (B, L)."""
    L = buf.shape[1] - 1
    tokens = buf[:-1, :L]
    lengths = buf[:-1, L]
    iota = torch.arange(L, dtype=torch.int32, device=buf.device)
    return tokens, iota[None, :] < lengths[:, None]


def fold_in_buffer(
    phi_vk: torch.Tensor,    # (V, K) int32
    phi_sum: torch.Tensor,   # (K,) int32
    buf: torch.Tensor,       # (B+1, L+1) int32 packed request buffer
    hyper: torch.Tensor,     # (2,) float32 [alpha, beta], staged per snapshot
    *,
    seed: int,
    num_words_total: int,
    burn_in: int = 8,
    samples: int = 4,
    top_k: int = 8,
    ell_capacity: int | None = None,
    impl: str = "kernel",
) -> FoldInResult:
    """``fold_in`` over a packed request buffer (the engine's batch unit).

    Launches only: nothing here waits for the device.  The word ids are not
    re-validated — the engine checks them against the live snapshot before
    packing."""
    tokens, mask = _unpack_request_buffer(buf)
    gen = torch.Generator(device=buf.device)
    gen.manual_seed(int(seed))
    return _fold_in_rows(
        phi_vk[tokens.long()], phi_sum, mask, gen, hyper[0], hyper[1],
        num_words_total=num_words_total, burn_in=burn_in, samples=samples,
        top_k=top_k, ell_capacity=ell_capacity, impl=impl)


def fold_in_request(snap, buf: torch.Tensor, cfg: InferConfig,
                    seed: int | None = None,
                    capacity: int | None = None) -> FoldInResult:
    """One engine batch from a packed request buffer on ``snap``'s (lead)
    device, against a dense or a sharded snapshot.  ``seed=None`` reads it
    from the buffer (one device->host read); the engine passes its host
    copy instead, and under all2all the routing ``capacity`` it planned
    from its host copy of the batch (else this plans it, one more read)."""
    if seed is None:
        seed = int(buf[-1, 0])
    if isinstance(snap, ShardedModelSnapshot):
        tokens, mask = _unpack_request_buffer(buf)
        gen = torch.Generator(device=buf.device)
        gen.manual_seed(int(seed))
        if resolve_comm(snap, cfg) == "all2all" and capacity is None:
            capacity = routing_plan(
                snap, *_host_batch_from_buffer(buf.cpu().numpy())).capacity
        return _fold_in_sharded(snap, tokens.long(), mask, gen, cfg, capacity)
    return fold_in_buffer(
        snap.phi_vk, snap.phi_sum, buf, snap.hyper, seed=seed,
        num_words_total=snap.num_words_total, burn_in=cfg.burn_in,
        samples=cfg.samples, top_k=cfg.top_k, ell_capacity=cfg.ell_capacity,
        impl=cfg.impl)


def fold_in_cost(batch: int, length: int, cfg: InferConfig) -> float:
    """Relative execution-cost model of one fold-in batch: token-sweeps
    dominate, so cost ~ B * L * total sweeps (burn-in + samples + init).
    Dimensionless: the engine's SLO scheduler uses cost *ratios* only."""
    return float(max(batch, 1) * max(length, 1)
                 * (cfg.burn_in + cfg.samples + 1))


def fold_in_config(snapshot, tokens, mask, randoms,
                   cfg: InferConfig) -> FoldInResult:
    """Convenience wrapper: run fold-in from a (dense or sharded) snapshot
    + InferConfig."""
    if isinstance(snapshot, ShardedModelSnapshot):
        return fold_in_sharded(snapshot, tokens, mask, randoms, cfg)
    return fold_in(
        snapshot.phi_vk, snapshot.phi_sum, tokens, mask, randoms,
        snapshot.alpha, snapshot.beta,
        num_words_total=snapshot.num_words_total,
        burn_in=cfg.burn_in, samples=cfg.samples, top_k=cfg.top_k,
        ell_capacity=cfg.ell_capacity, impl=cfg.impl)


def pack_docs(
    docs: Sequence[np.ndarray],
    length: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """List of per-doc word-id arrays -> padded (B, L) tokens + mask.
    Docs longer than ``length`` are truncated."""
    if length is None:
        length = max((len(d) for d in docs), default=1)
    B = len(docs)
    tokens = np.zeros((B, length), np.int32)
    mask = np.zeros((B, length), bool)
    for i, d in enumerate(docs):
        d = np.asarray(d, np.int32)[:length]
        tokens[i, : len(d)] = d
        mask[i, : len(d)] = True
    return tokens, mask


# ---------------------------------------------------------------------------
# V-sharded fold-in: phi blocks on several devices, one process
# ---------------------------------------------------------------------------
# The reference runs these inside ``shard_map`` over a mesh; here one
# process drives every device and its collectives are device-to-device
# copies (``Tensor.to``: peer to peer over NVLink between cards, ordered
# after both devices' current streams, no host sync).
#
# * "psum"    — each shard gathers the rows of the word ids its block owns
#   (zeros elsewhere) at full (B, L, K); the partials are copied to the
#   lead device and summed in int32 (exact); the sweeps run there once.
#
# * "all2all" — request-side token routing.  Shard s takes a contiguous
#   slice of the batch's docs, buckets its real tokens' local-row ids by
#   owning shard (``route_buckets``), sends each bucket to its owner, which
#   gathers the rows, and scatters the rows that come back into its slice.
#   The sweeps (K3) run on shard s's device on that slice only, with the
#   randoms drawn at the full batch shape on the lead and sliced, so every
#   doc draws as in the dense path; per-doc partials come back to the lead,
#   overlapping slices deduplicated.  Launches on different cards are
#   asynchronous, so the slices overlap in time across cards.


def resolve_comm(snap, cfg: InferConfig) -> str:
    """Effective comm strategy: the config's, or — on ``"auto"`` — the
    snapshot's own ``comm`` tag."""
    comm = cfg.comm
    if comm in (None, "auto"):
        comm = getattr(snap, "comm", "psum")
    if comm not in ("psum", "all2all"):
        raise ValueError(f"unknown comm strategy {comm!r} "
                         "(expected 'psum', 'all2all' or 'auto')")
    return comm


def routing_plan(snap, tokens, mask):
    """Host-side all2all routing plan for one batch against a sharded
    snapshot: the bucket capacity plus this batch's bytes moved under both
    comm strategies."""
    return plan_token_routing(snap.host_word_shard_of, np.asarray(tokens),
                              np.asarray(mask), snap.num_shards,
                              snap.num_topics)


def _host_batch_from_buffer(buf):
    """Packed request buffer (host) -> (tokens, mask) for routing plans."""
    b = np.asarray(buf)
    L = b.shape[1] - 1
    tokens, lengths = b[:-1, :L], b[:-1, L]
    return tokens, np.arange(L)[None, :] < lengths[:, None]


def _rows_psum(snap, tokens: torch.Tensor) -> torch.Tensor:
    """(B, L) int64 word ids on the lead -> the (B, L, K) int32 rows there:
    each shard's owned rows, zeros elsewhere, summed in int32 (F3: torch
    widens an int32 sum to int64 unless told)."""
    parts = []
    for s, (blk, rep) in enumerate(zip(snap.phi_blocks, snap.replicas)):
        tok = tokens.to(blk.device, non_blocking=True)
        mine = rep.word_shard_of[tok] == s
        rows = blk[torch.where(mine, rep.word_local_id[tok], 0)]
        rows = torch.where(mine[..., None], rows, 0)     # foreign words: 0
        parts.append(rows.to(snap.device, non_blocking=True))
    return torch.stack(parts).sum(0, dtype=torch.int32)


def _rows_routed(snap, rep, tokens: torch.Tensor, mask: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """One doc slice's (Bs, L) word ids and mask on its requester's device
    (``rep`` its replica) -> its (Bs, L, K) int32 rows there: real tokens'
    ids travel to their owners in (S, C) buckets, the gathered rows come
    back and are gathered into slot order; padding slots get zero rows.
    (A gather, not a scatter of the (S, C, K) rows: the empty bucket slots
    would all scatter onto one spare row, and those conflicting writes
    cost more than the rest of the slice.)"""
    Bs, L = tokens.shape
    S, T = snap.num_shards, Bs * L
    K = snap.num_topics
    dev = tokens.device
    flat = tokens.reshape(T)
    owner = torch.where(mask.reshape(T), rep.word_shard_of[flat], S)
    send, src = route_buckets(owner, rep.word_local_id[flat], S, capacity)
    back = []
    for o, blk in enumerate(snap.phi_blocks):
        ids = send[o].to(blk.device, non_blocking=True).long()
        back.append(blk[ids].to(dev, non_blocking=True))   # (C, K)
    back.append(torch.zeros((1, K), dtype=torch.int32, device=dev))
    # each slot's bucket entry; empty bucket slots land on the spare
    # position T, padding slots keep the zero row S*C
    entry = torch.full((T + 1,), S * capacity, dtype=torch.int64, device=dev)
    entry.index_put_((src.reshape(-1).long(),),
                     torch.arange(S * capacity, device=dev))
    return torch.cat(back)[entry[:T]].view(Bs, L, K)


def _fold_in_sharded(snap, tokens: torch.Tensor, mask: torch.Tensor,
                     randoms, cfg: InferConfig,
                     capacity: int | None) -> FoldInResult:
    """The sharded fold-in on (B, L) int64 ids and bool mask on the lead
    device; launches only, no host sync (the engine's batch path)."""
    B, L = mask.shape
    K = snap.num_topics
    n_sweeps = cfg.burn_in + cfg.samples
    kw = dict(num_words_total=snap.num_words_total, burn_in=cfg.burn_in,
              samples=cfg.samples)
    lead = snap.hyper
    if resolve_comm(snap, cfg) == "psum":
        return _fold_in_rows(
            _rows_psum(snap, tokens), snap.phi_sum, mask, randoms, lead[0],
            lead[1], top_k=cfg.top_k, ell_capacity=cfg.ell_capacity,
            impl=cfg.impl, **kw)
    if capacity is None:
        raise ValueError("comm='all2all' needs the routing plan's capacity")
    S = snap.num_shards
    z0, uniforms = _draw(randoms, B, L, K, n_sweeps, snap.device)
    starts, Bs = doc_slice_bounds(B, S)
    own, row = doc_slice_owner(B, S)
    P = min(cfg.ell_capacity or L, L, K)
    parts = []
    for s, (dev, rep) in enumerate(zip(snap.devices, snap.replicas)):
        sl = slice(int(starts[s]), int(starts[s]) + Bs)
        tok_s = tokens[sl].to(dev, non_blocking=True)
        msk_s = mask[sl].to(dev, non_blocking=True)
        tsum, sp, ssq = foldin_ops.fold_in_sweeps_drawn(
            _rows_routed(snap, rep, tok_s, msk_s, capacity), rep.phi_sum,
            msk_s,
            z0[sl].to(dev, non_blocking=True),
            uniforms[:, sl].to(dev, non_blocking=True), rep.hyper[0],
            rep.hyper[1], ell_capacity=P, impl=cfg.impl, **kw)
        # the rows of the docs shard s officially covers: a contiguous run
        # (overlapping slices keep each doc once)
        rows = row[own == s]
        keep = slice(int(rows[0]), int(rows[-1]) + 1) if rows.size else \
            slice(0, 0)
        parts.append([t[keep].to(snap.device, non_blocking=True)
                      for t in (tsum, sp, ssq)])
    tsum, sp, ssq = (torch.cat(p) for p in zip(*parts))
    n_real = mask.sum().clamp(min=1).to(torch.float32)
    return _assemble(tsum, sp.sum(), ssq.sum(), lead[0], cfg.samples,
                     min(cfg.top_k, K), n_real * cfg.samples)


def fold_in_sharded(snap, tokens, mask, randoms, cfg: InferConfig,
                    capacity: int | None = None) -> FoldInResult:
    """Fold-in against a ``ShardedModelSnapshot``: (B, L) word ids and mask
    (host arrays or tensors), ``randoms`` a ``torch.Generator`` on the lead
    device or a drawn ``(z0, uniforms)`` pair, as ``fold_in`` takes them.
    Validates the word ids (one device->host read) and, under all2all,
    plans the routing capacity from the batch unless given."""
    tok, m = _checked_tokens(tokens, mask, snap.num_words, snap.device)
    if resolve_comm(snap, cfg) == "all2all" and capacity is None:
        capacity = routing_plan(snap, tok.cpu().numpy(),
                                m.cpu().numpy()).capacity
    return _fold_in_sharded(snap, tok, m, randoms, cfg, capacity)
