"""Fold-in Gibbs inference for unseen documents (the serving hot path).

The port's counterpart of ``repro.serve.infer``, dense path.  Given a
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
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import updates
from repro_torch.kernels.fold_in import ops as foldin_ops


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Fold-in schedule: ``burn_in`` discarded sweeps, then ``samples``
    sweeps whose thetas are averaged (posterior-mean estimate)."""

    burn_in: int = 8
    samples: int = 4
    top_k: int = 8
    ell_capacity: int | None = None  # P; None -> min(L, K)
    impl: str = "kernel"             # "kernel" | "ref" (plain version)


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
                    seed: int | None = None) -> FoldInResult:
    """One engine batch from a packed request buffer on ``snap``'s device.
    ``seed=None`` reads it from the buffer (one device->host read); the
    engine passes its host copy instead."""
    if seed is None:
        seed = int(buf[-1, 0])
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
    """Convenience wrapper: run fold-in from a snapshot + InferConfig."""
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
