"""Sparsity-aware S/Q sampler with the blocked two-level search (paper §6.1),
as in ``repro.core.sampler``.

* C7 sub-expression reuse: per word tile, p*(k) = (phi_kv + b)/(phi_sum_k + bV)
  once, shared by every token of the word.
* C4 sparsity-aware split: p(k) = p1(k) + p2(k) with p1 = theta_dk p*(k)
  over the <= P non-zero topics of doc d (ELL) and p2 = a p*(k); S = sum p1
  per token, Q = a sum p* per tile.
* C5 two-level blocked search: nb = K/B block sums, then the B entries of
  the winning block.  The block width policy must match the reference (128
  when it divides K, else the largest power of two that does), or draws
  diverge.

Randomness is data: a sweep takes its (n, t, 2) uniforms as a tensor, or
draws them from a ``torch.Generator`` with ``draw_sweep_uniforms``.  The
functions here are the plain PyTorch version of the training sweep; on a
card the trainer runs the CUDA kernel of ``repro_torch.kernels.lda_sample``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

SEARCH_BLOCK = 128  # level-1 tree arity


class SamplerStats(NamedTuple):
    """Per-sweep diagnostics (0-d tensors)."""

    sparse_frac: torch.Tensor      # fraction of tokens drawn from p1
    mean_s_over_sq: torch.Tensor   # mean over tokens of S/(S+Q)


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
    return _blocked_search_rows(pstar[None], u[None])[0]


def _blocked_search_rows(pstar: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Row-batched blocked search: pstar (c, K), u (c, t) -> (c, t) int32."""
    c, K = pstar.shape
    B = pick_search_block(K)
    nb = K // B
    blocks = pstar.reshape(c, nb, B)
    bcum = torch.cumsum(blocks.sum(dim=-1), dim=-1)              # (c, nb)
    target = u * bcum[:, -1:]
    b_idx = torch.clamp((bcum[:, None, :] <= target[..., None]).sum(-1),
                        max=nb - 1)                              # (c, t)
    prev = torch.where(
        b_idx > 0, torch.gather(bcum, 1, (b_idx - 1).clamp(min=0)),
        torch.zeros((), dtype=bcum.dtype, device=bcum.device))
    seg = torch.gather(blocks, 1, b_idx[..., None].expand(c, u.shape[1], B))
    seg_cum = torch.cumsum(seg, dim=-1) + prev[..., None]
    in_b = torch.clamp((seg_cum <= target[..., None]).sum(-1), max=B - 1)
    return (b_idx * B + in_b).to(torch.int32)


def draw_sweep_uniforms(generator: torch.Generator, n: int, t: int,
                        device=None) -> torch.Tensor:
    """The sweep's (n, t, 2) float32 uniforms in [0, 1): [..., 0] picks the
    side (sparse or dense), [..., 1] the topic.  The generator must live on
    ``device`` (its own device when not given)."""
    dev = generator.device if device is None else device
    return torch.rand((n, t, 2), generator=generator, dtype=torch.float32,
                      device=dev)


def draw_initial_topics(generator: torch.Generator, shape, num_topics: int,
                        device=None) -> torch.Tensor:
    """Uniform random initial topic assignments of ``shape``, int32 in
    [0, num_topics), from ``generator`` (on ``device``, its own when not
    given)."""
    dev = generator.device if device is None else device
    return torch.randint(0, num_topics, tuple(shape), generator=generator,
                         dtype=torch.int32, device=dev)


def sample_tiles(
    phi_rows: torch.Tensor,     # (c, K) int — each tile's word row
    phi_sum: torch.Tensor,      # (K,) int
    token_doc: torch.Tensor,    # (c, t) int32 local doc ids
    token_mask: torch.Tensor,   # (c, t) bool
    z_old: torch.Tensor,        # (c, t) current topics (kept on padding)
    ell_counts: torch.Tensor,   # (D, P) int
    ell_topics: torch.Tensor,   # (D, P) int
    uniforms: torch.Tensor,     # (c, t, 2) float32
    *,
    alpha: float,
    beta: float,
    num_words_total: int,
):
    """``sample_one_tile`` for c tiles at once.  Returns (z_new (c, t) like
    z_old, used_sparse (c, t) bool, s_over_sq (c, t) float32, 0 on
    padding)."""
    ps = pstar(phi_rows, phi_sum[None, :], beta, num_words_total)  # (c, K)
    Q = alpha * ps.sum(dim=-1)                                     # (c,)

    # sparse side: p1 over the ELL rows of each token's doc
    doc = token_doc.long()
    tpc = ell_topics[doc].long()                                   # (c, t, P)
    cnt = ell_counts[doc].to(torch.float32)
    p1 = cnt * torch.gather(ps[:, None, :].expand(-1, tpc.shape[1], -1),
                            2, tpc)
    p1_cum = torch.cumsum(p1, dim=-1)
    S = p1_cum[..., -1]                                            # (c, t)

    u1, u2 = uniforms[..., 0], uniforms[..., 1]
    use_sparse = u1 * (S + Q[:, None]) < S

    # sparse draw: search the P-entry prefix sums
    j = torch.clamp((p1_cum <= (u2 * S)[..., None]).sum(-1),
                    max=tpc.shape[-1] - 1)
    k_sparse = torch.gather(tpc, 2, j[..., None])[..., 0]

    # dense draw: two-level blocked search over p* (C5)
    k_dense = _blocked_search_rows(ps, u2).long()

    z_new = torch.where(use_sparse, k_sparse, k_dense).to(z_old.dtype)
    z_new = torch.where(token_mask, z_new, z_old)
    s_over_sq = torch.where(
        token_mask, S / torch.clamp(S + Q[:, None], min=1e-30),
        torch.zeros((), dtype=S.dtype, device=S.device))
    return z_new, use_sparse & token_mask, s_over_sq


def sample_one_tile(phi_col, phi_sum, token_doc, token_mask, z_old,
                    ell_counts, ell_topics, uniforms, *, alpha: float,
                    beta: float, num_words_total: int):
    """Sample new topics for every token of one word tile.

    phi_col (K,), token_doc/token_mask/z_old (t,), uniforms (t, 2).  Returns
    (z_new (t,), used_sparse (t,) bool, s_over_sq (t,) float32)."""
    out = sample_tiles(phi_col[None], phi_sum, token_doc[None],
                       token_mask[None], z_old[None], ell_counts, ell_topics,
                       uniforms[None], alpha=alpha, beta=beta,
                       num_words_total=num_words_total)
    return tuple(o[0] for o in out)


def sample_sweep_tokens(
    phi_vk: torch.Tensor,       # (V, K) int — word-major
    phi_sum: torch.Tensor,      # (K,) int — global per-topic totals
    tile_word: torch.Tensor,    # (n,) int32
    token_doc: torch.Tensor,    # (n, t) int32
    token_mask: torch.Tensor,   # (n, t) bool
    z: torch.Tensor,            # (n, t) current assignments
    ell_counts: torch.Tensor,   # (D, P)
    ell_topics: torch.Tensor,   # (D, P)
    uniforms: torch.Tensor,     # (n, t, 2) float32
    *,
    alpha: float,
    beta: float,
    num_words_total: int,
    tiles_per_step: int = 64,
):
    """Full delayed-count sweep, every tile against the frozen counts: the
    plain PyTorch version of the fused sweep kernel, per token.

    Chunked by ``tiles_per_step`` tiles: the (c, t, P) intermediates of a
    whole NYTimes sweep would be ~128 GB.  Chunking never changes a draw —
    tiles are independent given the uniforms.  Returns (z_new (n, t) like z,
    used_sparse (n, t) bool, s_over_sq (n, t) float32)."""
    n, t = z.shape
    c = max(1, int(tiles_per_step))
    outs = [sample_tiles(
        phi_vk[tile_word[a:a + c].long()], phi_sum, token_doc[a:a + c],
        token_mask[a:a + c], z[a:a + c], ell_counts, ell_topics,
        uniforms[a:a + c], alpha=alpha, beta=beta,
        num_words_total=num_words_total) for a in range(0, n, c)]
    if not outs:
        return (z.clone(), torch.zeros_like(token_mask),
                torch.zeros(z.shape, dtype=torch.float32, device=z.device))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def sweep_stats(token_mask: torch.Tensor, used_sparse: torch.Tensor,
                s_over_sq: torch.Tensor) -> SamplerStats:
    """Per-token sweep outputs -> the sweep's means over real tokens."""
    total = torch.clamp(token_mask.sum(), min=1)
    return SamplerStats(sparse_frac=used_sparse.sum() / total,
                        mean_s_over_sq=s_over_sq.sum() / total)


def sample_sweep(phi_vk, phi_sum, tile_word, token_doc, token_mask, z,
                 ell_counts, ell_topics, uniforms, *, alpha: float,
                 beta: float, num_words_total: int, tiles_per_step: int = 64):
    """``sample_sweep_tokens`` reduced to (z_new, SamplerStats), as
    ``repro.core.sampler.sample_sweep``; ``uniforms`` is an (n, t, 2)
    tensor or a ``torch.Generator``."""
    if isinstance(uniforms, torch.Generator):
        uniforms = draw_sweep_uniforms(uniforms, *z.shape, z.device)
    z_new, sp, ssq = sample_sweep_tokens(
        phi_vk, phi_sum, tile_word, token_doc, token_mask, z, ell_counts,
        ell_topics, uniforms, alpha=alpha, beta=beta,
        num_words_total=num_words_total, tiles_per_step=tiles_per_step)
    return z_new, sweep_stats(token_mask, sp, ssq)
