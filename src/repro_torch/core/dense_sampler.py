"""Dense O(K) CGS sampler — the baseline CuLDA_CGS improves on (paper §2.1),
as in ``repro.core.dense_sampler``.

Per token the full p(k) = (theta_dk + a) p*(k) is formed and sampled by
prefix sum + search.  Same delayed-count semantics, tiling and update path
as the sparsity-aware sampler, so a comparison isolates C4/C5/C7.  In the
JAX package this is an XLA scan, not a Pallas kernel, so it stays plain
PyTorch here.  Its randomness is data: one uniform per token, (n, t).
"""
from __future__ import annotations

import torch


def draw_dense_uniforms(generator: torch.Generator, n: int, t: int,
                        device=None) -> torch.Tensor:
    """The dense sweep's (n, t) float32 uniforms in [0, 1)."""
    dev = generator.device if device is None else device
    return torch.rand((n, t), generator=generator, dtype=torch.float32,
                      device=dev)


def sample_tiles_dense(phi_rows, phi_sum, token_doc, token_mask, z_old,
                       theta, uniforms, *, alpha: float, beta: float,
                       num_words_total: int) -> torch.Tensor:
    """c tiles at once: phi_rows (c, K), token_doc/token_mask/z_old (c, t),
    theta (D, K) dense counts, uniforms (c, t).  Returns z_new (c, t)."""
    ps = (phi_rows.to(torch.float32) + beta) / (
        phi_sum.to(torch.float32) + beta * num_words_total)       # (c, K)
    th = theta[token_doc.long()].to(torch.float32)                # (c, t, K)
    cum = torch.cumsum((th + alpha) * ps[:, None, :], dim=-1)
    target = uniforms * cum[..., -1]
    k = torch.clamp((cum <= target[..., None]).sum(-1), max=cum.shape[-1] - 1)
    return torch.where(token_mask, k.to(z_old.dtype), z_old)


def sample_one_tile_dense(phi_col, phi_sum, token_doc, token_mask, z_old,
                          theta, uniforms, *, alpha: float, beta: float,
                          num_words_total: int) -> torch.Tensor:
    """One word tile: phi_col (K,), token_doc/token_mask/z_old/uniforms (t,)."""
    return sample_tiles_dense(
        phi_col[None], phi_sum, token_doc[None], token_mask[None],
        z_old[None], theta, uniforms[None], alpha=alpha, beta=beta,
        num_words_total=num_words_total)[0]


def sample_sweep_dense(phi_vk, phi_sum, tile_word, token_doc, token_mask, z,
                       theta, uniforms, *, alpha: float, beta: float,
                       num_words_total: int,
                       tiles_per_step: int = 8) -> torch.Tensor:
    """Full dense sweep against frozen counts, chunked by
    ``tiles_per_step`` tiles (a chunk holds a (c, t, K) float table).
    ``uniforms`` is an (n, t) tensor or a ``torch.Generator``."""
    n, t = z.shape
    if isinstance(uniforms, torch.Generator):
        uniforms = draw_dense_uniforms(uniforms, n, t, z.device)
    c = max(1, int(tiles_per_step))
    parts = [sample_tiles_dense(
        phi_vk[tile_word[a:a + c].long()], phi_sum, token_doc[a:a + c],
        token_mask[a:a + c], z[a:a + c], theta, uniforms[a:a + c],
        alpha=alpha, beta=beta, num_words_total=num_words_total)
        for a in range(0, n, c)]
    return torch.cat(parts) if parts else z.clone()
