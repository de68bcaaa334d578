"""Held-out document-completion scoring (``repro.core.likelihood``'s
``heldout_token_log_prob``).  The joint log-likelihood terms arrive with
the training slice."""
from __future__ import annotations

import torch


def heldout_token_log_prob(theta_probs, phi_vk, phi_sum, tokens, mask,
                           beta: float, num_words_total: int):
    """log p(w | theta^, phi^) with phi^ = (phi + b) / (phi_sum + bV).

    theta_probs (B, K) float; phi_vk (V, K) int; tokens/mask (B, L).
    Returns (total log prob, token count) as 0-d tensors."""
    f = torch.float32
    phat = (phi_vk[tokens.long()].to(f) + beta) / (
        phi_sum.to(f) + beta * num_words_total)              # (B, L, K)
    p = torch.einsum("blk,bk->bl", phat, theta_probs.to(f))
    lp = torch.where(mask, torch.log(torch.clamp(p, min=1e-30)),
                     torch.zeros((), dtype=f, device=p.device))
    return lp.sum(), mask.sum()
