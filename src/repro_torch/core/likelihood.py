"""Joint collapsed log-likelihood per token (the paper's Fig. 8 metric) and
held-out document-completion scoring, as in ``repro.core.likelihood``.

log p(w, z | alpha, beta) =
    sum_d [ lgamma(K a) - lgamma(L_d + K a) + sum_k (lgamma(theta_dk + a) - lgamma(a)) ]
  + sum_k [ lgamma(V b) - lgamma(phi_sum_k + V b) ] + sum_kv (lgamma(phi_kv + b) - lgamma(b))

Zero counts contribute exactly 0 to the inner sums, so dense evaluation
needs no masking.  Everything is float32, as in the reference.  phi is
word-major: (V, K).
"""
from __future__ import annotations

import torch

_F = torch.float32


def _lgamma_const(x: float, device) -> torch.Tensor:
    return torch.lgamma(torch.tensor(x, dtype=_F, device=device))


def doc_term(theta: torch.Tensor, doc_length: torch.Tensor,
             alpha: float) -> torch.Tensor:
    """Document side of the joint LL. theta: (D, K) counts; doc_length: (D,)."""
    K = theta.shape[1]
    dev = theta.device
    per_doc = (
        _lgamma_const(K * alpha, dev)
        - torch.lgamma(doc_length.to(_F) + K * alpha)
        + (torch.lgamma(theta.to(_F) + alpha)
           - _lgamma_const(alpha, dev)).sum(-1))
    # empty (padding) docs contribute 0
    return torch.where(doc_length > 0, per_doc,
                       torch.zeros((), dtype=_F, device=dev)).sum()


def word_inner_term(phi_vk: torch.Tensor, beta: float) -> torch.Tensor:
    """sum_kv lgamma(phi_kv + b) - lgamma(b)."""
    return (torch.lgamma(phi_vk.to(_F) + beta)
            - _lgamma_const(beta, phi_vk.device)).sum()


def word_outer_term(phi_sum: torch.Tensor, beta: float,
                    num_words_total: int) -> torch.Tensor:
    """sum_k lgamma(V b) - lgamma(phi_sum_k + V b), with the *global* V."""
    vb = num_words_total * beta
    return (_lgamma_const(vb, phi_sum.device)
            - torch.lgamma(phi_sum.to(_F) + vb)).sum()


def joint_log_likelihood(theta, doc_length, phi_vk, phi_sum, alpha: float,
                         beta: float,
                         num_words_total: int | None = None) -> torch.Tensor:
    V = phi_vk.shape[0] if num_words_total is None else num_words_total
    return (doc_term(theta, doc_length, alpha)
            + word_inner_term(phi_vk, beta)
            + word_outer_term(phi_sum, beta, V))


def heldout_token_log_prob(theta_probs, phi_vk, phi_sum, tokens, mask,
                           beta: float, num_words_total: int):
    """log p(w | theta^, phi^) with phi^ = (phi + b) / (phi_sum + bV).

    theta_probs (B, K) float; phi_vk (V, K) int; tokens/mask (B, L).
    Returns (total log prob, token count) as 0-d tensors."""
    phat = (phi_vk[tokens.long()].to(_F) + beta) / (
        phi_sum.to(_F) + beta * num_words_total)              # (B, L, K)
    p = torch.einsum("blk,bk->bl", phat, theta_probs.to(_F))
    lp = torch.where(mask, torch.log(torch.clamp(p, min=1e-30)),
                     torch.zeros((), dtype=_F, device=p.device))
    return lp.sum(), mask.sum()
