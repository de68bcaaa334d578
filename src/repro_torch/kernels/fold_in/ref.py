"""Plain PyTorch version of the fold-in kernel.

A transcription of ``repro/kernels/fold_in/ref.py::fold_in_docs_ref`` with
the same decomposed contract: pre-gathered phi rows, explicit z0 and
per-sweep uniforms in; per-doc theta-sum / sparse-draw / S-share partials
out, plus the final assignments z (which the CUDA kernel also returns).  The ELL slice uses ``core.updates.ell_topk`` (the stable order of
``lax.top_k``), never ``torch.topk``.  The CPU path of the port runs this;
on the card it is what the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

from repro_torch.core import updates
from repro_torch.core.sampler import pick_search_block


def fold_in_docs_ref(
    phi_tok,       # (B, L, K) int32 — pre-gathered phi rows
    phi_sum,       # (K,) int32
    hyper,         # (2,) float32 — [alpha, beta]
    uniforms,      # (B, n_sweeps, L, 2) float32
    mask,          # (B, L) int32
    z0,            # (B, L) int32
    *,
    num_words_total: int,
    burn_in: int,
    samples: int,
    ell_capacity: int,
):
    nB, L, K = phi_tok.shape
    P = ell_capacity
    Bb = pick_search_block(K)
    nb = K // Bb
    alpha, beta = hyper[0], hyper[1]
    maskb = mask != 0                                     # (B, L)
    zero = torch.zeros((), dtype=torch.float32, device=phi_tok.device)

    pstar = (phi_tok.to(torch.float32) + beta) / (
        phi_sum.to(torch.float32)[None, None, :]
        + beta * num_words_total)                         # (B, L, K)
    Q = alpha * pstar.sum(-1)                             # (B, L)

    blocks = pstar.reshape(nB, L, nb, Bb)
    bcum = torch.cumsum(blocks.sum(-1), dim=-1)           # (B, L, nb)
    total = bcum[..., -1]

    rows = torch.arange(nB, dtype=torch.int32,
                        device=phi_tok.device)[:, None].expand(nB, L)

    def theta_counts(z):
        return updates.theta_from_z(z, rows, maskb, nB, K)

    def sweep(z, theta, u):
        cnt, tpc = updates.ell_topk(theta, P)             # (B, P)
        gat = tpc.long()[:, None, :].expand(nB, L, P)
        p1 = cnt[:, None, :].to(torch.float32) * torch.gather(pstar, -1, gat)
        p1_cum = torch.cumsum(p1, dim=-1)                 # (B, L, P)
        S = p1_cum[..., -1]

        u1, u2 = u[..., 0], u[..., 1]
        use_sparse = u1 * (S + Q) < S

        j = torch.clamp((p1_cum <= (u2 * S)[..., None]).sum(-1), max=P - 1)
        k_sparse = torch.gather(tpc, 1, j)

        target = u2 * total
        b_idx = torch.clamp((bcum <= target[..., None]).sum(-1), max=nb - 1)
        prev = torch.where(
            b_idx > 0,
            torch.gather(bcum, -1, (b_idx - 1).clamp(min=0)[..., None])[..., 0],
            zero)
        seg = torch.gather(
            blocks, 2, b_idx[..., None, None].expand(nB, L, 1, Bb))[:, :, 0]
        seg_cum = torch.cumsum(seg, dim=-1) + prev[..., None]
        in_b = torch.clamp((seg_cum <= target[..., None]).sum(-1), max=Bb - 1)
        k_dense = b_idx * Bb + in_b

        z_new = torch.where(use_sparse, k_sparse.long(), k_dense)
        z_new = torch.where(maskb, z_new.to(torch.int32), z)
        theta_new = theta_counts(z_new)
        sp = (use_sparse & maskb).to(torch.int32).sum(-1)              # (B,)
        ssq = torch.where(maskb, S / torch.clamp(S + Q, min=1e-30),
                          zero).sum(-1)
        return z_new, theta_new, sp, ssq

    z = z0.to(torch.int32)
    theta = theta_counts(z)
    tsum = torch.zeros((nB, K), dtype=torch.int32, device=phi_tok.device)
    sp_sum = torch.zeros((nB,), dtype=torch.int32, device=phi_tok.device)
    ssq_sum = torch.zeros((nB,), dtype=torch.float32, device=phi_tok.device)
    for s in range(burn_in + samples):
        z, theta, sp, ssq = sweep(z, theta, uniforms[:, s])
        if s >= burn_in:
            tsum += theta
            sp_sum += sp
            ssq_sum += ssq
    return tsum, sp_sum, ssq_sum, z
