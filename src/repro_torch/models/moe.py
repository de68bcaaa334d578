"""Mixture-of-Experts FFN (qwen3-moe family): top-k routing with a fixed
per-expert capacity.

The port of ``repro.models.moe``'s local dispatch: softmax over experts,
top-k, renormalised combine weights; each (token, k) routing takes the
next free slot of its expert's capacity buffer in token-major order, and
routings past the capacity ``C = max(1, int(T*K/E*cf))`` are dropped.  C
depends on the token count T, so a prefill and a token-by-token decode of
the same prompt drop different routings: that is the reference's
semantics, not a fault.

The top-k is a stable descending sort, not ``torch.topk``: ``lax.top_k``
returns the lower expert id first on equal probabilities, and the order
fixes the capacity ranks.  Over a mesh with a tp axis the reference
dispatches to its expert-parallel ``moe_ffn_ep`` (a ``shard_map`` with an
all-to-all over the model axis); that is ROADMAP item 13d, not ported, and
``moe_ffn`` raises there rather than run the experts replicated (a
different program from the reference's).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import NO_SHARDING, ModelConfig, P, ShardingPolicy, init_dense

MESH_MOE = ("the expert-parallel MoE over a mesh (moe_ffn_ep) is ROADMAP "
            "item 13d, not ported")


class MoEParams(NamedTuple):
    router: torch.Tensor      # (D, E)
    w_gate: torch.Tensor      # (E, D, F)
    w_up: torch.Tensor        # (E, D, F)
    w_down: torch.Tensor      # (E, F, D)


def init_moe(cfg: ModelConfig, generator: torch.Generator) -> MoEParams:
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    g = generator
    return MoEParams(
        router=init_dense((D, E), D ** -0.5, torch.float32, generator=g),
        w_gate=init_dense((E, D, Fd), D ** -0.5, cfg.dtype, generator=g),
        w_up=init_dense((E, D, Fd), D ** -0.5, cfg.dtype, generator=g),
        w_down=init_dense((E, Fd, D), Fd ** -0.5, cfg.dtype, generator=g),
    )


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``'s order: descending, the lower index first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_specs(cfg: ModelConfig, policy: ShardingPolicy) -> MoEParams:
    """The specs of one layer's ``MoEParams``: experts over tp."""
    return MoEParams(router=P(policy._fs(), None), w_gate=policy.p_moe_in(),
                     w_up=policy.p_moe_in(), w_down=policy.p_moe_out())


def moe_ffn(p: MoEParams, cfg: ModelConfig, x: torch.Tensor, *,
            policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """The local dispatch; over a mesh with a tp axis (the reference's
    expert-parallel path) it raises, naming ROADMAP item 13d."""
    if policy.enabled and policy.tp is not None and policy.mesh is not None:
        raise NotImplementedError(MESH_MOE)
    return moe_ffn_local(p, cfg, x)


def moe_ffn_local(p: MoEParams, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    C = max(1, int(T * K / E * cfg.capacity_factor))
    xt = x.reshape(T, D)

    probs = torch.softmax(xt.float() @ p.router, dim=-1)           # (T, E)
    gate_vals, gate_idx = top_k(probs, K)                          # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # rank of each (token, k) inside its expert's capacity buffer: the
    # cumulative count of earlier routings to the same expert
    flat_e = gate_idx.reshape(T * K)
    flat_oh = F.one_hot(flat_e, E).to(torch.int32)                 # (T*K, E)
    rank = ((torch.cumsum(flat_oh, 0, dtype=torch.int32) - flat_oh)
            * flat_oh).sum(-1)
    keep = rank < C                                                # capacity drop
    slot = torch.where(keep, rank, 0).long()

    # dispatch: scatter tokens into per-expert buffers (E, C, D)
    src = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    src = torch.where(keep[:, None], src, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    xe = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    xe.index_put_((flat_e, slot), src, accumulate=True)

    h = torch.einsum("ecd,edf->ecf", xe, p.w_gate.to(x.dtype))
    u = torch.einsum("ecd,edf->ecf", xe, p.w_up.to(x.dtype))
    h = F.silu(h) * u
    ye = torch.einsum("ecf,efd->ecd", h, p.w_down.to(x.dtype))     # (E, C, D)

    # combine: gather each routing's output, weight, sum over k
    yk = ye[flat_e, slot]                                          # (T*K, D)
    yk = yk * (keep[:, None] * gate_vals.reshape(T * K)[:, None]).to(x.dtype)
    return yk.reshape(T, K, D).sum(1).reshape(B, S, D)
