"""Mixture-of-Experts FFN (qwen3-moe family): top-k routing with a fixed
per-expert capacity, on one device or expert-parallel over a mesh.

The port of ``repro.models.moe``: softmax over experts, top-k,
renormalised combine weights; each (token, k) routing takes the next free
slot of its expert's capacity buffer in token-major order, and routings
past the capacity are dropped.  The capacity depends on the token count,
so a prefill and a token-by-token decode of the same prompt drop different
routings, and so do one device and a mesh: that is the reference's
semantics, not a fault.

The top-k is a stable descending sort, not ``torch.topk``: ``lax.top_k``
returns the lower expert id first on equal probabilities, and the order
fixes the capacity ranks.

Over a mesh with a tp axis ``moe_ffn`` runs ``moe_ffn_ep``, the
reference's expert parallelism (its ``shard_map``): each tp rank holds
E / tp experts, dispatches its own tokens into all E buffers, and an
all-to-all over tp brings every expert its tokens from every rank and
takes the outputs back (``parallel.all_to_all``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import parallel
from .common import NO_SHARDING, ModelConfig, P, ShardingPolicy, init_dense


class MoEParams(NamedTuple):
    router: torch.Tensor      # (D, E)
    w_gate: torch.Tensor      # (E, D, F)
    w_up: torch.Tensor        # (E, D, F)
    w_down: torch.Tensor      # (E, F, D)


class Routing(NamedTuple):
    """The (token, k) routings of T tokens, token-major: each one's expert,
    its slot in that expert's buffer, whether it fits the capacity, and its
    combine weight."""

    expert: torch.Tensor      # (T*K,) int64
    slot: torch.Tensor        # (T*K,) int64, 0 where dropped
    keep: torch.Tensor        # (T*K,) bool
    gate: torch.Tensor        # (T*K,) float32


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


def ep_capacity(tokens: int, cfg: ModelConfig) -> int:
    """A shard's capacity in ``moe_ffn_ep``: ceil(T K / E), times the
    capacity factor (the reference's per-shard rule, not the local one)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    return max(1, int(max(1, -(-tokens * K // E)) * cfg.capacity_factor))


def _router_logits(xt: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    return xt.float() @ router


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          C: int) -> Routing:
    """The routings of the tokens ``xt`` (T, D) into buffers of capacity
    ``C``: a routing's rank in its expert's buffer is the count of earlier
    routings to the same expert."""
    return route_logits(_router_logits(xt, router), cfg, C)


def route_logits(logits: torch.Tensor, cfg: ModelConfig, C: int) -> Routing:
    """``route`` from the router's float32 logits (T, E)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(logits, dim=-1)                          # (T, E)
    gate_vals, gate_idx = top_k(probs, K)                          # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = gate_idx.reshape(-1)
    flat_oh = F.one_hot(flat_e, E).to(torch.int32)                 # (T*K, E)
    rank = ((torch.cumsum(flat_oh, 0, dtype=torch.int32) - flat_oh)
            * flat_oh).sum(-1)
    keep = rank < C                                                # capacity drop
    return Routing(flat_e, torch.where(keep, rank, 0).long(), keep,
                   gate_vals.reshape(-1))


def dispatch(xt: torch.Tensor, r: Routing, E: int, C: int) -> torch.Tensor:
    """The tokens scattered into per-expert buffers (E, C, D)."""
    T, D = xt.shape
    K = r.expert.shape[0] // T
    src = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    src = torch.where(r.keep[:, None], src,
                      torch.zeros((), dtype=xt.dtype, device=xt.device))
    xe = torch.zeros((E, C, D), dtype=xt.dtype, device=xt.device)
    return xe.index_put_((r.expert, r.slot), src, accumulate=True)


def _up(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ecd,edf->ecf", xe, w.to(xe.dtype))


def _down(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ecf,efd->ecd", h, w.to(h.dtype))


def experts(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, ctx=None) -> torch.Tensor:
    """Each expert's SwiGLU on its buffer: (E, C, D) -> (E, C, D).  With
    ``ctx`` (decode over a mesh) the weights are FSDP shards, used where
    they lie (``parallel.dp_dense`` over the buffers' slots)."""
    if ctx is None:
        up, down = _up, _down
    else:
        up = lambda a, w: parallel.dp_dense(  # noqa: E731
            _up, a, w, ctx, contract_dim=-1, rows=1)
        down = lambda a, w: parallel.dp_dense(  # noqa: E731
            _down, a, w, ctx, out_dim=-1, rows=1)
    h = up(xe, w_gate)
    u = up(xe, w_up)
    return down(F.silu(h) * u, w_down)


def combine(ye: torch.Tensor, r: Routing, T: int) -> torch.Tensor:
    """Each routing's output gathered and weighted, summed over k: (T, D)."""
    yk = ye[r.expert, r.slot]                                      # (T*K, D)
    yk = yk * (r.keep[:, None] * r.gate[:, None]).to(ye.dtype)
    return yk.reshape(T, -1, ye.shape[-1]).sum(1)


def moe_ffn(p: MoEParams, cfg: ModelConfig, x: torch.Tensor, *,
            policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """The expert-parallel path on a mesh, the local dispatch otherwise (the
    reference's rule)."""
    if policy.enabled and policy.tp is not None and policy.mesh is not None:
        return moe_ffn_ep(p, cfg, x, policy)
    return moe_ffn_local(p, cfg, x)


def moe_ffn_local(p: MoEParams, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); capacity ``max(1, int(T K / E cf))``."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    C = max(1, int(T * K / E * cfg.capacity_factor))
    xt = x.reshape(T, D)
    r = route(xt, p.router, cfg, C)
    ye = experts(dispatch(xt, r, E, C), p.w_gate, p.w_up, p.w_down)
    return combine(ye, r, T).reshape(B, S, D)


def _to_owners(xe: torch.Tensor, ctx) -> torch.Tensor:
    """(E, C, D) buffers of this rank's tokens -> (E/tp, tp*C, D): this
    rank's experts, peer j's tokens in slots [j*C, (j+1)*C) (the
    reference's ``all_to_all(split_axis=0, concat_axis=1, tiled=True)``)."""
    n = ctx.tp_size
    E, C, D = xe.shape
    got = parallel.all_to_all(xe, ctx)              # (peer, E/tp, C, D)
    return got.reshape(n, E // n, C, D).transpose(0, 1).reshape(
        E // n, n * C, D)


def _from_owners(ye: torch.Tensor, ctx) -> torch.Tensor:
    """The inverse of ``_to_owners``: peer j's slots of this rank's experts
    go back to peer j, and the (E, C, D) outputs of this rank's tokens come
    back, expert e from its owner."""
    n = ctx.tp_size
    El, nC, D = ye.shape
    out = ye.reshape(El, n, nC // n, D).transpose(0, 1).reshape(
        n * El, nC // n, D)
    return parallel.all_to_all(out, ctx)


def moe_ffn_ep(p: MoEParams, cfg: ModelConfig, x: torch.Tensor,
               policy: ShardingPolicy) -> torch.Tensor:
    """Expert parallelism over tp.  ``x`` (B_loc, S, D) is this rank's dp
    rows, replicated over tp; ``p`` this rank's shards (``moe_specs``).

    When S divides over tp (and S > 1) each tp rank routes its block of the
    sequence (``tp_slice``), with the capacity ``ep_capacity`` of its own
    token count, and the output's blocks are all-gathered over tp.  Else
    (S = 1, or S not divisible) every tp rank routes all of its rows, as
    the reference's ``P(dp, None, None)`` does: each expert then sees tp
    copies of every token, so the output's gradient is divided by tp on
    the way in, and ``copy_in`` sums the tp ranks' shares of the input's
    and the router's gradients.

    The experts' weights are gathered over the FSDP axes (their gradients
    reduce-scattered over dp; the all-to-all makes them complete over tp).
    The router is gathered too, and enters through ``copy_in``: every tp
    rank reads it with its own tokens, so each holds a partial gradient.
    In decode (``weight_gather`` off) the router and the experts keep
    their FSDP shards (``parallel.dp_dense``)."""
    ctx = policy.ctx
    n = ctx.tp_size
    E = cfg.num_experts
    if E % n:
        raise ValueError(f"{E} experts do not divide over tp = {n}")
    decode = not policy.weight_gather
    if decode:
        router, wg, wu, wd = p.router, p.w_gate, p.w_up, p.w_down
    else:
        sp = moe_specs(cfg, policy)
        router = parallel.copy_in(
            policy.gather_fsdp(p.router, P(None, None), sp.router), ctx)
        own = P(policy.tp, None, None)
        wg = policy.gather_fsdp(p.w_gate, own, sp.w_gate)
        wu = policy.gather_fsdp(p.w_up, own, sp.w_up)
        wd = policy.gather_fsdp(p.w_down, own, sp.w_down)

    S, D = x.shape[1], x.shape[2]
    seq = S % n == 0 and S > 1
    xl = parallel.copy_in(x, ctx)
    if seq:
        xl = parallel.tp_slice(xl, 1, ctx)
    Bl, Sl = xl.shape[0], xl.shape[1]
    T = Bl * Sl
    C = ep_capacity(T, cfg)
    xt = xl.reshape(T, D)
    if decode:
        r = route_logits(parallel.dp_dense(_router_logits, xt, router, ctx,
                                           contract_dim=-1), cfg, C)
    else:
        r = route(xt, router, cfg, C)
    ye = experts(_to_owners(dispatch(xt, r, E, C), ctx), wg, wu, wd,
                 ctx if decode else None)
    y = combine(_from_owners(ye, ctx), r, T).reshape(Bl, Sl, D)
    if seq:
        return parallel.tp_gather(y, 1, ctx)
    if n > 1:   # the same value; the gradient divided by tp
        y = y.detach() + (y - y.detach()) / n
    return y
