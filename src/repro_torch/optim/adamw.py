"""AdamW with mixed precision: the port of ``repro.optim.adamw``.

Params live in their compute dtype (bf16 in the configs; norm weights in
float32); the optimizer keeps a float32 master copy and float32 m / v
moments.  The semantics are the reference's: one global float32 gradient
norm, clipping by ``min(1, clip / (norm + 1e-9))``, a linear warmup, bias
correction by the step count, weight decay on every leaf (norms too), and
the new params the master cast to each param's dtype.

The reference is functional and makes float32 temporaries of whole leaves;
at qwen3-4b's width one stacked ``w_gate`` is 3.6 GB in float32, so here
every update is in place, one block of a leaf at a time (``_blocks``: at
most ``BLOCK_ELEMS`` elements, a stacked leaf's layer or a run of rows),
and the temporaries are a block's.  ``step``, the schedule and the norm
stay tensors on the device: a step never waits for the host.

Over a mesh (``policy`` and the param ``specs``) master, m and v are this
rank's shards, laid out as the params (ZeRO-3 over data and model): the
update is elementwise on them.  The global gradient norm sums the squares
of each distinct element once: a leaf's shard counts on the ranks at
coordinate 0 of every mesh axis its spec does not shard over (a leaf
replicated over tp, such as the norms, counts once, not tp times), and
the sum is all-reduced over every axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..models.common import (NO_SHARDING, ShardingPolicy, entry_axes,
                             spec_leaves, tree_leaves, tree_map)

BLOCK_ELEMS = 1 << 25      # 128 MB of float32 temporaries a block at most


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    master: Any          # float32 params
    m: Any
    v: Any
    step: torch.Tensor   # () int32, on the params' device


def _blocks(t: torch.Tensor) -> tuple:
    """Views of ``t`` along its first axis of at most ``BLOCK_ELEMS``
    elements each (whole rows; ``t`` itself when it is small)."""
    if t.dim() == 0 or t.numel() <= BLOCK_ELEMS:
        return (t,)
    return t.split(max(1, BLOCK_ELEMS // t[0].numel()))


def init(params: Any) -> OptState:
    with torch.no_grad():
        first = tree_leaves(params)[0]
        return OptState(
            master=tree_map(lambda p: p.detach().float().clone(), params),
            m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
            v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
            step=torch.zeros((), dtype=torch.int32, device=first.device))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(grads: list, owned: list | None = None,
                ctx=None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32.  Over a
    mesh (``ctx``), of the leaves this rank ``owned`` (one flag a leaf),
    summed over every mesh axis."""
    owned = owned or [True] * len(grads)
    norms = [torch.linalg.vector_norm(b, dtype=torch.float32)
             for g, mine in zip(grads, owned) if mine for b in _blocks(g)]
    first = grads[0]
    sq = (torch.stack(norms).square().sum() if norms else
          torch.zeros((), dtype=torch.float32, device=first.device))
    if ctx is not None:
        from ..models import parallel
        parallel.all_reduce_(sq, ctx.names, ctx)
    return sq.sqrt()


def _owned(grads: Any, specs: Any, ctx) -> list:
    """Per leaf, whether this rank counts it in the norm: it sits at
    coordinate 0 of every mesh axis the leaf's spec replicates it over."""
    out = []
    for sp in spec_leaves(grads, specs):
        held = {a for e in sp for a in entry_axes(e)}
        out.append(all(ctx.coord[a] == 0 for a in ctx.names
                       if a not in held))
    return out


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: Any, opt: OptState, params: Any, *,
          policy: ShardingPolicy = NO_SHARDING, specs: Any = None):
    """One AdamW step.  Updates ``params`` and ``opt`` in place and returns
    ``(params, opt, grad_norm)``: the same trees, ``opt.step`` advanced,
    the norm a 0-d float32 tensor.  Over a mesh, ``specs`` is the params'
    spec tree and every tree holds this rank's shards."""
    trees = [tree_leaves(t) for t in (grads, opt.m, opt.v, opt.master, params)]
    if len({len(t) for t in trees}) != 1:
        raise ValueError("grads, opt state and params differ in structure")
    if policy.enabled:
        gnorm = global_norm(trees[0], _owned(grads, specs, policy.ctx),
                            policy.ctx)
    else:
        gnorm = global_norm(trees[0])
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    opt.step.add_(1)
    step = opt.step.float()
    lr = _schedule(cfg, opt.step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for leaf in zip(*trees):
        for g, m, v, w, p in zip(*(_blocks(t) for t in leaf)):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
            w.sub_(upd.add_(w, alpha=cfg.weight_decay).mul_(lr))
            p.copy_(w)
    return params, opt, gnorm
