"""GQA attention: global/sliding-window, qk_norm, biases, softcap, KV cache.

The port of ``repro.models.attention``: GQA with any group size, per-head
qk_norm (qwen3), QKV bias (qwen1.5), the logit softcap (gemma2),
sliding-window "local" layers, decode against a KV cache (a ring of
exactly ``window`` slots on local layers), the non-causal encoder and the
decoder's cross attention (whisper).

Keys are rotated with absolute positions before they are cached, so a
ring overwrite needs no re-rotation; each slot remembers its absolute
position for masking.  ``_sdpa`` keeps the reference's recipe (float32
logits, softcap, ``NEG_INF`` masking, the weights cast to ``q``'s dtype
before the PV product); ``F.scaled_dot_product_attention`` has no softcap
and rounds otherwise, so it is not used.  Decode writes the new key and
value into the cache in place (the reference donates the cache to its
step; here the caller's state is the one updated).

Under a ``ShardingPolicy`` (training over a mesh) the heads are sharded
over tp where they divide (``shard_if``, ``param_specs``): column-parallel
q, k, v on this rank's heads, the recipe unchanged on them, and the
row-parallel ``wo`` output all-reduced over tp.  When the query heads
divide and the KV heads do not (GQA with few KV heads), ``wk`` and ``wv``
are replicated and each rank computes the KV heads its query heads read
(their *global* groups).  When the query heads do not divide, the layer is
replicated over tp.

Decode over a mesh runs on this rank's shard of the cache, laid out as
``zoo.serving_state_specs`` says, in one of three layouts:

* (a) KV heads over tp: this rank's heads on its cache, ``wo``
  row-parallel and all-reduced over tp;
* (b) cache slots over tp (the KV heads do not divide): every tp rank
  attends with every query head (the local ones all-gathered) to its
  block of slots;
* (c) cache slots over the dp axes (context parallelism: ``long_500k``'s
  B = 1 leaves the batch unsharded), KV heads over tp where they divide.

Over sharded slots the new key and value go to slot ``t % W`` on the rank
that owns it (the slots are cut into contiguous blocks, as the reference
shards them), and the softmax is combined over the slot axes
(``_combine_slots``): the float32 scores' max all-reduced, the
exponentials' sum all-reduced, then the weighted values.  A shard whose
slots are all masked adds exact zeros (``exp(NEG_INF - max)``); the
current token's slot is always valid, so the max is finite.  The
projections keep their FSDP weights sharded (``parallel.dp_dense``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from . import parallel
from .common import (NO_SHARDING, P, ModelConfig, ShardingPolicy, init_dense,
                     remat, rms_norm, rope)

NEG_INF = -2.0e38
Q_CHUNK = 1024  # query-block size for chunked attention


class AttnParams(NamedTuple):
    wq: torch.Tensor                  # (D, H, hd)
    wk: torch.Tensor                  # (D, Hkv, hd)
    wv: torch.Tensor                  # (D, Hkv, hd)
    wo: torch.Tensor                  # (H, hd, D)
    bq: torch.Tensor | None
    bk: torch.Tensor | None
    bv: torch.Tensor | None
    q_norm: torch.Tensor | None       # (hd,)
    k_norm: torch.Tensor | None


class KVCache(NamedTuple):
    k: torch.Tensor                   # (B, W, Hkv, hd), W = min(max_len, window)
    v: torch.Tensor
    pos: torch.Tensor                 # (W,) int32 absolute position per slot (-1 empty)
    length: torch.Tensor              # () int32, tokens seen so far


def init_attn(cfg: ModelConfig, generator: torch.Generator) -> AttnParams:
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dev, g = generator.device, generator
    zeros = lambda *s: torch.zeros(s, dtype=cfg.dtype, device=dev)  # noqa: E731
    ones = lambda: torch.ones(hd, dtype=torch.float32, device=dev)  # noqa: E731
    return AttnParams(
        wq=init_dense((D, H, hd), D ** -0.5, cfg.dtype, generator=g),
        wk=init_dense((D, Hkv, hd), D ** -0.5, cfg.dtype, generator=g),
        wv=init_dense((D, Hkv, hd), D ** -0.5, cfg.dtype, generator=g),
        wo=init_dense((H, hd, D), (H * hd) ** -0.5, cfg.dtype, generator=g),
        bq=zeros(H, hd) if cfg.qkv_bias else None,
        bk=zeros(Hkv, hd) if cfg.qkv_bias else None,
        bv=zeros(Hkv, hd) if cfg.qkv_bias else None,
        q_norm=ones() if cfg.qk_norm else None,
        k_norm=ones() if cfg.qk_norm else None,
    )


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> AttnParams:
    """The specs of one layer's ``AttnParams`` (the reference's
    ``transformer.param_specs.attn_spec``): heads over tp where they
    divide, the model dim over the FSDP axes."""
    tq = policy.shard_if(cfg.num_heads)     # replicate when H % tp != 0
    tkv = policy.shard_if(cfg.num_kv_heads)  # GQA: kv often < tp
    fs = policy._fs()
    return AttnParams(
        wq=P(fs, tq, None), wk=P(fs, tkv, None), wv=P(fs, tkv, None),
        wo=P(tq, None, fs),
        bq=P(tq, None), bk=P(tkv, None), bv=P(tkv, None),
        q_norm=P(None), k_norm=P(None))


def _kv_heads(H: int, Hkv: int, tq, tkv, ctx) -> tuple[slice, list | None]:
    """Which global KV heads this rank's query heads read when the query
    heads are sharded and the KV heads replicated: a contiguous range whose
    groups the local query heads fill evenly (the grouped ``_sdpa`` on
    them), else the range and, per local query head, its KV head within it
    (gathered, one KV head a query head)."""
    if tq is None or tkv is not None:
        return slice(None), None
    Hl, g = H // ctx.tp_size, H // Hkv
    first = ctx.tp_rank * Hl
    owner = [(first + i) // g for i in range(Hl)]
    lo, hi = owner[0], owner[-1] + 1
    gl = Hl // (hi - lo)
    if Hl % (hi - lo) == 0 and owner == [lo + i // gl for i in range(Hl)]:
        return slice(lo, hi), None
    return slice(lo, hi), [o - lo for o in owner]


def _local_weights(p: AttnParams, cfg: ModelConfig, policy: ShardingPolicy):
    """The weights of this rank's heads, FSDP-gathered, with the
    collectives their use implies: the weights replicated over tp that
    tp-partitioned heads read (the norms; ``wk``, ``wv`` and their biases
    when the KV heads do not divide) enter through ``copy_in``, their
    gradients being partial sums.  Returns (weights, the local query
    heads' KV map of ``_kv_heads``, whether the heads are partitioned)."""
    if not policy.enabled:
        return p, None, False
    sp = param_specs(cfg, policy)
    ctx = policy.ctx
    tq, tkv = policy.shard_if(cfg.num_heads), policy.shard_if(cfg.num_kv_heads)
    split = tq is not None and ctx.tp_size > 1
    kv, per_head = _kv_heads(cfg.num_heads, cfg.num_kv_heads, tq, tkv, ctx)

    def g(w, stored, wanted):
        return policy.gather_fsdp(w, wanted, stored)

    def rep(w, replicated=True):  # replicated over tp, read by local heads
        if split and replicated and w is not None:
            return parallel.copy_in(w, ctx)
        return w

    kv_rep = tkv is None
    wk = rep(g(p.wk, sp.wk, P(None, tkv, None)), kv_rep)[:, kv]
    wv = rep(g(p.wv, sp.wv, P(None, tkv, None)), kv_rep)[:, kv]
    bk = bv = None
    if p.bk is not None:
        bk, bv = rep(p.bk, kv_rep)[kv], rep(p.bv, kv_rep)[kv]
    local = AttnParams(
        wq=g(p.wq, sp.wq, P(None, tq, None)), wk=wk, wv=wv,
        wo=g(p.wo, sp.wo, P(tq, None, None)),
        bq=p.bq, bk=bk, bv=bv, q_norm=rep(p.q_norm), k_norm=rep(p.k_norm))
    return local, per_head, split


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", out, wo.to(out.dtype))


def _project_qkv(p: AttnParams, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, per_head: list | None = None,
                 proj=_proj):
    q, k, v = proj(x, p.wq), proj(x, p.wk), proj(x, p.wv)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if p.q_norm is not None:
        q = rms_norm(p.q_norm, q, cfg.norm_eps, False)
        k = rms_norm(p.k_norm, k, cfg.norm_eps, False)
    k, v = _per_head(k, v, per_head)
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta), v


def _per_head(k: torch.Tensor, v: torch.Tensor, per_head: list | None):
    """k and v (B, S, Hkv, hd) with one KV head a local query head when
    ``_kv_heads`` gave a map, else as they are."""
    if per_head is None:
        return k, v
    idx = torch.tensor(per_head, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None, cfg: ModelConfig) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Sk,Hkv,hd); mask: (1|B, Sq, Sk) bool or None.

    Mixed dtypes (a float32 model on a bf16 cache) promote as jnp.einsum
    promotes them."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(B, Sq, Hkv, g, hd).to(dt)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k.to(dt)).float()
    logits = logits * hd ** -0.5
    if cfg.attn_softcap:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = torch.promote_types(w.dtype, v.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", w.to(dt), v.to(dt))
    return out.reshape(B, Sq, H, hd)


def causal_mask(Sq: int, Sk: int, window: int | None = None,
                device=None) -> torch.Tensor:
    """(1, Sq, Sk) bool; window limits lookback (sliding-window layers)."""
    qi = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    ki = torch.arange(Sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m[None]


def attention(p: AttnParams, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, window: int | None = None,
              causal: bool = True, *,
              policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """Full-sequence attention (prefill, the encoder).

    Past 2 * Q_CHUNK tokens the S x S score matrix is never built: queries
    go in Q_CHUNK blocks, and a sliding-window layer slices K/V to the
    (window + chunk) region each block can see.  Under autograd each
    block's scores are recomputed in the backward (the reference's
    per-chunk ``jax.checkpoint``), so no layer keeps its S x S float32
    scores.  Under a policy, this rank's heads (module docstring)."""
    p, per_head, split = _local_weights(p, cfg, policy)
    if split:
        x = parallel.copy_in(x, policy.ctx)
    q, k, v = _project_qkv(p, cfg, x, positions, per_head)
    S = x.shape[1]
    if not causal or S <= 2 * Q_CHUNK:
        mask = causal_mask(S, S, window, x.device) if causal else None
        out = _sdpa(q, k, v, mask, cfg)
    else:
        pad = -S % Q_CHUNK  # ragged tails (e.g. VLM patch prefixes) pad+mask
        if pad:
            zp = lambda a: torch.nn.functional.pad(  # noqa: E731
                a, (0, 0, 0, 0, 0, pad))
            out = _chunked_causal(zp(q), zp(k), zp(v), cfg, window)[:, :S]
        else:
            out = _chunked_causal(q, k, v, cfg, window)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo.to(x.dtype))
    return parallel.reduce_out(y, policy.ctx) if split else y


def _chunked_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: ModelConfig, window: int | None) -> torch.Tensor:
    B, S, H, hd = q.shape
    nq = S // Q_CHUNK
    Lk = min(S, -(-(window + Q_CHUNK) // 128) * 128) if window is not None \
        else S
    ar_q = torch.arange(Q_CHUNK, device=q.device)[:, None]
    ar_k = torch.arange(Lk, device=q.device)[None, :]
    outs = []
    for ci in range(nq):
        qs = ci * Q_CHUNK
        ks = min(max(qs + Q_CHUNK - Lk, 0), S - Lk)
        q_abs, k_abs = qs + ar_q, ks + ar_k
        m = k_abs <= q_abs
        if window is not None:
            m &= k_abs > q_abs - window
        outs.append(remat(_sdpa, q[:, qs:qs + Q_CHUNK], k[:, ks:ks + Lk],
                          v[:, ks:ks + Lk], m[None], cfg))
    return torch.cat(outs, dim=1)


def decode_attention(p: AttnParams, cfg: ModelConfig, x: torch.Tensor,
                     cache: KVCache, window: int | None = None, *,
                     policy: ShardingPolicy = NO_SHARDING
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against the (ring) cache.  x: (B, 1, D).

    The new key and value go to slot ``t % W`` of ``cache`` in place (and
    the slot's position, and ``length`` + 1); the returned cache holds the
    same tensors.  Under a policy, ``x`` is this rank's batch rows and
    ``cache`` its shard (module docstring)."""
    if policy.enabled:
        return _mesh_decode_attention(p, cfg, x, cache, window, policy)
    t = cache.length                                # absolute position
    q, k_new, v_new = _project_qkv(p, cfg, x, t.reshape(1))
    _write(cache, k_new, v_new, t)
    out = _sdpa(q, cache.k, cache.v, _valid(cache, t, window)[None, None, :],
                cfg)
    cache.length.add_(1)
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(x.dtype)), cache


def _write(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
           t: torch.Tensor) -> None:
    """The new key, value and position into slot ``t % W`` of ``cache``."""
    slot = (t % cache.k.shape[1]).long().reshape(1)
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    cache.pos.index_fill_(0, slot, t)


def _valid(cache: KVCache, t: torch.Tensor, window: int | None):
    """(W,) bool: the slots a query at ``t`` attends to."""
    valid = (cache.pos >= 0) & (cache.pos <= t)
    if window is not None:
        valid &= cache.pos > t - window
    return valid


def decode_layout(cfg: ModelConfig, policy: ShardingPolicy
                  ) -> tuple[tuple[str, ...], bool]:
    """(the mesh axes a decode cache's slots are sharded over, whether its
    KV heads are sharded over tp) under ``policy``, as
    ``zoo.serving_state_specs`` lays the cache out: KV heads over tp where
    they divide, else slots over tp, when the batch is sharded over dp;
    slots over every other mesh axis when it is not (context
    parallelism)."""
    kv = policy.shard_if(cfg.num_kv_heads) is not None
    if policy.dp:
        return ((policy.tp,) if policy.tp and not kv else ()), kv
    return tuple(a for a in policy.mesh.mesh_dim_names if a != policy.tp), kv


def _write_slot(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                t: torch.Tensor, slots: tuple, ctx) -> None:
    """Slot ``t % W`` of the whole cache written with the new key, value
    and position on the rank whose block of slots holds it; the other
    ranks write their own values back (no host sync decides who owns
    it)."""
    n, r = parallel.block_of(slots, ctx)
    Wl = cache.k.shape[1]
    local = t % (Wl * n) - r * Wl
    hit = (local >= 0) & (local < Wl)
    idx = local.clamp(0, Wl - 1).long().reshape(1)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        buf.index_copy_(1, idx, torch.where(hit, new.to(buf.dtype),
                                            buf.index_select(1, idx)))
    cache.pos.index_copy_(0, idx, torch.where(
        hit, t, cache.pos.index_select(0, idx)))


def _combine_slots(logits: torch.Tensor, v: torch.Tensor, axes: tuple,
                   ctx, dtype) -> torch.Tensor:
    """The softmax of float32 ``logits`` (B, Hkv, g, Sq, W_loc), masked
    with ``NEG_INF``, over slots sharded over ``axes``, times the values
    ``v`` (B, W_loc, Hkv, hd): the max all-reduced, this shard's
    exponentials summed and all-reduced, its normalised weights (cast to
    ``dtype``, as ``_sdpa`` casts them) times its values, all-reduced in
    float32.  -> (B, Sq, Hkv, g, hd) in ``dtype``."""
    m = logits.amax(-1, keepdim=True)
    parallel.all_reduce_(m, axes, ctx, dist.ReduceOp.MAX)
    e = torch.exp(logits - m)
    s = e.sum(-1, keepdim=True)
    parallel.all_reduce_(s, axes, ctx)
    w = (e / s).to(dtype)
    dt = torch.promote_types(w.dtype, v.dtype)
    o = torch.einsum("bhgqs,bshk->bqhgk", w.to(dt), v.to(dt)).float()
    return parallel.all_reduce_(o, axes, ctx).to(dtype)


def _sdpa_slots(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor, cfg: ModelConfig, axes: tuple,
                ctx) -> torch.Tensor:
    """``_sdpa``'s recipe against this rank's block of slots (``valid``:
    (W_loc,) bool), combined over ``axes`` (``_combine_slots``)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd).to(dt)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k.to(dt)).float()
    logits = logits * hd ** -0.5
    if cfg.attn_softcap:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    logits = torch.where(valid, logits, NEG_INF)
    return _combine_slots(logits, v, axes, ctx, q.dtype).reshape(
        B, Sq, H, hd)


def _mesh_decode_attention(p: AttnParams, cfg: ModelConfig,
                           x: torch.Tensor, cache: KVCache,
                           window: int | None, policy: ShardingPolicy):
    """``decode_attention`` on this rank's rows and cache shard (module
    docstring: layouts (a), (b), (c)).  Where the KV heads are whole on
    every tp rank and the query heads split, the local query heads are
    all-gathered over tp, every head attends, and this rank's heads go
    into the row-parallel ``wo``."""
    ctx = policy.ctx
    slots, kv_split = decode_layout(cfg, policy)
    live = tuple(a for a in slots if ctx.size[a] > 1)
    split = policy.shard_if(cfg.num_heads) is not None and ctx.tp_size > 1
    every_head = split and not kv_split
    t = cache.length
    q, k_new, v_new = _project_qkv(
        p, cfg, x, t.reshape(1), proj=lambda a, w: parallel.dp_dense(
            _proj, a, w, ctx, contract_dim=-1))
    if every_head:
        q = parallel.tp_gather(q, 2, ctx)
    if live:
        _write_slot(cache, k_new, v_new, t, slots, ctx)
    else:
        _write(cache, k_new, v_new, t)
    valid = _valid(cache, t, window)
    if live:
        out = _sdpa_slots(q, cache.k, cache.v, valid, cfg, live, ctx)
    else:
        out = _sdpa(q, cache.k, cache.v, valid[None, None, :], cfg)
    cache.length.add_(1)
    if every_head:
        out = parallel.tp_slice(out, 2, ctx)
    y = parallel.dp_dense(_out_proj, out, p.wo, ctx, out_dim=-1)
    return (parallel.reduce_out(y, ctx) if split else y), cache


def cross_kv(p: AttnParams, cfg: ModelConfig, enc: torch.Tensor, *,
             policy: ShardingPolicy = NO_SHARDING):
    """The cross-attention keys and values of the encoder output ``enc``
    (B, F, D): under a policy, of the KV heads this rank's query heads
    read."""
    p, per_head, split = _local_weights(p, cfg, policy)
    if split:
        enc = parallel.copy_in(enc, policy.ctx)
    return _per_head(torch.einsum("bsd,dhk->bshk", enc, p.wk.to(enc.dtype)),
                     torch.einsum("bsd,dhk->bshk", enc, p.wv.to(enc.dtype)),
                     per_head)


def cross_attention(p: AttnParams, cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: tuple[torch.Tensor, torch.Tensor], *,
                    policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """Decoder -> encoder cross attention (whisper); ``enc_kv`` precomputed
    (``cross_kv``).  Long decoder sequences are q-chunked, each chunk
    recomputed in the backward under autograd.  Under a policy, this rank's
    heads, the output all-reduced over tp; in decode (``weight_gather``
    off) ``enc_kv`` is the decode state's, whose KV heads are this rank's
    where they divide over tp and whole otherwise."""
    if policy.enabled and not policy.weight_gather:
        return _mesh_decode_cross(p, cfg, x, enc_kv, policy)
    p, _, split = _local_weights(p, cfg, policy)
    if split:
        x = parallel.copy_in(x, policy.ctx)
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    if p.q_norm is not None:
        q = rms_norm(p.q_norm, q, cfg.norm_eps, False)
    k, v = (a.to(x.dtype) for a in enc_kv)
    Sq = q.shape[1]
    if Sq <= 2 * Q_CHUNK:
        out = _sdpa(q, k, v, None, cfg)
    else:
        out = torch.cat([remat(_sdpa, q[:, s:s + Q_CHUNK], k, v, None, cfg)
                         for s in range(0, Sq, Q_CHUNK)], dim=1)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo.to(x.dtype))
    return parallel.reduce_out(y, policy.ctx) if split else y


def _mesh_decode_cross(p: AttnParams, cfg: ModelConfig, x: torch.Tensor,
                       enc_kv, policy: ShardingPolicy) -> torch.Tensor:
    """``cross_attention`` of one decode token on this rank's rows and
    heads, the FSDP weights kept sharded (``parallel.dp_dense``)."""
    ctx = policy.ctx
    tq = policy.shard_if(cfg.num_heads)
    tkv = policy.shard_if(cfg.num_kv_heads)
    split = tq is not None and ctx.tp_size > 1
    q = parallel.dp_dense(_proj, x, p.wq, ctx, contract_dim=-1)
    if p.q_norm is not None:
        q = rms_norm(p.q_norm, q, cfg.norm_eps, False)
    k, v = (a.to(x.dtype) for a in enc_kv)
    if split and tkv is None:     # the state holds every KV head
        kv, per_head = _kv_heads(cfg.num_heads, cfg.num_kv_heads, tq, tkv,
                                 ctx)
        k, v = _per_head(k[:, :, kv], v[:, :, kv], per_head)
    out = _sdpa(q, k, v, None, cfg)
    y = parallel.dp_dense(_out_proj, out, p.wo, ctx, out_dim=-1)
    return parallel.reduce_out(y, ctx) if split else y


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: int | None = None, dtype=torch.bfloat16,
               prefill_len: int = 0, generator: torch.Generator | None = None,
               device=None) -> KVCache:
    """Empty (or stand-in prefilled) cache.  Local layers get W = window
    slots.  With a generator the keys and values are random stand-ins drawn
    on its device (``device`` is then ignored); else zeros on ``device``
    (``cuda:0`` by default)."""
    W = min(max_len, window) if window else max_len
    shape = (batch, W, cfg.num_kv_heads, cfg.hd)
    if generator is not None:
        dev = generator.device
        k = torch.randn(shape, generator=generator, dtype=dtype,
                        device=dev) * 0.02
        v = torch.randn(shape, generator=generator, dtype=dtype,
                        device=dev) * 0.02
    else:
        dev = resolve_device(device)
        k = torch.zeros(shape, dtype=dtype, device=dev)
        v = torch.zeros(shape, dtype=dtype, device=dev)
    n = int(prefill_len)
    base = torch.arange(W, dtype=torch.int32, device=dev)
    # ring layout: position p sits in slot p % W; for a contiguous prefix
    # [0, n) slot s holds the largest p < n with p % W == s (or -1 if empty)
    p_cand = (n - 1) - torch.remainder(n - 1 - base, W)
    keep = (n > 0) & (p_cand >= max(n - W, 0)) & (p_cand >= 0)
    pos = torch.where(keep, p_cand, -1).to(torch.int32)
    return KVCache(k=k, v=v, pos=pos,
                   length=torch.tensor(n, dtype=torch.int32, device=dev))
