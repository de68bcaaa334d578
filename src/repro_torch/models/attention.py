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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .common import ModelConfig, init_dense, remat, rms_norm, rope

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


def _project_qkv(p: AttnParams, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(x.dtype))
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if p.q_norm is not None:
        q = rms_norm(p.q_norm, q, cfg.norm_eps, False)
        k = rms_norm(p.k_norm, k, cfg.norm_eps, False)
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta), v


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
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill, the encoder).

    Past 2 * Q_CHUNK tokens the S x S score matrix is never built: queries
    go in Q_CHUNK blocks, and a sliding-window layer slices K/V to the
    (window + chunk) region each block can see.  Under autograd each
    block's scores are recomputed in the backward (the reference's
    per-chunk ``jax.checkpoint``), so no layer keeps its S x S float32
    scores."""
    q, k, v = _project_qkv(p, cfg, x, positions)
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
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(x.dtype))


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
                     cache: KVCache, window: int | None = None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against the (ring) cache.  x: (B, 1, D).

    The new key and value go to slot ``t % W`` of ``cache`` in place (and
    the slot's position, and ``length`` + 1); the returned cache holds the
    same tensors."""
    t = cache.length                                # absolute position
    q, k_new, v_new = _project_qkv(p, cfg, x, t.reshape(1))
    W = cache.k.shape[1]
    slot = (t % W).long().reshape(1)
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    cache.pos.index_fill_(0, slot, t)
    valid = (cache.pos >= 0) & (cache.pos <= t)
    if window is not None:
        valid &= cache.pos > t - window
    out = _sdpa(q, cache.k, cache.v, valid[None, None, :], cfg)
    cache.length.add_(1)
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(x.dtype)), cache


def cross_attention(p: AttnParams, cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Decoder -> encoder cross attention (whisper); ``enc_kv`` precomputed.
    Long decoder sequences are q-chunked, each chunk recomputed in the
    backward under autograd."""
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
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(x.dtype))


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
