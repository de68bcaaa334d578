"""Model assembly: decoder layers, blocks, heads, prefill forward.

The port of ``repro.models.transformer``, as plain functions on
``NamedTuple`` parameter structures (not ``nn.Module``s): a *block* is one
repetition of ``cfg.pattern``, and each pattern slot's parameters are
stacked with a leading ``(num_blocks,)`` axis, exactly as the reference
stacks them for its ``lax.scan``, so its weights map onto these key for key
(``convert.py``).  ``_scan_blocks`` is a Python loop over the blocks'
views (one ``unbind`` a leaf).  Under autograd (training) each block, and
each encoder layer, is recomputed in the backward instead of keeping its
activations, as the reference remats its scan bodies; prefill and decode
record no graph and run the blocks plainly.  ``tail`` holds the layers
outside the pattern (recurrentgemma's trailing ``(R, R)``).  The
enc-dec (whisper) and VLM (internvl2) models wrap the same decoder with
stubbed frontends: precomputed frame or patch embeddings come in with the
batch.

Under a ``ShardingPolicy`` every function runs on this rank's shards of
the params (``param_specs``; ``init_params`` returns them) and batch: the
embedding and the logits vocab-parallel over tp, attention and the MLP
Megatron-style (column-parallel in, row-parallel out, all-reduced), each
FSDP-sharded weight gathered over dp before its use
(``models/parallel.py``), MoE layers expert-parallel over tp
(``moe.moe_ffn_ep``).  ``forward`` with no autograd is the mesh prefill,
and ``lm_logits`` gives this rank's vocabulary block.  Decode over a mesh
(a policy without ``weight_gather``) keeps the FSDP weights sharded and
moves the batch rows instead (``parallel.dp_dense``), on this rank's shard
of the decode state (``attention.decode_attention``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from . import attention as attn_lib
from . import moe as moe_lib
from . import parallel
from . import recurrent as rec_lib
from .common import (NO_SHARDING, LayerSpec, ModelConfig, P, ShardingPolicy,
                     dense, init_dense, padded_vocab, remat, rms_norm, scalar,
                     softcap, spec_map, stack_blocks, tree_map, tree_unstack)


class MLPParams(NamedTuple):
    w_gate: torch.Tensor   # (D, F)
    w_up: torch.Tensor     # (D, F)
    w_down: torch.Tensor   # (F, D)


def init_mlp(cfg: ModelConfig, generator: torch.Generator) -> MLPParams:
    D, Fd = cfg.d_model, cfg.d_ff
    return MLPParams(
        w_gate=init_dense((D, Fd), D ** -0.5, cfg.dtype, generator=generator),
        w_up=init_dense((D, Fd), D ** -0.5, cfg.dtype, generator=generator),
        w_down=init_dense((Fd, D), Fd ** -0.5, cfg.dtype, generator=generator),
    )


def mlp_specs(cfg: ModelConfig, policy: ShardingPolicy) -> MLPParams:
    return MLPParams(w_gate=policy.p_mlp_in(), w_up=policy.p_mlp_in(),
                     w_down=policy.p_mlp_out())


def mlp(p: MLPParams, x: torch.Tensor, *,
        policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """SwiGLU.  Under a policy: column-parallel ``w_gate`` / ``w_up`` and
    row-parallel ``w_down`` on this rank's slice of F, all-reduced (in
    decode, on the FSDP shards: ``parallel.dp_dense``)."""
    split = False
    if policy.enabled and not policy.weight_gather:
        ctx = policy.ctx

        def dd(w, a, **kw):
            return parallel.dp_dense(lambda u, v: dense(v, u), a, w, ctx,
                                     **kw)

        y = dd(p.w_down, F.silu(dd(p.w_gate, x, contract_dim=-1))
               * dd(p.w_up, x, contract_dim=-1), out_dim=-1)
        return parallel.reduce_out(y, ctx) if ctx.tp_size > 1 else y
    if policy.enabled:
        # p_mlp_in shards F over tp outright (a shard exists only where F
        # divides), so the reference's shard_if(F) is tp
        tf_ = policy.tp
        sp = mlp_specs(None, policy)
        p = MLPParams(
            w_gate=policy.gather_fsdp(p.w_gate, P(None, tf_), sp.w_gate),
            w_up=policy.gather_fsdp(p.w_up, P(None, tf_), sp.w_up),
            w_down=policy.gather_fsdp(p.w_down, P(tf_, None), sp.w_down))
        split = tf_ is not None and policy.ctx.tp_size > 1
        if split:
            x = parallel.copy_in(x, policy.ctx)
    y = dense(p.w_down, F.silu(dense(p.w_gate, x)) * dense(p.w_up, x))
    return parallel.reduce_out(y, policy.ctx) if split else y


class LayerParams(NamedTuple):
    """One layer: mixer (attn/rglru/ssd) + ffn (mlp/moe) + norms.

    ``cross``/``norm_c`` are the enc-dec cross-attention params (whisper
    decoder); None elsewhere."""

    norm1: torch.Tensor
    mixer: Any
    norm2: torch.Tensor
    ffn: Any
    cross: Any = None
    norm_c: torch.Tensor | None = None


def _norm_init(cfg: ModelConfig, dev) -> torch.Tensor:
    fill = torch.zeros if cfg.rms_offset else torch.ones
    return fill(cfg.d_model, dtype=torch.float32, device=dev)


def init_layer(cfg: ModelConfig, spec: LayerSpec, generator: torch.Generator,
               cross: bool = False) -> LayerParams:
    if spec.kind in ("global", "local"):
        mixer = attn_lib.init_attn(cfg, generator)
    elif spec.kind == "rglru":
        mixer = rec_lib.init_rglru(cfg, generator)
    elif spec.kind == "ssd":
        mixer = rec_lib.init_ssd(cfg, generator)
    else:
        raise ValueError(spec.kind)
    ffn = (moe_lib.init_moe(cfg, generator) if cfg.is_moe
           else init_mlp(cfg, generator) if cfg.d_ff > 0 else None)
    dev = generator.device
    return LayerParams(
        norm1=_norm_init(cfg, dev), mixer=mixer, norm2=_norm_init(cfg, dev),
        ffn=ffn,
        cross=attn_lib.init_attn(cfg, generator) if cross else None,
        norm_c=_norm_init(cfg, dev) if cross else None,
    )


def apply_layer(p: LayerParams, cfg: ModelConfig, spec: LayerSpec,
                x: torch.Tensor, positions: torch.Tensor | None, state=None,
                decode: bool = False, enc_kv=None, *,
                policy: ShardingPolicy = NO_SHARDING):
    """Pre-norm residual layer.  Returns (y, new_mixer_state)."""
    h = rms_norm(p.norm1, x, cfg.norm_eps, cfg.rms_offset)
    new_state = None
    if spec.kind in ("global", "local"):
        window = spec.window if spec.kind == "local" else None
        if decode:
            a, new_state = attn_lib.decode_attention(p.mixer, cfg, h, state,
                                                     window, policy=policy)
        else:
            a = attn_lib.attention(p.mixer, cfg, h, positions, window,
                                   policy=policy)
    elif spec.kind == "rglru":
        a, new_state = rec_lib.rglru(p.mixer, cfg, h, state,
                                     policy=policy)
    elif spec.kind == "ssd":
        a, new_state = rec_lib.ssd(p.mixer, cfg, h, state, policy=policy)
    x = x + a
    if p.cross is not None and enc_kv is not None:
        h = rms_norm(p.norm_c, x, cfg.norm_eps, cfg.rms_offset)
        x = x + attn_lib.cross_attention(p.cross, cfg, h, enc_kv,
                                         policy=policy)
    if p.ffn is not None:
        h = rms_norm(p.norm2, x, cfg.norm_eps, cfg.rms_offset)
        x = x + (moe_lib.moe_ffn(p.ffn, cfg, h, policy=policy) if cfg.is_moe
                 else mlp(p.ffn, h, policy=policy))
    return x, new_state


class ModelParams(NamedTuple):
    embed: torch.Tensor              # (V, D)
    blocks: Any                      # per slot, stacked (num_blocks, ...)
    final_norm: torch.Tensor         # (D,)
    unembed: torch.Tensor | None     # (D, V) if untied
    encoder: Any = None              # whisper: (stacked encoder layers, norm)
    enc_proj: Any = None             # vlm frontend projection
    tail: Any = None                 # layers after the pattern (cfg.tail)


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                policy: ShardingPolicy = NO_SHARDING) -> ModelParams:
    """Random weights drawn from ``generator`` on its device, in the
    reference's distributions (its draws differ: weights cross between the
    packages through ``convert.params_from_numpy``).  Under a policy, this
    rank's shards of them (``param_specs``): every rank draws the same
    values from the same seed, in the same order, one layer (or one
    embedding table) at a time, and keeps copies of its slices, so no rank
    holds the whole model."""
    g, dev = generator, generator.device
    keep = lambda tree, specs: tree  # noqa: E731
    sp = None
    if policy.enabled:
        sp = param_specs(cfg, policy)
        coord, size = policy.ctx.coord, policy.ctx.size

        def keep(tree, specs):
            return parallel.shard_tree(tree, specs, coord, size)

    def unstacked(specs):       # a stacked tree's specs, block axis dropped
        return None if sp is None else spec_map(lambda s: P(*s[1:]), specs)

    pick = (lambda f: None) if sp is None else (lambda f: f(sp))  # noqa: E731
    has_cross = cfg.encoder_layers > 0
    blocks = tuple(
        stack_blocks(lambda _, s=s, spec=spec: keep(
            init_layer(cfg, spec, g, cross=has_cross),
            unstacked(pick(lambda t: t.blocks[s]))), cfg.num_blocks)
        for s, spec in enumerate(cfg.pattern))
    # N(0, 1/sqrt(D)) so the sqrt(D) embedding multiplier yields unit-scale
    # activations and tied logits stay O(1) at init
    vp = padded_vocab(cfg.vocab_size)
    embed = keep(init_dense((vp, cfg.d_model), cfg.d_model ** -0.5,
                            cfg.dtype, generator=g), pick(lambda t: t.embed))
    encoder = None
    if cfg.encoder_layers:
        enc_specs = pick(lambda t: t.encoder[0])
        encoder = (stack_blocks(
            lambda _: keep(init_layer(cfg, LayerSpec("global"), g),
                           unstacked(enc_specs)), cfg.encoder_layers),
                   torch.ones(cfg.d_model, dtype=torch.float32, device=dev))
    enc_proj = (init_dense((cfg.d_model, cfg.d_model), None, cfg.dtype,
                           generator=g) if cfg.vision_tokens else None)
    tail = (tuple(keep(init_layer(cfg, ls, g, cross=has_cross),
                       pick(lambda t, i=i: t.tail[i]))
                  for i, ls in enumerate(cfg.tail)) if cfg.tail else None)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = keep(init_dense((cfg.d_model, vp), None, cfg.dtype,
                                  generator=g), pick(lambda t: t.unembed))
    return ModelParams(
        embed=embed, blocks=blocks, final_norm=_norm_init(cfg, dev),
        unembed=unembed, encoder=encoder, enc_proj=enc_proj, tail=tail)


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> ModelParams:
    """The ``P`` tree matching ``init_params``, leaf by leaf as the
    reference's ``transformer.param_specs``: the stacked blocks' specs lead
    with ``None`` (their block axis); a leaf absent from the params (a bias
    without ``qkv_bias``) still has its spec."""

    def mixer_spec(spec: LayerSpec):
        if spec.kind in ("global", "local"):
            return attn_lib.param_specs(cfg, policy)
        if spec.kind == "rglru":
            return rec_lib.rglru_specs(cfg, policy)
        if spec.kind == "ssd":
            return rec_lib.ssd_specs(cfg, policy)
        raise ValueError(spec.kind)

    def ffn_spec():
        if cfg.is_moe:
            return moe_lib.moe_specs(cfg, policy)
        if cfg.d_ff > 0:
            return mlp_specs(cfg, policy)
        return None

    def layer_spec(spec: LayerSpec, cross: bool = False):
        return LayerParams(norm1=P(None), mixer=mixer_spec(spec),
                           norm2=P(None), ffn=ffn_spec(),
                           cross=attn_lib.param_specs(cfg, policy)
                           if cross else None,
                           norm_c=P(None) if cross else None)

    def stacked(tree):
        """blocks carry a leading (num_blocks,) axis: prepend None."""
        return spec_map(lambda sp: P(None, *sp), tree)

    cross = cfg.encoder_layers > 0
    enc = None
    if cfg.encoder_layers:
        enc = (stacked(layer_spec(LayerSpec("global"))), P(None))
    return ModelParams(
        embed=policy.p_embed(),
        blocks=tuple(stacked(layer_spec(s, cross)) for s in cfg.pattern),
        final_norm=P(None),
        unembed=(None if cfg.tie_embeddings else policy.p_embed()),
        encoder=enc,
        enc_proj=(P(None, None) if cfg.vision_tokens else None),
        tail=(tuple(layer_spec(s, cross) for s in cfg.tail)
              if cfg.tail else None),
    )


def block(tree, b: int):
    """Block ``b`` of a stacked per-slot tree (views, no copies)."""
    return tree_map(lambda a: a[b], tree)


def enc_kv(lp: LayerParams, enc: torch.Tensor | None, cfg=None, *,
           policy: ShardingPolicy = NO_SHARDING):
    """A decoder layer's cross-attention keys and values of the encoder
    output ``enc`` (B, F, D); None without an encoder.  Under a policy
    (``cfg`` then given), those of this rank's heads."""
    if enc is None or lp.cross is None:
        return None
    return attn_lib.cross_kv(lp.cross, cfg, enc, policy=policy)


def _block_body(x: torch.Tensor, slot_params: tuple, cfg: ModelConfig,
                positions: torch.Tensor, enc: torch.Tensor | None,
                policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """One repetition of ``cfg.pattern``: each slot's layer in turn."""
    for lp, spec in zip(slot_params, cfg.pattern):
        x, _ = apply_layer(lp, cfg, spec, x, positions,
                           enc_kv=enc_kv(lp, enc, cfg, policy=policy),
                           policy=policy)
    return x


def _scan_blocks(params: ModelParams, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, enc: torch.Tensor | None = None,
                 policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    slots = [tree_unstack(p, cfg.num_blocks) for p in params.blocks]
    for slot_params in zip(*slots):
        x = remat(_block_body, x, slot_params, cfg, positions, enc, policy)
    if params.tail is not None:
        for lp, spec in zip(params.tail, cfg.tail):
            x, _ = apply_layer(lp, cfg, spec, x, positions,
                               enc_kv=enc_kv(lp, enc, cfg, policy=policy),
                               policy=policy)
    return x


def embed_tokens(params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor,
                 *, policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """``embed[tokens] * sqrt(D)``; under a policy the table's rows are
    sharded over tp (``parallel.vocab_embed``), and in decode its FSDP
    columns stay sharded (``parallel.dp_dense``)."""
    if policy.enabled and not policy.weight_gather:
        ctx = policy.ctx
        x = parallel.dp_dense(lambda t, w: parallel.vocab_embed(w, t, ctx),
                              tokens, params.embed, ctx,
                              out_dim=-1).to(cfg.dtype)
    elif policy.enabled:
        w = policy.gather_fsdp(params.embed, P(policy.tp, None),
                               policy.p_embed())
        x = parallel.vocab_embed(w, tokens, policy.ctx).to(cfg.dtype)
    else:
        x = params.embed[tokens].to(cfg.dtype)
    return x * scalar(x, cfg.d_model ** 0.5)


def lm_logits(params: ModelParams, cfg: ModelConfig, x: torch.Tensor, *,
              policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """The (B, S, V) logits, the padded slots -1e9; under a policy, this
    rank's block of the vocabulary (tp-sharded, in tp-rank order)."""
    x = rms_norm(params.final_norm, x, cfg.norm_eps, cfg.rms_offset)
    vp = padded_vocab(cfg.vocab_size)
    lo = 0
    if policy.enabled:
        tv = policy.shard_if(vp)
        if tv is None and policy.ctx.tp_size > 1:
            raise ValueError(f"the padded vocabulary {vp} does not divide "
                             f"over tp = {policy.ctx.tp_size}")
        lo = policy.ctx.tp_rank * (vp // policy.ctx.tp_size)
        if not policy.weight_gather:
            logits = _decode_logits(params, x, policy)
        else:
            if params.unembed is None:
                w = policy.gather_fsdp(params.embed, P(tv, None),
                                       policy.p_embed()).T
            else:
                w = policy.gather_fsdp(params.unembed, P(None, tv),
                                       policy.p_embed())
            x = parallel.copy_in(x, policy.ctx)
            logits = _logits(x, w)
    else:
        logits = _logits(x, params.embed.T if params.unembed is None
                         else params.unembed)
    logits = softcap(logits, cfg.logit_softcap)
    if vp != cfg.vocab_size:  # mask the padded slots exactly
        valid = torch.arange(lo, lo + logits.shape[-1],
                             device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits, scalar(logits, -1e9))
    return logits


def _logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))


def _decode_logits(params: ModelParams, x: torch.Tensor,
                   policy: ShardingPolicy) -> torch.Tensor:
    """This rank's vocabulary block of the logits of its decode rows, the
    FSDP weight kept sharded: the tied table (V over tp, D over dp) by
    ``dp_dense``; the untied head (D over tp, V over dp) on this rank's D
    block of the gathered rows, its V block zero-padded and
    reduce-scattered over dp, then over tp along the vocabulary."""
    ctx = policy.ctx
    if params.unembed is None:
        return parallel.dp_dense(lambda a, w: _logits(a, w.T), x,
                                 params.embed, ctx, contract_dim=-1)
    y = parallel.dp_dense(
        lambda a, w: _logits(parallel.tp_slice(a, -1, ctx), w), x,
        params.unembed, ctx, out_dim=-1)
    if ctx.tp_size == 1:
        return y
    return parallel._reduce_scatter(y.float(), y.dim() - 1, policy.tp,
                                    ctx).to(y.dtype)


def forward(params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embeds: torch.Tensor | None = None,
            encoder_out: torch.Tensor | None = None, *,
            policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """tokens (B, S) -> final hidden (B, S, D).  ``extra_embeds`` is the VLM
    patch-embedding prefix (stubbed frontend)."""
    x = embed_tokens(params, cfg, tokens, policy=policy)
    if extra_embeds is not None:
        pfx = extra_embeds.to(cfg.dtype)
        if params.enc_proj is not None:
            pfx = dense(params.enc_proj, pfx)
        x = torch.cat([pfx, x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return _scan_blocks(params, cfg, x, positions, enc=encoder_out,
                        policy=policy)


def encode(params: ModelParams, cfg: ModelConfig, frames: torch.Tensor, *,
           policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """Whisper encoder over stubbed conv-frontend frame embeddings (B,F,D);
    its layers are non-causal."""
    enc_blocks, enc_norm = params.encoder
    x = frames.to(cfg.dtype)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    for lp in tree_unstack(enc_blocks, cfg.encoder_layers):
        x = remat(_encoder_layer, x, lp, cfg, positions, policy)
    return rms_norm(enc_norm, x, cfg.norm_eps, cfg.rms_offset)


def _encoder_layer(x: torch.Tensor, lp: LayerParams, cfg: ModelConfig,
                   positions: torch.Tensor,
                   policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    h = rms_norm(lp.norm1, x, cfg.norm_eps, cfg.rms_offset)
    x = x + attn_lib.attention(lp.mixer, cfg, h, positions, window=None,
                               causal=False, policy=policy)
    h = rms_norm(lp.norm2, x, cfg.norm_eps, cfg.rms_offset)
    return x + mlp(lp.ffn, h, policy=policy)
