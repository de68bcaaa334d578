"""Step functions for every architecture of ``configs/archs.py``: train,
prefill and decode.

The port of ``repro.models.zoo``.  ``train_step`` is next-token cross
entropy (``loss_fn``, evaluated in ``LOSS_SEQ_CHUNK``-token chunks, each
recomputed in the backward) through autograd, then an AdamW update
(``optim/adamw.py``); params are leaf tensors that require grad, updated
in place with the optimizer's state.  ``decode_step`` runs one token
against per-layer mixer states (ring KV caches for local layers,
recurrent states for rglru/ssd, a full cache for global attention);
every stream of the batch shares one position, as in the reference.  The
state's tensors are updated in place (the reference donates them to its
jitted step) and the returned ``DecodeState`` holds them with the
position advanced.  The serving steps run under ``torch.no_grad()``: the
reference never differentiates them, and params trained in the same
process would otherwise write autograd graphs into the caches (fault F5).

Under a ``ShardingPolicy`` the training path runs over a mesh on this
rank's shards (``transformer``): the loss is this rank's share of the
global mean (its batch rows over the dp axes) reduced over dp, the
gradients come out as this rank's shards of the global gradient (the dp
reduce-scatters in the backward, an all-reduce over dp of the leaves
replicated there), and the optimizer keeps the param specs (ZeRO-3).
The serving steps run under a policy too: the prefill on this rank's
batch rows and shards, its logits this rank's vocabulary block; the
decode step on this rank's shard of the ``DecodeState``, laid out by
``serving_state_specs`` (``decode_state_specs``, the reference's table,
or its context-parallel form when the batch does not shard: the caches'
slots over the dp axes), with the FSDP weights left sharded (the
reference's ``weight_gather=False``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from ..optim import adamw
from . import attention as attn_lib
from . import parallel
from . import recurrent as rec_lib
from . import transformer as tf
from .common import (NO_SHARDING, LayerSpec, ModelConfig, P, ShardingPolicy,
                     entry_axes, remat, spec_leaves, spec_map, stack_blocks,
                     tree_leaves, tree_map)

LOSS_SEQ_CHUNK = 1024  # CE evaluated in seq chunks to bound logits memory


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _ce_chunk(params: tf.ModelParams, cfg: ModelConfig, h: torch.Tensor,
              labels: torch.Tensor, policy: ShardingPolicy = NO_SHARDING,
              normed: bool = False) -> torch.Tensor:
    """Per-token CE of one chunk.  The reference extracts the gold logit
    with a one-hot contraction for GSPMD's vocab sharding; on one device a
    gather gives the same value bit for bit (every other term of the
    one-hot sum is an exact 0) and the same gradient, without a (B, C, V)
    float32 one-hot.  Under a policy the logits are this rank's vocabulary
    block (``parallel.vocab_cross_entropy``); ``normed``: ``h`` is
    ``tf.head_input``'s."""
    logits = tf.lm_logits(params, cfg, h, policy=policy,
                          normed=normed).float()
    if policy.enabled:
        return parallel.vocab_cross_entropy(logits, labels, policy.ctx)
    m = logits.max(dim=-1, keepdim=True).values.detach()
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return logz - gold


def loss_fn(params: tf.ModelParams, cfg: ModelConfig, batch: dict, *,
            policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """Mean next-token cross entropy.  batch: dict(tokens, labels[, frames,
    patches]).  Under a policy, ``params`` and ``batch`` are this rank's
    shards (its rows of the global batch over the dp axes) and the value is
    the global mean on every rank: this rank's mean over its rows / |dp|,
    summed over dp (the backward of the sum is the identity, so each rank
    differentiates its own share).  Under sequence parallelism the
    forward's result is this rank's block of the sequence; the blocks are
    final-normed and gathered once (``tf.head_input``) before the chunks
    of the head."""
    enc = None
    if cfg.encoder_layers:
        enc = tf.encode(params, cfg, batch["frames"], policy=policy)
    patches = batch.get("patches")
    h = tf.forward(params, cfg, batch["tokens"], extra_embeds=patches,
                   encoder_out=enc, policy=policy)
    pol = policy.with_sequence(_positions(batch))
    if pol.seq:     # the norm's float32 temporaries recomputed, not held
        h = remat(tf.head_input, params, cfg, h, pol)
    labels = batch["labels"]
    if patches is not None:
        h = h[:, patches.shape[1]:]     # loss on text positions only
    S = h.shape[1]
    C = min(LOSS_SEQ_CHUNK, S)
    if S % C:
        C = S
    per_chunk = [remat(_ce_chunk, params, cfg, h[:, i:i + C],
                       labels[:, i:i + C], policy, pol.seq)
                 for i in range(0, S, C)]
    loss = torch.stack(per_chunk).mean()
    if policy.enabled and policy.ctx.dp_size > 1:
        loss = parallel.reduce_out(loss / policy.ctx.dp_size, policy.ctx,
                                   axes=policy.dp)
    return loss


def _positions(batch: dict) -> int:
    """The positions ``tf.forward`` runs over: the tokens and any VLM
    prefix."""
    patches = batch.get("patches")
    return batch["tokens"].shape[1] + (0 if patches is None
                                       else patches.shape[1])


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


def loss_and_grads(params: tf.ModelParams, cfg: ModelConfig, batch: dict,
                   micro_batches: int = 1, *,
                   policy: ShardingPolicy = NO_SHARDING, specs=None):
    """(mean loss, grads as a tree like ``params``).  ``micro_batches`` > 1
    splits the batch's leading axis into that many micro-batches and sums
    their gradients in float32, then divides by the count (the reference's
    gradient-accumulation scan).  The params' leaves require grad while it
    runs and get their own ``requires_grad`` back on exit.  Under a policy
    the grads are this rank's shards of the global gradient: a leaf
    replicated over the dp axes has its gradient all-reduced over them
    (``specs``: ``tf.param_specs(cfg, policy)``, made here when not
    given)."""
    leaves = tree_leaves(params)
    was = [p.requires_grad for p in leaves]
    for p in leaves:
        p.requires_grad_(True)

    def one(b):
        loss = loss_fn(params, cfg, b, policy=policy)
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    try:
        if micro_batches == 1:
            loss, flat = one(batch)
        else:
            u = micro_batches
            flat = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            loss = 0.0
            for i in range(u):
                micro = {k: v.reshape(u, v.shape[0] // u, *v.shape[1:])[i]
                         for k, v in batch.items() if v is not None}
                l_i, g_i = one(micro)
                for acc, g in zip(flat, g_i):
                    acc.add_(g)
                loss = loss + l_i
            for acc in flat:
                acc.div_(u)
            loss = loss / u
    finally:
        for p, w in zip(leaves, was):
            p.requires_grad_(w)
    if policy.enabled and policy.ctx.dp_size > 1:
        if specs is None:
            specs = tf.param_specs(cfg, policy)
        for g, sp in zip(flat, spec_leaves(params, specs)):
            held = {a for e in sp for a in entry_axes(e)}
            parallel.all_reduce_(g, [a for a in policy.dp if a not in held],
                                 policy.ctx)
    it = iter(flat)
    return loss, tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    micro_batches: int = 1, *,
                    policy: ShardingPolicy = NO_SHARDING):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: one
    forward and backward (``loss_and_grads``), then ``adamw.apply``.  The
    state's tensors are updated in place; the returned ``TrainState`` holds
    them.  Under a policy, ``state`` and ``batch`` are this rank's shards
    (``convert.shard_train_state``, the dp rows of the batch) and the
    metrics are global."""
    specs = tf.param_specs(cfg, policy) if policy.enabled else None

    def train_step(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(state.params, cfg, batch, micro_batches,
                                     policy=policy, specs=specs)
        params, opt, gnorm = adamw.apply(opt_cfg, grads, state.opt,
                                         state.params, policy=policy,
                                         specs=specs)
        return TrainState(params, opt), {"loss": loss, "grad_norm": gnorm}

    return train_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    """Per-layer mixer states, stacked (num_blocks, ...) per pattern slot.

    ``cross_kv`` (enc-dec only): the encoder's K/V per decoder layer,
    (num_blocks, B, F, Hkv, hd) pairs per slot."""

    layer_states: Any
    position: torch.Tensor
    cross_kv: Any = None
    tail_states: Any = None


def _layer_state(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                 prefill_len: int, generator, dtype, device):
    if spec.kind in ("global", "local"):
        window = spec.window if spec.kind == "local" else None
        return attn_lib.init_cache(cfg, batch, max_len, window, dtype,
                                   prefill_len, generator, device)
    if spec.kind == "rglru":
        return rec_lib.init_rglru_state(cfg, batch, generator, device)
    if spec.kind == "ssd":
        return rec_lib.init_ssd_state(cfg, batch, generator, device)
    raise ValueError(spec.kind)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      prefill_len: int = 0,
                      generator: torch.Generator | None = None,
                      dtype=torch.bfloat16, device=None, *,
                      policy: ShardingPolicy = NO_SHARDING) -> DecodeState:
    """Stand-in (or empty) decode state for every layer.

    With ``prefill_len`` the caches hold a prefix of that many tokens in
    the ring layout; with a generator their content (and the recurrent
    states and whisper's ``cross_kv``) is random, drawn on the generator's
    device, else zeros on ``device`` (``cuda:0`` by default).  Under a
    policy, this rank's shards of it (``serving_state_specs``): every rank
    draws the same values in the same order, one layer's state (or one
    ``cross_kv`` leaf) at a time, and keeps copies of its slices."""
    dev = generator.device if generator is not None else resolve_device(device)
    one = lambda spec: _layer_state(  # noqa: E731
        cfg, spec, batch, max_len, prefill_len, generator, dtype, dev)
    keep = lambda tree, specs: tree  # noqa: E731
    sp = None
    if policy.enabled:
        sp = serving_state_specs(cfg, policy)
        coord, size = policy.ctx.coord, policy.ctx.size

        def keep(tree, specs):
            return parallel.shard_tree(tree, specs, coord, size)

    pick = (lambda f: None) if sp is None else (lambda f: f(sp))  # noqa: E731
    states = tuple(
        stack_blocks(lambda _, s=s, spec=spec: keep(one(spec), pick(
            lambda t: spec_map(lambda e: P(*e[1:]), t.layer_states[s]))),
            cfg.num_blocks)
        for s, spec in enumerate(cfg.pattern))
    cross_kv = None
    if cfg.encoder_layers:
        shape = (cfg.num_blocks, batch, cfg.encoder_frames, cfg.num_kv_heads,
                 cfg.hd)
        cross_kv = tuple(
            keep(torch.randn(shape, generator=generator, dtype=dtype,
                             device=dev) * 0.02 if generator is not None
                 else torch.zeros(shape, dtype=dtype, device=dev),
                 pick(lambda t, i=i: t.cross_kv[i]))
            for i in range(2 * len(cfg.pattern)))
    tail_states = (tuple(keep(one(ls), pick(lambda t, i=i: t.tail_states[i]))
                         for i, ls in enumerate(cfg.tail))
                   if cfg.tail else None)
    return DecodeState(
        layer_states=states,
        position=torch.tensor(prefill_len, dtype=torch.int32, device=dev),
        cross_kv=cross_kv, tail_states=tail_states)


def cross_kv_from_encoder(params: tf.ModelParams, cfg: ModelConfig,
                          enc: torch.Tensor, dtype=None) -> tuple:
    """``DecodeState.cross_kv`` of an encoder output (B, F, D): each decoder
    layer's cross-attention keys and values, stacked per slot as
    ``init_decode_state`` lays them out (the reference's serving step takes
    them as given; ``encode`` is how a prompt's audio gets there)."""
    out = []
    for s in range(len(cfg.pattern)):
        kv = [tf.enc_kv(tf.block(params.blocks[s], b), enc)
              for b in range(cfg.num_blocks)]
        out += [torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])]
    return tuple(a.to(dtype or a.dtype) for a in out)


def decode_state_specs(cfg: ModelConfig, policy: ShardingPolicy
                       ) -> DecodeState:
    """The ``P`` tree of a ``DecodeState``, as the reference's table:
    caches sharded by batch over dp and KV heads over tp, or by slot over
    tp when the KV heads do not divide (context parallelism); recurrent
    state channels over tp where they divide (the SSD's ``h`` by
    ``recurrent.ssd_layout``)."""
    b = policy.batch()
    tkv = policy.shard_if(cfg.num_kv_heads)
    tw = None if tkv is not None else policy.tp

    def one(spec: LayerSpec, lead: tuple):
        if spec.kind in ("global", "local"):
            return attn_lib.KVCache(
                k=P(*lead, b, tw, tkv, None), v=P(*lead, b, tw, tkv, None),
                pos=P(*lead, tw), length=P(*lead))
        if spec.kind == "rglru":
            tr = policy.shard_if(cfg.rglru_width)
            return rec_lib.RGLRUState(h=P(*lead, b, tr),
                                      conv=P(*lead, b, None, tr))
        if spec.kind == "ssd":     # by its layout: heads, N or neither
            return rec_lib.ssd_state_spec(cfg, policy, lead)
        raise ValueError(spec.kind)

    ckv = None
    if cfg.encoder_layers:
        ckv = tuple(P(None, b, None, tkv, None)
                    for _ in range(2 * len(cfg.pattern)))
    return DecodeState(
        layer_states=tuple(one(sp, (None,)) for sp in cfg.pattern),
        position=P(), cross_kv=ckv,
        tail_states=(tuple(one(sp, ()) for sp in cfg.tail)
                     if cfg.tail else None))


def context_parallel_specs(slot_axes: tuple, tkv,
                           d_specs: DecodeState) -> DecodeState:
    """``d_specs`` with every KV cache's slots sharded over ``slot_axes``
    and its KV heads over ``tkv`` (the reference's
    ``launch.specs._context_parallel_specs``: ``long_500k``'s B = 1
    cannot shard the batch)."""

    def fix(node):
        if isinstance(node, attn_lib.KVCache):
            lead = (None,) if len(node.pos) == 2 else ()   # stacked
            return attn_lib.KVCache(
                k=P(*lead, None, slot_axes, tkv, None),
                v=P(*lead, None, slot_axes, tkv, None),
                pos=P(*lead, slot_axes), length=P(*lead))
        if node is None or isinstance(node, P):
            return node
        out = [fix(n) for n in node]
        return type(node)(*out) if hasattr(node, "_fields") else tuple(out)

    return fix(d_specs)


def serving_state_specs(cfg: ModelConfig, policy: ShardingPolicy
                        ) -> DecodeState:
    """The layout of the ``DecodeState`` the decode step runs on under
    ``policy``: ``decode_state_specs`` where the batch shards over dp,
    else its context-parallel form over every mesh axis but tp."""
    d_specs = decode_state_specs(cfg, policy)
    if policy.dp:
        return d_specs
    return context_parallel_specs(attn_lib.decode_layout(cfg, policy)[0],
                                  policy.shard_if(cfg.num_kv_heads), d_specs)


def _store(state, new) -> None:
    """Write a layer's new recurrent state into its slice of the stacked
    state.  A KV cache was written in place by ``decode_attention``."""
    if isinstance(state, attn_lib.KVCache):
        return
    for dst, src in zip(state, new):
        dst.copy_(src)


def make_decode_step(cfg: ModelConfig, policy: ShardingPolicy = NO_SHARDING):
    """One-token decode: (params, DecodeState, token (B,1)) -> (logits,
    state), recording no autograd graph.  Under a policy
    (``launch.specs.make_policy(mesh, B, "decode")``): this rank's shards
    of the params and of the state (``serving_state_specs``) and its rows
    of the tokens; the logits are its rows and vocabulary block.  The FSDP
    weights stay sharded whatever the policy's ``weight_gather`` (the
    reference's decode policy turns it off; a gathered weight gives the
    same values)."""
    if policy.enabled and policy.weight_gather:
        policy = dataclasses.replace(policy, weight_gather=False)

    @torch.no_grad()
    def decode_step(params: tf.ModelParams, state: DecodeState,
                    token: torch.Tensor):
        x = tf.embed_tokens(params, cfg, token, policy=policy)
        for b in range(cfg.num_blocks):
            for s, spec in enumerate(cfg.pattern):
                st = tf.block(state.layer_states[s], b)
                ckv = (None if state.cross_kv is None else
                       (state.cross_kv[2 * s][b], state.cross_kv[2 * s + 1][b]))
                x, ns = tf.apply_layer(tf.block(params.blocks[s], b), cfg,
                                       spec, x, None, state=st, decode=True,
                                       enc_kv=ckv, policy=policy)
                _store(st, ns)
        if params.tail is not None:
            for lp, spec, st in zip(params.tail, cfg.tail, state.tail_states):
                x, ns = tf.apply_layer(lp, cfg, spec, x, None, state=st,
                                       decode=True, policy=policy)
                _store(st, ns)
        logits = tf.lm_logits(params, cfg, x, policy=policy)
        return logits, state._replace(position=state.position + 1)

    return decode_step


def make_prefill_step(cfg: ModelConfig,
                      policy: ShardingPolicy = NO_SHARDING):
    """Full-sequence forward; returns last-position logits (no autograd
    graph).  ``batch``: dict(tokens[, frames, patches]).  Under a policy
    (``launch.specs.make_policy(mesh, B, "prefill")``): this rank's shards
    of the params and its rows of the batch (its block of the sequence
    between layers, under sequence parallelism); the logits are its rows
    and vocabulary block.  The FSDP weights are gathered before their use
    whatever the policy's ``weight_gather``."""
    if policy.enabled and not policy.weight_gather:
        policy = dataclasses.replace(policy, weight_gather=True)

    @torch.no_grad()
    def prefill_step(params: tf.ModelParams, batch) -> torch.Tensor:
        enc = None
        if cfg.encoder_layers:
            enc = tf.encode(params, cfg, batch["frames"], policy=policy)
        h = tf.forward(params, cfg, batch["tokens"],
                       extra_embeds=batch.get("patches"), encoder_out=enc,
                       policy=policy)
        if policy.with_sequence(_positions(batch)).seq:
            # each rank holds a block of the sequence: the last rank's
            # last position is the sequence's
            h = parallel.tp_gather(h[:, -1:], 1, policy.ctx)
        return tf.lm_logits(params, cfg, h[:, -1:], policy=policy)

    return prefill_step
