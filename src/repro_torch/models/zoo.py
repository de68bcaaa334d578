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
position advanced.  The mesh's ``decode_state_specs`` is not ported (it
is a GSPMD partition spec).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from ..optim import adamw
from . import attention as attn_lib
from . import recurrent as rec_lib
from . import transformer as tf
from .common import (LayerSpec, ModelConfig, remat, tree_leaves, tree_map,
                     tree_stack)

LOSS_SEQ_CHUNK = 1024  # CE evaluated in seq chunks to bound logits memory


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _ce_chunk(params: tf.ModelParams, cfg: ModelConfig, h: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE of one chunk.  The reference extracts the gold logit
    with a one-hot contraction for GSPMD's vocab sharding; on one device a
    gather gives the same value bit for bit (every other term of the
    one-hot sum is an exact 0) and the same gradient, without a (B, C, V)
    float32 one-hot."""
    logits = tf.lm_logits(params, cfg, h).float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return logz - gold


def loss_fn(params: tf.ModelParams, cfg: ModelConfig,
            batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy.  batch: dict(tokens, labels[, frames,
    patches])."""
    enc = None
    if cfg.encoder_layers:
        enc = tf.encode(params, cfg, batch["frames"])
    patches = batch.get("patches")
    h = tf.forward(params, cfg, batch["tokens"], extra_embeds=patches,
                   encoder_out=enc)
    labels = batch["labels"]
    if patches is not None:
        h = h[:, patches.shape[1]:]     # loss on text positions only
    S = h.shape[1]
    C = min(LOSS_SEQ_CHUNK, S)
    if S % C:
        C = S
    per_chunk = [remat(_ce_chunk, params, cfg, h[:, i:i + C],
                       labels[:, i:i + C]) for i in range(0, S, C)]
    return torch.stack(per_chunk).mean()


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


def loss_and_grads(params: tf.ModelParams, cfg: ModelConfig, batch: dict,
                   micro_batches: int = 1):
    """(mean loss, grads as a tree like ``params``).  ``micro_batches`` > 1
    splits the batch's leading axis into that many micro-batches and sums
    their gradients in float32, then divides by the count (the reference's
    gradient-accumulation scan).  Marks the params' leaves as requiring
    grad."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def one(b):
        loss = loss_fn(params, cfg, b)
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    if micro_batches == 1:
        loss, flat = one(batch)
    else:
        u = micro_batches
        flat = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
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
    it = iter(flat)
    return loss, tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    micro_batches: int = 1):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``: one
    forward and backward (``loss_and_grads``), then ``adamw.apply``.  The
    state's tensors are updated in place; the returned ``TrainState`` holds
    them."""

    def train_step(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(state.params, cfg, batch, micro_batches)
        params, opt, gnorm = adamw.apply(opt_cfg, grads, state.opt,
                                         state.params)
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
                      dtype=torch.bfloat16, device=None) -> DecodeState:
    """Stand-in (or empty) decode state for every layer.

    With ``prefill_len`` the caches hold a prefix of that many tokens in
    the ring layout; with a generator their content (and the recurrent
    states and whisper's ``cross_kv``) is random, drawn on the generator's
    device, else zeros on ``device`` (``cuda:0`` by default)."""
    dev = generator.device if generator is not None else resolve_device(device)
    one = lambda spec: _layer_state(  # noqa: E731
        cfg, spec, batch, max_len, prefill_len, generator, dtype, dev)
    states = tuple(tree_stack([one(spec) for _ in range(cfg.num_blocks)])
                   for spec in cfg.pattern)
    cross_kv = None
    if cfg.encoder_layers:
        shape = (cfg.num_blocks, batch, cfg.encoder_frames, cfg.num_kv_heads,
                 cfg.hd)
        cross_kv = tuple(
            torch.randn(shape, generator=generator, dtype=dtype,
                        device=dev) * 0.02 if generator is not None
            else torch.zeros(shape, dtype=dtype, device=dev)
            for _ in range(2 * len(cfg.pattern)))
    tail_states = (tuple(one(sp) for sp in cfg.tail) if cfg.tail else None)
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


def _store(state, new) -> None:
    """Write a layer's new recurrent state into its slice of the stacked
    state.  A KV cache was written in place by ``decode_attention``."""
    if isinstance(state, attn_lib.KVCache):
        return
    for dst, src in zip(state, new):
        dst.copy_(src)


def make_decode_step(cfg: ModelConfig):
    """One-token decode: (params, DecodeState, token (B,1)) -> (logits,
    state)."""

    def decode_step(params: tf.ModelParams, state: DecodeState,
                    token: torch.Tensor):
        x = tf.embed_tokens(params, cfg, token)
        for b in range(cfg.num_blocks):
            for s, spec in enumerate(cfg.pattern):
                st = tf.block(state.layer_states[s], b)
                ckv = (None if state.cross_kv is None else
                       (state.cross_kv[2 * s][b], state.cross_kv[2 * s + 1][b]))
                x, ns = tf.apply_layer(tf.block(params.blocks[s], b), cfg,
                                       spec, x, None, state=st, decode=True,
                                       enc_kv=ckv)
                _store(st, ns)
        if params.tail is not None:
            for lp, spec, st in zip(params.tail, cfg.tail, state.tail_states):
                x, ns = tf.apply_layer(lp, cfg, spec, x, None, state=st,
                                       decode=True)
                _store(st, ns)
        logits = tf.lm_logits(params, cfg, x)
        return logits, state._replace(position=state.position + 1)

    return decode_step


def make_prefill_step(cfg: ModelConfig):
    """Full-sequence forward; returns last-position logits.  ``batch``:
    dict(tokens[, frames, patches])."""

    def prefill_step(params: tf.ModelParams, batch) -> torch.Tensor:
        enc = None
        if cfg.encoder_layers:
            enc = tf.encode(params, cfg, batch["frames"])
        h = tf.forward(params, cfg, batch["tokens"],
                       extra_embeds=batch.get("patches"), encoder_out=enc)
        return tf.lm_logits(params, cfg, h[:, -1:])

    return prefill_step
