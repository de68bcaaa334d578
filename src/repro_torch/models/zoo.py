"""Serving steps for every architecture of ``configs/archs.py``: prefill
and decode.

The port of ``repro.models.zoo``'s serving half.  ``decode_step`` runs one
token against per-layer mixer states (ring KV caches for local layers,
recurrent states for rglru/ssd, a full cache for global attention); every
stream of the batch shares one position, as in the reference.  The state's
tensors are updated in place (the reference donates them to its jitted
step) and the returned ``DecodeState`` holds them with the position
advanced.  The training half (``loss_fn``, ``make_train_step``) and the
mesh's ``decode_state_specs`` are not ported yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..device import resolve_device
from . import attention as attn_lib
from . import recurrent as rec_lib
from . import transformer as tf
from .common import LayerSpec, ModelConfig, tree_stack


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
