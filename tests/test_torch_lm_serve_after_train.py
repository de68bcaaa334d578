"""Fault F5: serving params trained in the same process.

``zoo.loss_and_grads`` marks the params' leaves as requiring grad while it
runs.  The serving steps must record no autograd graph afterwards: a
decode step writes its keys and values into the caches in place, so a
graph there would keep every step's activations alive through the state
(the reference is functional and keeps nothing).  On the CPU, at
``smoke()`` width: after one ``train_step``, a decode step's logits, every
tensor of its state and a prefill's logits carry no ``grad_fn``, the
position still advances, and the leaves get their ``requires_grad`` back.
"""
import pytest
import torch

from repro_torch.configs.archs import ARCHS, smoke
from repro_torch.models import convert, zoo
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw

B, S, MAX_LEN, STEPS = 2, 8, 16, 3


def trained(name: str):
    cfg = smoke(name)
    gen = torch.Generator().manual_seed(0)
    params = tf.init_params(cfg, gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(B, cfg.encoder_frames, cfg.d_model,
                                      generator=gen)
    if cfg.vision_tokens:
        batch["patches"] = torch.randn(B, cfg.vision_tokens, cfg.d_model,
                                       generator=gen)
    state, _ = zoo.make_train_step(cfg)(
        zoo.TrainState(params, adamw.init(params)), batch)
    return cfg, state.params, batch


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_serving_after_training_records_no_graph(name):
    cfg, params, batch = trained(name)
    ds = zoo.init_decode_state(cfg, B, MAX_LEN, prefill_len=2,
                               generator=torch.Generator().manual_seed(1))
    step = zoo.make_decode_step(cfg)
    for i in range(STEPS):
        tok = torch.full((B, 1), i, dtype=torch.long)
        logits, ds = step(params, ds, tok)
        assert logits.grad_fn is None and not logits.requires_grad
        assert int(ds.position) == 2 + i + 1
    for k, t in convert.flatten(ds).items():
        assert t.grad_fn is None and not t.requires_grad, k
    prefill = {k: v for k, v in batch.items() if k != "labels"}
    out = zoo.make_prefill_step(cfg)(params, prefill)
    assert out.grad_fn is None and torch.isfinite(out).all()


def test_loss_and_grads_restores_requires_grad():
    cfg = smoke("qwen3-4b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.long)
    leaves = tree_leaves(params)
    leaves[0].requires_grad_(True)
    zoo.loss_and_grads(params, cfg, {"tokens": toks, "labels": toks})
    assert leaves[0].requires_grad
    assert not any(p.requires_grad for p in leaves[1:])
