"""The LM zoo's training path in the port (``zoo.loss_fn``,
``zoo.loss_and_grads``) against the JAX package's (``jax.value_and_grad``
of its ``loss_fn``), jitted on the CPU, for each of the ten architectures
at ``smoke()`` width in float32, from the same weights (carried across by
``models/convert.py``) on the same batch made with numpy from a seed.

Bounds: the loss within 1e-5 relative; every gradient leaf within 1e-4 of
that leaf's largest reference magnitude.  One qwen3 case at B = 1, S =
3072 runs the chunked causal attention (S > 2 * Q_CHUNK) and three CE
chunks.  The port's recomputation (``common.remat``) changes no gradient:
with it and without it the gradients agree within 1e-6 of each leaf's
scale.  The optimizer and whole train steps are in
``test_torch_lm_train_steps.py``, bf16 in ``test_torch_lm_train_bf16.py``
(three files, so that pytest-xdist's ``--dist loadfile`` spreads the
reference's compiles over workers).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_archs import ARCH_NAMES, as_f64, flat

from repro.configs import archs as jarchs
from repro.models import transformer as jtf
from repro.models import zoo as jzoo
from repro.models.common import NO_SHARDING
from repro.optim import adamw as jadamw
from repro_torch.configs import archs as tarchs
from repro_torch.models import common, convert
from repro_torch.models import transformer as ttf
from repro_torch.models import zoo

B, S = 2, 16
LOSS_REL = 1e-5
GRAD_REL = 1e-4
REMAT_REL = 1e-6


def configs(name: str, jdtype=jnp.float32, tdtype=torch.float32,
            capacity_factor: float | None = None):
    """Both packages' smoke configs of ``name`` (an MoE's capacity factor
    replaced when given)."""
    cf = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    return (dataclasses.replace(jarchs.smoke(name), dtype=jdtype, **cf),
            dataclasses.replace(tarchs.smoke(name), dtype=tdtype, **cf))


def make_batch(cfg, batch: int, seq: int, seed: int = 0) -> dict:
    """Tokens and labels (and whisper's frames, internvl2's patches) as
    numpy, from a seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq), np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq), np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.vision_tokens:
        out["patches"] = rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def ref_params(jcfg):
    return jtf.init_params(jax.random.key(0), jcfg)


@functools.lru_cache(maxsize=None)
def reference_grads(name: str, batch: int = B, seq: int = S,
                    capacity_factor: float | None = None):
    """The reference's (loss, {path: grad}) and the port's, from the same
    weights and batch."""
    jcfg, tcfg = configs(name, capacity_factor=capacity_factor)
    jp = ref_params(jcfg)
    nb = make_batch(jcfg, batch, seq)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_fn(p, jcfg, NO_SHARDING, b)))
    jl, jg = vg(jp, jax_batch(nb))
    tp = convert.params_from_numpy(tcfg, flat(jp), "cpu")
    tl, tg = zoo.loss_and_grads(tp, tcfg, torch_batch(nb))
    return ((float(jl), flat(jg)),
            (float(tl), {k: as_f64(v) for k, v in
                         convert.flatten(tg).items()}))


def assert_grads_close(ref: dict, got: dict, rel: float):
    assert sorted(ref) == sorted(got)
    for k, r in ref.items():
        r = as_f64(r)
        bound = rel * max(np.abs(r).max(), 1e-30)
        err = np.abs(got[k] - r).max()
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_matches_reference(name):
    (jl, _), (tl, _) = reference_grads(name)
    assert np.isfinite(tl) and tl > 0.5
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_grads_match_reference(name):
    (_, jg), (_, tg) = reference_grads(name)
    assert_grads_close(jg, tg, GRAD_REL)


def test_chunked_attention_and_loss_match_reference():
    """qwen3 at B = 1, S = 3072: three Q_CHUNK query blocks of the chunked
    causal attention and three LOSS_SEQ_CHUNK chunks of the CE."""
    assert 3072 > 2 * 1024 and 3072 // zoo.LOSS_SEQ_CHUNK == 3
    (jl, jg), (tl, tg) = reference_grads("qwen3-4b", 1, 3072)
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    assert_grads_close(jg, tg, GRAD_REL)


def test_train_state_round_trip_keys():
    """``flatten`` of the port's TrainState gives the reference's keys, and
    ``train_state_from_numpy`` carries every array across unchanged."""
    jcfg, tcfg = configs("whisper-large-v3")
    jp = ref_params(jcfg)
    arrays = flat(jzoo.TrainState(jp, jadamw.init(jp)))
    got = convert.flatten(convert.train_state_from_numpy(tcfg, arrays, "cpu"))
    assert sorted(got) == sorted(arrays)
    assert any(k.startswith("opt.master.encoder.") for k in got)
    for k, a in arrays.items():
        np.testing.assert_array_equal(as_f64(got[k]), as_f64(a), err_msg=k)


@pytest.mark.parametrize("name,seq", [(n, S) for n in ARCH_NAMES] + [
    ("qwen3-4b", 3072), ("gemma2-27b", 3072), ("whisper-large-v3", 2560)])
def test_remat_grads_equal_plain_grads(name, seq, monkeypatch):
    """Gradients with every block, encoder layer, attention chunk and CE
    chunk recomputed in the backward against the same model run plainly
    (``checkpoint`` patched to a call): equal within 1e-6 of each leaf's
    scale.  At S > 2 * Q_CHUNK the chunked causal attention (windowed on
    gemma2's local layers) and whisper's q-chunked cross attention are
    recomputed too."""
    _, tcfg = configs(name)
    nb = torch_batch(make_batch(tcfg, 1, seq, seed=3))
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    calls = []
    real = common.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(common, "checkpoint", counted)
    l1, g1 = zoo.loss_and_grads(params, tcfg, nb)
    C = min(zoo.LOSS_SEQ_CHUNK, seq)
    assert calls.count("_ce_chunk") == (1 if seq % C else seq // C)
    assert calls.count("_block_body") == tcfg.num_blocks
    assert calls.count("_encoder_layer") == tcfg.encoder_layers
    if seq > 2048:
        assert calls.count("_sdpa") >= seq // 1024
    monkeypatch.setattr(common, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    l2, g2 = zoo.loss_and_grads(params, tcfg, nb)
    assert float(l1) == float(l2)
    assert_grads_close({k: as_f64(v) for k, v in
                        convert.flatten(g2).items()},
                       {k: as_f64(v) for k, v in
                        convert.flatten(g1).items()}, REMAT_REL)
