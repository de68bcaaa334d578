"""Sequence parallelism of the residual over tp in the port (the policy's
``sp``: ``ShardingPolicy.with_sequence``, ``parallel.seq_enter`` /
``seq_leave``): between layers each tp rank holds (B, S / tp, D), its block
of the sequence, in training and prefill.

One spawn of 2 gloo ranks on a (1, 2) mesh and one of 4 on a (1, 4) mesh
(``launch/mesh.make_production_mesh``), each running every arch at
``smoke()`` width in float32 (the MoE archs at capacity factor 8, as in
``test_torch_lm_mesh_steps.py``) from the reference's initial
``TrainState`` and a B = 2, S = 16 batch:

* under ``make_policy`` (sp on) and under the same policy with sp off:
  ``loss_and_grads`` (gathered) and one ``train_step`` (gathered state),
  each held against the reference's one-device values and against each
  other within the float32 bounds of ``test_torch_lm_train*.py`` (loss
  1e-5 relative, grads 1e-4 of their scale, state 2 lr_t + 1e-6);
* the block input each block's ``remat`` saves, read through
  ``torch.autograd.graph.saved_tensors_hooks`` around the block's
  checkpoint: (B, S / tp, D) with sp, (B, S, D) without (whisper's
  encoder layers: (B, F / tp, D));
* the prefill's last-position logits with sp equal those without, within
  float order;
* the rule where S does not divide tp: qwen3-4b and whisper-large-v3 at
  S = 10 on (1, 4) keep the decoder's residual whole (whisper's 12 frames
  still shard), against the reference at S = 10.

The spawned ranks import this module by name: no JAX at its top.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import archs as tarchs
from repro_torch.distributed import launch

B, S, ODD_S = 2, 16, 10
SHAPES = [(1, 2), (1, 4)]
ARCHS = sorted(tarchs.ARCHS)
ODD_ARCHS = ("qwen3-4b", "whisper-large-v3")
NO_DROP_CF = 8.0
PREFILL_REL = 1e-5


def capacity(name: str) -> float | None:
    return NO_DROP_CF if tarchs.ARCHS[name].is_moe else None


def smoke_f32(name: str):
    cf = capacity(name)
    return dataclasses.replace(tarchs.smoke(name), dtype=torch.float32,
                               **({} if cf is None else
                                  {"capacity_factor": cf}))


# ---------------------------------------------------------------------------
# the gloo ranks (spawned; importable by name, so no JAX at module level)
# ---------------------------------------------------------------------------
def _block_inputs(tf):
    """A ``tf.remat`` that records, through ``saved_tensors_hooks``, the
    first tensor each block's and each encoder layer's checkpoint saves
    (its input); returns (the patched function, the records)."""
    real = tf.remat
    seen = {"block": [], "encoder": []}

    def remat(fn, *args):
        kind = ("block" if fn is tf._block_body else
                "encoder" if fn is tf._encoder_layer else None)
        if kind is None or not torch.is_grad_enabled():
            return real(fn, *args)
        packed = []

        def pack(t):
            packed.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = real(fn, *args)
        seen[kind].append(packed[0])
        return out

    return remat, seen


def _run(cfg, arrays, mesh, rank, policy, out, tag, steps=True):
    from repro_torch.models import convert, parallel, zoo
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import P

    batch = {k[6:]: torch.from_numpy(v) for k, v in arrays.items()
             if k.startswith("batch.")}
    whole = convert.train_state_from_numpy(
        cfg, {k[6:]: v for k, v in arrays.items()
              if k.startswith("state.")}, "cpu")
    sp = tf.param_specs(cfg, policy)
    state = convert.shard_train_state(whole, sp, mesh, rank)
    local = parallel.dp_rows(batch, policy.ctx)
    remat, seen = _block_inputs(tf)
    real, tf.remat = tf.remat, remat
    try:
        loss, grads = zoo.loss_and_grads(state.params, cfg, local,
                                         policy=policy)
    finally:
        tf.remat = real
    out[f"{tag}/loss"] = np.float64(loss)
    for kind, shapes in seen.items():
        out[f"{tag}/saved/{kind}"] = np.asarray(shapes, dtype=np.int64)
    for k, g in convert.flatten(convert.gather_params(grads, sp,
                                                      mesh)).items():
        out[f"{tag}/grad/{k}"] = g.numpy()
    if not steps:
        return
    state, m = zoo.make_train_step(cfg, policy=policy)(state, local)
    out[f"{tag}/step/loss"] = np.float64(m["loss"])
    out[f"{tag}/step/grad_norm"] = np.float64(m["grad_norm"])
    for k, a in convert.flatten(convert.gather_train_state(state, sp,
                                                           mesh)).items():
        out[f"{tag}/step/state/{k}"] = a.numpy()
    params = convert.shard_train_state(whole, sp, mesh, rank).params
    prompt = {k: v for k, v in local.items() if k != "labels"}
    logits = zoo.make_prefill_step(cfg, policy=policy)(params, prompt)
    out[f"{tag}/prefill"] = parallel.gather_full(
        logits, P(None, None, "model"), policy.ctx).numpy()


def _ranks_main(rank, shape, in_dir, out_dir):
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import specs

    torch.set_num_threads(1)
    n = math.prod(shape)
    mesh = tmesh.make_production_mesh(n)
    on = specs.make_policy(mesh, B)
    off = dataclasses.replace(on, sp=False)
    out = {"seq/on": np.asarray(on.with_sequence(S).seq),
           "seq/odd": np.asarray(on.with_sequence(ODD_S).seq)}
    for name in ARCHS:
        cfg = smoke_f32(name)
        arrays = dict(np.load(os.path.join(in_dir, f"{name}.npz")))
        for tag, pol in (("on", on), ("off", off)):
            _run(cfg, arrays, mesh, rank, pol, out, f"{name}/{tag}")
    if shape == (1, 4):
        for name in ODD_ARCHS:
            arrays = dict(np.load(os.path.join(in_dir, f"{name}-odd.npz")))
            _run(smoke_f32(name), arrays, mesh, rank, on, out,
                 f"{name}/odd", steps=False)
    if rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, "rank0.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's inputs written once, then one spawn per mesh
    shape; {shape: rank 0's results}."""
    from test_torch_lm_archs import flat
    from test_torch_lm_train import configs, make_batch, ref_params

    from repro.models import zoo as jzoo
    from repro.optim import adamw as jadamw

    root = tmp_path_factory.mktemp("lm_mesh_sp")
    for name in ARCHS:
        jcfg, _ = configs(name)
        jp = ref_params(jcfg)
        state = flat(jzoo.TrainState(jp, jadamw.init(jp)))
        for suffix, seq in (("", S),) + ((("-odd", ODD_S),)
                                         if name in ODD_ARCHS else ()):
            batch = make_batch(jcfg, B, seq)
            np.savez(root / f"{name}{suffix}.npz",
                     **{f"state.{k}": v for k, v in state.items()},
                     **{f"batch.{k}": v for k, v in batch.items()})
    out = {}
    for shape in SHAPES:
        d = root / f"mesh{shape[0]}x{shape[1]}"
        launch.spawn(_ranks_main, math.prod(shape),
                     args=(shape, str(root), str(d)), store_dir=str(root))
        out[shape] = dict(np.load(d / "rank0.npz"))
    return out


def _part(res: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v.astype(np.float64) if v.dtype.kind == "f" else v
            for k, v in res.items() if k.startswith(prefix)}


def _step(res: dict, tag: str) -> tuple:
    return ({"loss": float(res[f"{tag}/step/loss"]),
             "grad_norm": float(res[f"{tag}/step/grad_norm"])},
            _part(res, f"{tag}/step/state/"))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_sp_loss_and_grads_match_reference(runs, shape, name):
    from test_torch_lm_train import (GRAD_REL, LOSS_REL, assert_grads_close,
                                     reference_grads)

    (jl, jg), _ = reference_grads(name, capacity_factor=capacity(name))
    res = runs[shape]
    tl = float(res[f"{name}/on/loss"])
    assert np.isfinite(tl) and abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    assert_grads_close(jg, _part(res, f"{name}/on/grad/"), GRAD_REL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_sp_train_step_matches_reference(runs, shape, name):
    from test_torch_lm_train_steps import assert_steps_match, run_steps

    jm, _, js, _ = run_steps(name, capacity_factor=capacity(name))[0]
    tm, ts = _step(runs[shape], f"{name}/on")
    assert_steps_match([(jm, tm, js, ts)])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_sp_step_matches_the_replicated_residual(runs, shape, name):
    """sp on against sp off: the same values within the same bounds (a
    reduce-scatter sums in another order than an all-reduce)."""
    from test_torch_lm_train import GRAD_REL, LOSS_REL, assert_grads_close
    from test_torch_lm_train_steps import assert_steps_match

    res = runs[shape]
    on, off = (float(res[f"{name}/{t}/loss"]) for t in ("on", "off"))
    assert abs(on - off) <= LOSS_REL * abs(off)
    assert_grads_close(_part(res, f"{name}/off/grad/"),
                       _part(res, f"{name}/on/grad/"), GRAD_REL)
    om, os_ = _step(res, f"{name}/off")
    nm, ns = _step(res, f"{name}/on")
    assert_steps_match([(om, nm, os_, ns)])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_saved_block_input_is_this_ranks_block(runs, shape, name):
    cfg = tarchs.smoke(name)
    tp = shape[1]
    res = runs[shape]
    S_all = S + cfg.vision_tokens
    assert bool(res["seq/on"])
    on, off = (res[f"{name}/{t}/saved/block"] for t in ("on", "off"))
    assert len(on) == len(off) == cfg.num_blocks
    assert all(tuple(s) == (B, S_all // tp, cfg.d_model) for s in on)
    assert all(tuple(s) == (B, S_all, cfg.d_model) for s in off)
    if cfg.encoder_layers:
        enc = res[f"{name}/on/saved/encoder"]
        assert len(enc) == cfg.encoder_layers
        assert all(tuple(s) == (B, cfg.encoder_frames // tp, cfg.d_model)
                   for s in enc)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_sp_prefill_matches_the_replicated_residual(runs, shape, name):
    res = runs[shape]
    on, off = (res[f"{name}/{t}/prefill"] for t in ("on", "off"))
    assert np.isfinite(on).all()
    scale = np.abs(off).max()
    assert np.abs(on - off).max() <= PREFILL_REL * scale


@pytest.mark.parametrize("name", ODD_ARCHS)
def test_sequence_that_does_not_divide_stays_whole(runs, name):
    """S = 10 over tp = 4: the decoder's residual is whole on every rank
    (whisper's 12 encoder frames still shard), and the values are the
    reference's at S = 10."""
    from test_torch_lm_train import (GRAD_REL, LOSS_REL, assert_grads_close,
                                     reference_grads)

    cfg = tarchs.smoke(name)
    res = runs[(1, 4)]
    assert not bool(res["seq/odd"])
    saved = res[f"{name}/odd/saved/block"]
    assert all(tuple(s) == (B, ODD_S, cfg.d_model) for s in saved)
    if cfg.encoder_layers:
        assert all(tuple(s) == (B, cfg.encoder_frames // 4, cfg.d_model)
                   for s in res[f"{name}/odd/saved/encoder"])
    (jl, jg), _ = reference_grads(name, seq=ODD_S)
    tl = float(res[f"{name}/odd/loss"])
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    assert_grads_close(jg, _part(res, f"{name}/odd/grad/"), GRAD_REL)


@pytest.mark.parametrize("S_,kind,tp,want", [
    (16, "train", 4, True), (10, "train", 4, False),
    (1500, "prefill", 8, False), (4096, "prefill", 8, True),
    (16, "decode", 4, False), (16, "train", 1, False)])
def test_with_sequence_rule(S_, kind, tp, want):
    """The rule on a stand-in mesh (sizes only): sp on, tp > 1, weights
    gathered (not decode), S a multiple of tp; the mesh context carries
    over."""
    from repro_torch.launch import specs

    class StandIn:
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (1, tp)[dim]

    pol = specs.make_policy(StandIn(), 2, kind)
    got = pol.with_sequence(S_)
    assert got.seq is want
    assert got.with_sequence(S_) is got
    assert not dataclasses.replace(pol, sp=False).with_sequence(S_).seq
