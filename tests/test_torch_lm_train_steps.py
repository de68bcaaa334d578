"""Whole train steps and the optimizer of the LM zoo in the port against
the JAX package's, jitted on the CPU, for each of the ten architectures at
``smoke()`` width in float32 (weights, optimizer state and batches as in
``test_torch_lm_train.py``).

Bounds: two ``train_step``s from the same ``TrainState`` on the same batch
give the loss within 1e-5 relative and the grad norm within 1e-4
relative at each step, ``step`` exactly, and every param, master, m and v
within 2 * lr_t + 1e-6 absolute, lr_t summed over the steps taken (AdamW's
first step is g / (|g| + eps): a float difference of a gradient entry near
0 moves its update by up to lr_t).  ``micro_batches = 2`` against the
reference's accumulation scan, on a dense and an MoE arch.
``adamw.apply`` on the same numpy grads and state: within 1e-6 relative of
each leaf's largest magnitude.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_lm_archs import ARCH_NAMES, as_f64, flat
from test_torch_lm_train import (configs, jax_batch, make_batch, ref_params,
                                 torch_batch)

from repro.models import zoo as jzoo
from repro.models.common import NO_SHARDING
from repro.optim import adamw as jadamw
from repro_torch.models import convert
from repro_torch.models import zoo
from repro_torch.optim import adamw

B, S, STEPS = 2, 16, 2
LOSS_REL = 1e-5
NORM_REL = 1e-4
ADAMW_REL = 1e-6
STATE_ATOL = 1e-6


def lr_at(step: int, cfg=adamw.AdamWConfig()) -> float:
    return cfg.lr * min(step / max(cfg.warmup_steps, 1), 1.0)


@functools.lru_cache(maxsize=None)
def run_steps(name: str, micro_batches: int = 1, batch: int = B,
              capacity_factor: float | None = None):
    """STEPS train steps of both packages from the reference's initial
    TrainState on one batch: per step, (reference metrics, port metrics,
    reference state, port state), states flattened to numpy."""
    jcfg, tcfg = configs(name, capacity_factor=capacity_factor)
    jp = ref_params(jcfg)
    nb = make_batch(jcfg, batch, S)
    jstate = jzoo.TrainState(jp, jadamw.init(jp))
    tstate = convert.train_state_from_numpy(tcfg, flat(jstate), "cpu")
    jstep = jax.jit(jzoo.make_train_step(jcfg, NO_SHARDING,
                                         micro_batches=micro_batches))
    tstep = zoo.make_train_step(tcfg, micro_batches=micro_batches)
    jb, tb = jax_batch(nb), torch_batch(nb)
    out = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()},
                    {k: as_f64(v) for k, v in flat(jstate).items()},
                    {k: as_f64(v.detach().clone()) for k, v in
                     convert.flatten(tstate).items()}))
    return out


def assert_steps_match(steps):
    for i, (jm, tm, js, ts) in enumerate(steps, start=1):
        assert np.isfinite(tm["loss"]) and np.isfinite(tm["grad_norm"])
        assert abs(tm["loss"] - jm["loss"]) <= LOSS_REL * abs(jm["loss"])
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= \
            NORM_REL * jm["grad_norm"]
        assert sorted(js) == sorted(ts)
        assert int(ts["opt.step"]) == int(js["opt.step"]) == i
        bound = sum(2 * lr_at(t) for t in range(1, i + 1)) + STATE_ATOL
        for k, r in js.items():
            err = np.abs(ts[k] - r).max()
            assert err <= bound, (i, k, err, bound)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_two_train_steps_match_reference(name):
    assert_steps_match(run_steps(name))


@pytest.mark.parametrize("name", ["qwen3-4b", "qwen3-moe-30b-a3b"])
def test_micro_batches_match_reference(name):
    """B = 4 in 2 micro-batches of 2 (the MoE's capacity is a micro-batch's,
    as in the reference)."""
    assert_steps_match(run_steps(name, micro_batches=2, batch=4))


def _random_opt_state(jcfg, jp, seed: int):
    """A reference OptState past its first step (step 5, non-zero moments)
    and grads of the params' shapes, as numpy-backed JAX arrays."""
    rng = np.random.default_rng(seed)
    leaves, tdef = jax.tree.flatten(jp)

    def like(scale, positive=False):
        out = []
        for a in leaves:
            x = rng.standard_normal(a.shape).astype(np.float32) * scale
            out.append(jnp.asarray(np.abs(x) if positive else x))
        return jax.tree.unflatten(tdef, out)

    opt = jadamw.OptState(
        master=jax.tree.map(lambda a: a.astype(jnp.float32), jp),
        m=like(1e-3), v=like(1e-5, positive=True),
        step=jnp.asarray(5, jnp.int32))
    return opt, like(0.05)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_adamw_apply_matches_reference(name):
    """The same numpy grads and state through both optimizers: the norm,
    every param, master, m and v within 1e-6 relative, step exact.  Grads
    of scale 0.05 over these leaves norm past the clip of 1.0, so the
    clipping scale is live."""
    jcfg, tcfg = configs(name)
    jp = ref_params(jcfg)
    jopt, jg = _random_opt_state(jcfg, jp, seed=1)
    cfg = jadamw.AdamWConfig()
    new_p, new_opt, jnorm = jax.jit(
        lambda g, o, p: jadamw.apply(cfg, g, o, p))(jg, jopt, jp)
    ts = convert.train_state_from_numpy(
        tcfg, flat(jzoo.TrainState(jp, jopt)), "cpu")
    tg = convert.params_from_numpy(tcfg, flat(jg), "cpu")
    params, opt, tnorm = adamw.apply(adamw.AdamWConfig(), tg, ts.opt,
                                     ts.params)
    assert float(jnorm) > 1.0
    assert abs(float(tnorm) - float(jnorm)) <= ADAMW_REL * float(jnorm)
    ref = flat(jzoo.TrainState(new_p, new_opt))
    got = convert.flatten(zoo.TrainState(params, opt))
    assert sorted(ref) == sorted(got)
    assert int(got["opt.step"]) == int(ref["opt.step"]) == 6
    for k, r in ref.items():
        if k == "opt.step":
            continue
        r = as_f64(r)
        err = np.abs(as_f64(got[k].detach()) - r).max()
        assert err <= ADAMW_REL * np.abs(r).max(), (k, err)


def test_adamw_config_defaults_match_reference():
    assert dataclasses.asdict(adamw.AdamWConfig()) == \
        dataclasses.asdict(jadamw.AdamWConfig())
