"""The Mamba2 SSD over tp where its heads do not divide (``recurrent.
ssd_layout`` / ``ssd_plan``): the core sharded by its state width N (the
"state" layout, the ranks' partial outputs reduce-scattered along the
H * P channels), and the replicated core whose gate, norm and ``w_out``
run on this rank's channels, cutting a head.

Three configs of ``smoke("mamba2-130m")`` in float32 (P = 8 unless said):

* ``state``: d_model = 20, so H = 5, H * P = 40 and N = 16: the state
  layout at tp = 2 and 4, the tail on channels;
* ``replicated``: the same with N = 6: at tp = 4 neither H nor N
  divides, the replicated core with the channel tail;
* ``whole_tail``: d_model = 21, P = 6, so H = 7, H * P = 42: at tp = 4 the
  state layout whose channels do not divide (the partial outputs
  all-reduced, the tail whole on every rank).

One spawn of 2 gloo ranks on (1, 2) (``state``, and its planted fault:
``dt_bias`` not entered through ``copy_in``), one of 4 on (1, 4) (all
three) and one of 4 on (2, 2) (``state`` with the batch and the FSDP
weights over "data").  Each rank takes its shards of the reference's
weights and states (its key 0 and 1) and its rows of a batch made with
numpy from a seed, and runs:

* ``loss_and_grads`` and one ``train_step`` with sequence parallelism on
  and off (gathered grads and state), against the reference's one-device
  values within the bounds of ``test_torch_lm_train*.py`` (loss 1e-5
  relative, grads 1e-4 of their scale, state 2 lr_t + 1e-6);
* a prefill's last-position logits, and the first layer's mixer
  (``recurrent.ssd``) on this rank's block of a random input: its output
  and its ``h_last`` (this rank's state shard, gathered), within 1e-5 of
  scale;
* ``STEPS`` decode steps on the decode state's shards: each step's logits
  and the final state, gathered, within 1e-5 of scale; each rank's ``h``
  shaped as ``decode_state_specs`` cuts it, (B, H, P, N / tp) or (B, H, P,
  N).

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

B, S, PREFILL, MAX_LEN, STEPS = 2, 16, 20, 32, 4
REL = 1e-5
CONFIGS = {"state": dict(d_model=20),
           "replicated": dict(d_model=20, ssm_state=6),
           "whole_tail": dict(d_model=21, ssm_head_dim=6)}
RUNS = {(1, 2): ("state",), (1, 4): ("state", "replicated", "whole_tail"),
        (2, 2): ("state",)}
CASES = [(m, c) for m, cs in RUNS.items() for c in cs]
# (config, tp) -> (ssd_layout, tail on channels)
PLANS = {("state", 2): ("state", True), ("state", 4): ("state", True),
         ("replicated", 4): ("replicated", True),
         ("whole_tail", 4): ("state", False)}
PLANTED = ((1, 2), "state")


def case_id(case) -> str:
    (d, t), c = case
    return f"{d}x{t}-{c}"


def config(name: str, lib=tarchs, dtype=torch.float32):
    return dataclasses.replace(lib.smoke("mamba2-130m"), dtype=dtype,
                               **CONFIGS[name])


# ---------------------------------------------------------------------------
# the gloo ranks (spawned; importable by name, so no JAX at module level)
# ---------------------------------------------------------------------------
def _skip_dt_bias_copy_in(rec):
    """A ``recurrent._ssd_local`` whose ``dt_bias`` bypasses ``copy_in``:
    each rank's gradient of it stays that rank's share."""
    real = rec._ssd_local

    def planted(p, cfg, policy, plan):
        return real(p, cfg, policy, plan)._replace(dt_bias=p.dt_bias)

    return planted


def _train(cfg, arrays, mesh, rank, policy, out, tag, step=True):
    from repro_torch.models import convert, parallel, zoo
    from repro_torch.models import transformer as tf

    batch = {k[6:]: torch.from_numpy(v) for k, v in arrays.items()
             if k.startswith("batch.")}
    whole = convert.train_state_from_numpy(
        cfg, {k[6:]: v for k, v in arrays.items()
              if k.startswith("train.")}, "cpu")
    sp = tf.param_specs(cfg, policy)
    state = convert.shard_train_state(whole, sp, mesh, rank)
    local = parallel.dp_rows(batch, policy.ctx)
    loss, grads = zoo.loss_and_grads(state.params, cfg, local, policy=policy)
    out[f"{tag}/loss"] = np.float64(loss)
    for k, g in convert.flatten(convert.gather_params(grads, sp,
                                                      mesh)).items():
        out[f"{tag}/grad/{k}"] = g.numpy()
    if not step:
        return
    state, m = zoo.make_train_step(cfg, policy=policy)(state, local)
    out[f"{tag}/step/loss"] = np.float64(m["loss"])
    out[f"{tag}/step/grad_norm"] = np.float64(m["grad_norm"])
    for k, a in convert.flatten(convert.gather_train_state(state, sp,
                                                           mesh)).items():
        out[f"{tag}/step/state/{k}"] = a.numpy()


def _serve(cfg, arrays, mesh, rank, out, tag):
    from repro_torch.launch import specs
    from repro_torch.models import convert, parallel, zoo
    from repro_torch.models import recurrent as rec
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import P

    part = lambda p: {k[len(p):]: v for k, v in arrays.items()  # noqa: E731
                      if k.startswith(p)}
    whole = convert.params_from_numpy(cfg, part("params."), "cpu")
    # prefill: the logits, and the first layer's mixer on this rank's block
    pre = specs.make_policy(mesh, B, "prefill")
    params = convert.shard_params(whole, tf.param_specs(cfg, pre), mesh,
                                  rank)
    batch = parallel.dp_rows({"tokens": torch.from_numpy(
        arrays["batch.tokens"])}, pre.ctx)
    logits = zoo.make_prefill_step(cfg, policy=pre)(params, batch)
    out[f"{tag}/prefill"] = parallel.gather_full(
        logits, P(pre.batch(), None, pre.tp), pre.ctx).numpy()
    lay = pre.with_sequence(S)
    x = parallel.dp_rows({"x": torch.from_numpy(arrays["layer.x"])},
                         pre.ctx)["x"]
    if lay.seq:
        x = parallel.tp_slice(x, 1, lay.ctx)
    with torch.no_grad():
        y, st = rec.ssd(tf.block(params.blocks[0], 0).mixer, cfg, x,
                        policy=lay)
    if lay.seq:
        y = parallel.tp_gather(y, 1, lay.ctx)
    out[f"{tag}/layer/y"] = parallel.gather_full(
        y, P(lay.batch(), None, None), lay.ctx).numpy()
    out[f"{tag}/layer/h"] = parallel.gather_full(
        st.h, rec.ssd_state_spec(cfg, lay).h, lay.ctx).numpy()
    out[f"{tag}/layer/h_shape"] = np.asarray(st.h.shape)
    plan = rec.ssd_plan(cfg, lay)
    out[f"{tag}/plan"] = np.asarray([plan.layout, str(plan.chan)])
    # decode
    pol = specs.make_policy(mesh, B, "decode")
    d_specs = zoo.serving_state_specs(cfg, pol)
    params = convert.shard_params(whole, tf.param_specs(cfg, pol), mesh,
                                  rank)
    state = convert.shard_decode_state(cfg, part("dstate."), d_specs, mesh,
                                       rank, "cpu")
    out[f"{tag}/decode/h_shape"] = np.asarray(
        state.layer_states[0].h.shape)
    tokens = parallel.dp_rows({"t": torch.from_numpy(arrays["tokens"])},
                              pol.ctx)["t"]
    step = zoo.make_decode_step(cfg, policy=pol)
    for i in range(STEPS):
        logits, state = step(params, state, tokens[:, i:i + 1])
        out[f"{tag}/decode/logits/{i}"] = parallel.gather_full(
            logits, P(pol.batch(), None, pol.tp), pol.ctx).numpy()
    for k, a in convert.flatten(convert.gather_decode_state(
            state, d_specs, mesh)).items():
        out[f"{tag}/decode/state/{k}"] = a.numpy()


def _ranks_main(rank, shape, in_dir, out_dir):
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import specs
    from repro_torch.models import recurrent as rec

    torch.set_num_threads(1)
    mesh = (launch.training_mesh("cpu", "2d") if shape == (2, 2)
            else tmesh.make_production_mesh(math.prod(shape)))
    on = specs.make_policy(mesh, B)
    off = dataclasses.replace(on, sp=False)
    out = {}
    for name in RUNS[shape]:
        cfg = config(name)
        arrays = dict(np.load(os.path.join(in_dir, f"{name}.npz")))
        for tag, pol in (("on", on), ("off", off)):
            _train(cfg, arrays, mesh, rank, pol, out, f"{name}/{tag}")
        _serve(cfg, arrays, mesh, rank, out, name)
        if (shape, name) == PLANTED:
            real, rec._ssd_local = rec._ssd_local, _skip_dt_bias_copy_in(rec)
            try:
                _train(cfg, arrays, mesh, rank, on, out, f"{name}/planted",
                       step=False)
            finally:
                rec._ssd_local = real
    if rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, "rank0.npz"), **out)


# ---------------------------------------------------------------------------
# the reference, and one spawn per mesh
# ---------------------------------------------------------------------------
def _reference(name: str, root) -> dict:
    """The reference's inputs written for the ranks, and its one-device
    outputs."""
    import jax
    import jax.numpy as jnp
    from test_torch_lm_archs import as_f64, flat
    from test_torch_lm_train import jax_batch, make_batch

    from repro.configs import archs as jarchs
    from repro.models import recurrent as jrec
    from repro.models import transformer as jtf
    from repro.models import zoo as jzoo
    from repro.models.common import NO_SHARDING
    from repro.optim import adamw as jadamw

    jcfg = config(name, jarchs, jnp.float32)
    jp = jtf.init_params(jax.random.key(0), jcfg)
    train = jzoo.TrainState(jp, jadamw.init(jp))
    batch = make_batch(jcfg, B, S)
    js = jzoo.init_decode_state(jcfg, B, MAX_LEN, prefill_len=PREFILL,
                                key=jax.random.key(1), dtype=jnp.float32)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (B, STEPS), np.int32)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    np.savez(root / f"{name}.npz", tokens=tokens, **{"layer.x": x},
             **{f"train.{k}": v for k, v in flat(train).items()},
             **{f"params.{k}": v for k, v in flat(jp).items()},
             **{f"dstate.{k}": v for k, v in flat(js).items()},
             **{f"batch.{k}": v for k, v in batch.items()})
    ref = {}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_fn(p, jcfg, NO_SHARDING, b)))(
            jp, jax_batch(batch))
    ref["loss"], ref["grads"] = float(jl), flat(jg)
    nxt, m = jax.jit(jzoo.make_train_step(jcfg, NO_SHARDING))(
        train, jax_batch(batch))
    ref["step"] = ({k: float(v) for k, v in m.items()},
                   {k: as_f64(v) for k, v in flat(nxt).items()})
    ref["prefill"] = np.asarray(jax.jit(jzoo.make_prefill_step(
        jcfg, NO_SHARDING))(jp, {"tokens": jnp.asarray(batch["tokens"])}))
    mixer = jax.tree.map(lambda a: a[0], jp.blocks[0].mixer)
    y, st = jrec.ssd(mixer, jcfg, jnp.asarray(x), NO_SHARDING)
    ref["layer/y"], ref["layer/h"] = np.asarray(y), np.asarray(st.h)
    step = jax.jit(jzoo.make_decode_step(jcfg, NO_SHARDING))
    for i in range(STEPS):
        logits, js = step(jp, js, jnp.asarray(tokens[:, i:i + 1]))
        ref[f"decode/logits/{i}"] = np.asarray(logits)
    ref["decode/state"] = flat(js)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": {config: the reference's outputs}, mesh: rank 0's
    results}."""
    root = tmp_path_factory.mktemp("lm_ssd_tp")
    out = {"ref": {name: _reference(name, root) for name in CONFIGS}}
    for shape in RUNS:
        d = root / f"mesh{shape[0]}x{shape[1]}"
        launch.spawn(_ranks_main, math.prod(shape),
                     args=(shape, str(root), str(d)), store_dir=str(root))
        out[shape] = dict(np.load(d / "rank0.npz"))
    return out


def _part(res: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v.astype(np.float64) if v.dtype.kind == "f" else v
            for k, v in res.items() if k.startswith(prefix)}


def _rel(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("sp", ["on", "off"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_loss_and_grads_match_reference(runs, case, sp):
    from test_torch_lm_train import GRAD_REL, LOSS_REL, assert_grads_close

    shape, name = case
    ref, res = runs["ref"][name], runs[shape]
    tl = float(res[f"{name}/{sp}/loss"])
    assert np.isfinite(tl)
    assert abs(tl - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
    assert_grads_close(ref["grads"], _part(res, f"{name}/{sp}/grad/"),
                       GRAD_REL)


@pytest.mark.parametrize("sp", ["on", "off"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_train_step_matches_reference(runs, case, sp):
    from test_torch_lm_train_steps import assert_steps_match

    shape, name = case
    jm, js = runs["ref"][name]["step"]
    res, tag = runs[shape], f"{name}/{sp}/step"
    tm = {"loss": float(res[f"{tag}/loss"]),
          "grad_norm": float(res[f"{tag}/grad_norm"])}
    assert_steps_match([(jm, tm, js, _part(res, f"{tag}/state/"))])


def test_planted_dt_bias_fault_is_caught(runs):
    """``dt_bias`` read by every rank's share without ``copy_in``: its
    gradient is one rank's share, outside the bound, and the loss is
    unchanged (only the backward is wrong)."""
    from test_torch_lm_train import GRAD_REL, LOSS_REL

    shape, name = PLANTED
    ref, res = runs["ref"][name], runs[shape]
    assert abs(float(res[f"{name}/planted/loss"]) - ref["loss"]) <= \
        LOSS_REL * abs(ref["loss"])
    got = _part(res, f"{name}/planted/grad/")
    key = "blocks.0.mixer.dt_bias"
    assert _rel(got[key], ref["grads"][key]) > GRAD_REL
    assert _rel(got["blocks.0.mixer.log_a"],
                ref["grads"]["blocks.0.mixer.log_a"]) <= GRAD_REL


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plan_is_the_layout_table(runs, case):
    shape, name = case
    layout, chan = PLANS[(name, shape[1])]
    assert list(runs[shape][f"{name}/plan"]) == [layout, str(chan)]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_prefill_matches_reference(runs, case):
    shape, name = case
    got, want = runs[shape][f"{name}/prefill"], runs["ref"][name]["prefill"]
    vocab = config(name).vocab_size
    assert got.shape == want.shape == (B, 1, want.shape[-1])
    assert _rel(got[..., :vocab], want[..., :vocab]) <= REL


@pytest.mark.parametrize("what", ["y", "h"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_mixer_output_and_state_match_reference(runs, case, what):
    """The first layer's mixer on this rank's block of the sequence: its
    output and its last state (the decode state's shard), gathered."""
    shape, name = case
    got = runs[shape][f"{name}/layer/{what}"]
    want = runs["ref"][name][f"layer/{what}"]
    assert got.shape == want.shape
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_decode_logits_match_reference(runs, case):
    shape, name = case
    ref, res = runs["ref"][name], runs[shape]
    vocab = config(name).vocab_size
    for i in range(STEPS):
        got, want = res[f"{name}/decode/logits/{i}"], ref[f"decode/logits/{i}"]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _rel(got[..., :vocab], want[..., :vocab]) <= REL, i


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_decode_state_matches_reference(runs, case):
    shape, name = case
    want = runs["ref"][name]["decode/state"]
    got = _part(runs[shape], f"{name}/decode/state/")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert _rel(got[k], w) <= REL, k
    assert int(got["position"]) == PREFILL + STEPS


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_each_rank_holds_its_state_shard(runs, case):
    """Rank 0's ``h``, in decode and as the prefill's ``h_last``, has the
    shape ``decode_state_specs`` cuts it to: (B / dp, H, P, N / tp) in
    the state layout, (B / dp, H, P, N) in the replicated one."""
    from repro_torch.launch import specs
    from repro_torch.models import recurrent as rec
    from repro_torch.models import zoo

    from test_torch_lm_mesh_serve import PortMesh

    shape, name = case
    cfg = config(name)
    H, Pd, N = rec.ssd_dims(cfg)
    dp, tp = shape
    layout = PLANS[(name, tp)][0]
    pol = specs.make_policy(PortMesh(shape), B, "decode")
    spec = zoo.decode_state_specs(cfg, pol).layer_states[0].h
    want = (B // dp, H, Pd, N // tp if layout == "state" else N)
    assert spec == ((None, "data", None, None, "model") if layout == "state"
                    else (None, "data", None, None, None))
    res = runs[shape]
    assert tuple(res[f"{name}/decode/h_shape"]) == (cfg.num_blocks,) + want
    # the prefill's batch rows are the dp rows too
    assert tuple(res[f"{name}/layer/h_shape"]) == want
