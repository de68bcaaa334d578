"""The LM zoo's prefill and decode over a ("data", "model") mesh in the port
(``zoo.make_decode_step`` / ``make_prefill_step`` under a policy, the
decode-state layouts of ``zoo.serving_state_specs``) against the JAX
package's one-device steps, for every architecture at ``smoke()`` width in
float32 (the MoE archs at capacity factor 8, so that neither the mesh's
per-shard capacity nor the one device's drops a routing), on gloo ranks
spawned as processes: one spawn of 2 ranks on a (1, 2) mesh, one of 4 on
(2, 2) and one of 4 on (1, 4), each running every arch.  At B = 2 the
batch shards over "data"; at tp = 4 the smoke archs' one or two KV heads
do not divide, so their caches' slots go over "model" (layout b); the
(2, 2) spawn also runs B = 1, which cannot shard, so the caches' slots go
over "data" (context parallelism, layout c).

The reference's weights (its key 0) and prefilled stand-in decode state
(``init_decode_state(..., key=...)``, ``PREFILL`` of ``MAX_LEN`` slots, so
the window-8 rings wrap during the steps) and the tokens, made with numpy
from a seed, go to every rank as numpy; each takes its shards
(``convert.shard_params``, ``convert.shard_decode_state``) and its rows,
runs ``STEPS`` decode steps and a prefill of ``S`` tokens, and gathers the
logits (over batch and vocabulary) and the state back
(``convert.gather_decode_state``).

Bounds: every decode step's logits and the prefill's last-position logits
within 1e-5 of the reference's largest magnitude (over the real
vocabulary); each float leaf of the gathered state within 1e-5 of its
largest magnitude; positions and lengths exact.  Also: either step under
any ``make_policy`` kind equals it under its own; a rank's
``init_params(policy=)``, drawn one layer at a time, equals the slices of
the whole model drawn at once, bit for bit; and the decode-state layouts
(``serving_state_specs`` and ``specs._context_parallel_specs``) of every
decode cell equal the reference's ``decode_state_specs`` and
``_context_parallel_specs`` leaf by leaf, in axis names, on stand-in
meshes (the reference's functions read only ``axis_names`` and
``shape``).

This module imports no JAX at its top: the spawned ranks import it by
name.  The reference runs in the test's process.
"""
import dataclasses
import math
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import archs as tarchs
from repro_torch.distributed import launch

S, PREFILL, MAX_LEN, STEPS = 12, 20, 32, 4
REL = 1e-5
ARCHS = sorted(tarchs.ARCHS)
# (mesh, the global batches run on it)
RUNS = {(1, 2): (2,), (2, 2): (2, 1), (1, 4): (2,)}
CASES = [(m, b) for m, bs in RUNS.items() for b in bs]
NO_DROP_CF = 8.0


def case_id(case) -> str:
    (d, t), b = case
    return f"{d}x{t}-B{b}"


def smoke_f32(name: str):
    cfg = dataclasses.replace(tarchs.smoke(name), dtype=torch.float32)
    return dataclasses.replace(cfg, capacity_factor=NO_DROP_CF) \
        if cfg.is_moe else cfg


# ---------------------------------------------------------------------------
# the gloo ranks (spawned; importable by name, so no JAX at module level)
# ---------------------------------------------------------------------------
def _ranks_main(rank, shape, in_dir, out_dir):
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import specs
    from repro_torch.models import convert, parallel, zoo
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import P

    torch.set_num_threads(1)
    mesh = (tmesh.make_production_mesh(math.prod(shape)) if shape[0] == 1
            else launch.training_mesh("cpu", "2d"))
    out = {}
    for name in ARCHS:
        cfg = smoke_f32(name)
        for B in RUNS[shape]:
            tag = f"{name}/B{B}"
            arrays = dict(np.load(os.path.join(in_dir, f"{name}-B{B}.npz")))
            part = lambda p: {k[len(p):]: v for k, v in arrays.items()  # noqa: E731
                              if k.startswith(p)}
            whole = convert.params_from_numpy(cfg, part("params."), "cpu")
            pol = specs.make_policy(mesh, B, "decode")
            d_specs = zoo.serving_state_specs(cfg, pol)
            params = convert.shard_params(whole, tf.param_specs(cfg, pol),
                                          mesh, rank)
            state = convert.shard_decode_state(cfg, part("state."), d_specs,
                                               mesh, rank, "cpu")
            tokens = parallel.dp_rows(
                {"t": torch.from_numpy(arrays["tokens"])}, pol.ctx)["t"]
            vocab = P(pol.batch(), None, pol.tp)
            step = zoo.make_decode_step(cfg, policy=pol)
            for i in range(STEPS):
                logits, state = step(params, state, tokens[:, i:i + 1])
                out[f"{tag}/logits/{i}"] = parallel.gather_full(
                    logits, vocab, pol.ctx).numpy()
            for k, a in convert.flatten(convert.gather_decode_state(
                    state, d_specs, mesh)).items():
                out[f"{tag}/state/{k}"] = a.numpy()
            pre_pol = specs.make_policy(mesh, B, "prefill")
            pre_params = convert.shard_params(
                whole, tf.param_specs(cfg, pre_pol), mesh, rank)
            batch = parallel.dp_rows(
                {k[6:]: torch.from_numpy(v) for k, v in arrays.items()
                 if k.startswith("batch.")}, pre_pol.ctx)
            pre = zoo.make_prefill_step(cfg, policy=pre_pol)(pre_params,
                                                             batch)
            out[f"{tag}/prefill"] = parallel.gather_full(
                pre, P(pre_pol.batch(), None, pre_pol.tp),
                pre_pol.ctx).numpy()
            if B == RUNS[shape][0]:
                # any make_policy policy: decode under the train policy
                # (weight_gather on), prefill under the decode one
                tpol = specs.make_policy(mesh, B, "train")
                st = convert.shard_decode_state(cfg, part("state."), d_specs,
                                                mesh, rank, "cpu")
                logits, _ = zoo.make_decode_step(cfg, policy=tpol)(
                    params, st, tokens[:, :1])
                pre2 = zoo.make_prefill_step(cfg, policy=pol)(pre_params,
                                                              batch)
                out[f"{name}/any_policy"] = np.asarray(
                    np.array_equal(parallel.gather_full(
                        logits, vocab, pol.ctx).numpy(),
                        out[f"{tag}/logits/0"])
                    and torch.equal(pre2, pre))
                # leaf-by-leaf init == whole, sliced
                specs_ = tf.param_specs(cfg, pol)
                got = tf.init_params(cfg, torch.Generator().manual_seed(3),
                                     policy=pol)
                want = parallel.shard_tree(
                    tf.init_params(cfg, torch.Generator().manual_seed(3)),
                    specs_, pol.ctx.coord, pol.ctx.size)
                got, want = convert.flatten(got), convert.flatten(want)
                out[f"{name}/init_equal"] = np.asarray(
                    sorted(got) == sorted(want) and all(
                        got[k].shape == want[k].shape
                        and torch.equal(got[k], want[k]) for k in want))
    if rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, "rank0.npz"), **out)


# ---------------------------------------------------------------------------
# the reference, and one spawn per mesh
# ---------------------------------------------------------------------------
def _reference(name: str, B: int, root) -> dict:
    """The reference's inputs written for the ranks, and its one-device
    outputs: STEPS decode steps' logits, the final state, the prefill's
    logits."""
    import jax
    import jax.numpy as jnp
    from test_torch_lm_archs import flat
    from test_torch_lm_train import configs

    from repro.models import transformer as jtf
    from repro.models import zoo as jzoo
    from repro.models.common import NO_SHARDING

    jcfg, _ = configs(name, capacity_factor=NO_DROP_CF
                      if tarchs.ARCHS[name].is_moe else None)
    jp = jtf.init_params(jax.random.key(0), jcfg)
    js = jzoo.init_decode_state(jcfg, B, MAX_LEN, prefill_len=PREFILL,
                                key=jax.random.key(1), dtype=jnp.float32)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (B, STEPS), np.int32)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S), np.int32)}
    if jcfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (B, jcfg.encoder_frames, jcfg.d_model)).astype(np.float32)
    if jcfg.vision_tokens:
        batch["patches"] = rng.standard_normal(
            (B, jcfg.vision_tokens, jcfg.d_model)).astype(np.float32)
    np.savez(root / f"{name}-B{B}.npz", tokens=tokens,
             **{f"params.{k}": v for k, v in flat(jp).items()},
             **{f"state.{k}": v for k, v in flat(js).items()},
             **{f"batch.{k}": v for k, v in batch.items()})
    ref = {}
    step = jax.jit(jzoo.make_decode_step(jcfg, NO_SHARDING))
    for i in range(STEPS):
        logits, js = step(jp, js, jnp.asarray(tokens[:, i:i + 1]))
        ref[f"logits/{i}"] = np.asarray(logits)
    ref.update({f"state/{k}": v for k, v in flat(js).items()})
    ref["prefill"] = np.asarray(jax.jit(jzoo.make_prefill_step(
        jcfg, NO_SHARDING))(jp, {k: jnp.asarray(v)
                                 for k, v in batch.items()}))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": {(arch, B): the reference's outputs}, mesh: rank 0's
    results}."""
    root = tmp_path_factory.mktemp("lm_mesh_serve")
    out = {"ref": {(name, b): _reference(name, b, root) for name in ARCHS
                   for b in sorted({b for bs in RUNS.values() for b in bs})}}
    for shape in RUNS:
        d = root / f"mesh{shape[0]}x{shape[1]}"
        launch.spawn(_ranks_main, math.prod(shape),
                     args=(shape, str(root), str(d)), store_dir=str(root))
        out[shape] = dict(np.load(d / "rank0.npz"))
    return out


def _rel(got, want, vocab: int) -> float:
    got, want = got[..., :vocab], want[..., :vocab]
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=case_id)
@pytest.mark.parametrize("name", ARCHS)
def test_mesh_decode_logits_match_reference(runs, case, name):
    shape, B = case
    ref, res = runs["ref"][(name, B)], runs[shape]
    vocab = smoke_f32(name).vocab_size
    for i in range(STEPS):
        got = res[f"{name}/B{B}/logits/{i}"]
        assert got.shape == ref[f"logits/{i}"].shape
        assert np.isfinite(got).all()
        err = _rel(got, ref[f"logits/{i}"], vocab)
        assert err <= REL, (i, err)


@pytest.mark.parametrize("case", CASES, ids=case_id)
@pytest.mark.parametrize("name", ARCHS)
def test_mesh_decode_state_matches_reference(runs, case, name):
    """Every leaf of the gathered state: positions and lengths exact, the
    caches and recurrent states within REL of each leaf's scale."""
    shape, B = case
    ref, res = runs["ref"][(name, B)], runs[shape]
    want = {k[6:]: v for k, v in ref.items() if k.startswith("state/")}
    pre = f"{name}/B{B}/state/"
    got = {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(g.astype(np.float64) - w).max()) / scale
            assert err <= REL, (k, err)
    assert int(got["position"]) == PREFILL + STEPS


@pytest.mark.parametrize("case", CASES, ids=case_id)
@pytest.mark.parametrize("name", ARCHS)
def test_mesh_prefill_matches_reference(runs, case, name):
    shape, B = case
    got = runs[shape][f"{name}/B{B}/prefill"]
    want = runs["ref"][(name, B)]["prefill"]
    assert got.shape == want.shape == (B, 1, want.shape[-1])
    assert _rel(got, want, smoke_f32(name).vocab_size) <= REL


@pytest.mark.parametrize("shape", list(RUNS), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_init_params_by_layer_equals_the_whole_model_sliced(runs, shape,
                                                            name):
    assert bool(runs[shape][f"{name}/init_equal"])


@pytest.mark.parametrize("shape", list(RUNS), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ARCHS)
def test_serving_steps_take_any_policy(runs, shape, name):
    """Decode under the train policy (``weight_gather`` on) equals decode
    under the decode policy, and prefill under the decode policy equals
    prefill under its own, bit for bit: each step sets the weights'
    handling itself."""
    assert bool(runs[shape][f"{name}/any_policy"])


# ---------------------------------------------------------------------------
# the decode-state layouts, no process group
# ---------------------------------------------------------------------------
class PortMesh:
    """A ("data", "model") mesh stand-in for the port: names and sizes."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape):
        self.shape = tuple(shape)

    def size(self, dim: int) -> int:
        return self.shape[dim]


DECODE_CELLS = [(a, s) for a, s in tarchs.cells()
                if tarchs.SHAPES[s]["kind"] == "decode"]
SPEC_MESHES = [(1, 2), (2, 2), (2, 4), (32, 8)]


@pytest.mark.parametrize("mesh_shape", SPEC_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_cell_state_specs_match_reference(arch, shape, mesh_shape):
    """The layout the port's decode cell shards its state by
    (``serving_state_specs``, and ``specs._context_parallel_specs`` on
    ``decode_state_specs`` where the batch cannot shard) equals the
    reference's ``build_cell`` layout, leaf by leaf."""
    from test_torch_lm_mesh_specs import port_spec_table, ref_spec_table

    from repro.configs import archs as jarchs
    from repro.launch import specs as jspecs
    from repro.models import zoo as jzoo
    from repro_torch.launch import specs as tspecs
    from repro_torch.models import zoo as tzoo

    B = tarchs.SHAPES[shape]["global_batch"]
    rmesh = types.SimpleNamespace(
        shape=dict(zip(("data", "model"), mesh_shape)),
        axis_names=("data", "model"))
    rpol = jspecs.make_policy(rmesh, B, "decode")
    want = jzoo.decode_state_specs(jarchs.ARCHS[arch], rpol)
    if not rpol.dp:
        want = jspecs._context_parallel_specs(jarchs.ARCHS[arch], rmesh,
                                              want)
    pmesh = PortMesh(mesh_shape)
    pol = tspecs.make_policy(pmesh, B, "decode")
    cfg = tarchs.ARCHS[arch]
    table = ref_spec_table(want)
    assert port_spec_table(tzoo.serving_state_specs(cfg, pol)) == table
    got = tzoo.decode_state_specs(cfg, pol)
    if not pol.dp:
        got = tspecs._context_parallel_specs(cfg, pmesh, got)
    assert port_spec_table(got) == table
