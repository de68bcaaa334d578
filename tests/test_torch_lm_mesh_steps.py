"""The LM zoo's training over a ("data", "model") mesh in the port (tensor
parallelism over "model", batch and ZeRO-3 over "data": ``ShardingPolicy``,
``models/parallel.py``) against the JAX package's one-device
``make_train_step``, for every architecture at ``smoke()`` width in
float32 (the two MoE archs at capacity factor 8: each shard of their
expert-parallel MoE sizes its own buffers, and only where nothing is
dropped does the mesh keep the one device's routings), on gloo ranks spawned as processes: one spawn of 2 ranks on a
(1, 2) mesh, one of 4 on a (2, 2) mesh and one of 4 on a (1, 4) mesh
(tensor parallelism over every rank: the smoke width's 4 heads one a
rank), each running every arch.  The (1, 2) and (1, 4) meshes come from
``launch/mesh.make_production_mesh``, the (2, 2) one from the launcher's
``distributed/launch.training_mesh``.

The reference's initial ``TrainState`` (weights from its key 0, AdamW's
zeros) and a B = 2, S = 16 batch made with numpy from a seed go to every
rank as numpy; each rank takes its shards (``convert.shard_train_state``)
and its batch rows (``parallel.dp_rows``), runs ``loss_and_grads`` and two
``train_step``s under ``make_policy(mesh, 2)``, and the gathered trees
(``convert.gather_params`` / ``gather_train_state``) come back from rank 0.

Bounds (the float32 bounds of ``test_torch_lm_train*.py``):
the loss within 1e-5 relative; every gathered gradient leaf within 1e-4
of its largest reference magnitude; after each step the loss within 1e-5
and the grad norm within 1e-4 relative, ``step`` exact, and every param,
master, m and v within 2 * lr_t + 1e-6 (lr_t summed over the steps).
Also: the mesh builders' shapes and axis names (``make_host_mesh`` too),
the ranks hold shards (a sharded leaf's local shape, an MoE layer's
experts over "model"), and ``build_cell`` returns the step and this
rank's meta shards of qwen3-4b's full ``TrainState``.

This module imports no JAX at its top: the spawned ranks import it by
name.  The reference runs in the test's process.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import archs as tarchs
from repro_torch.distributed import launch

B, S, STEPS = 2, 16, 2
MESH_SHAPES = [(1, 2), (2, 2), (1, 4)]
MESH_ARCHS = sorted(tarchs.ARCHS)
NO_DROP_CF = 8.0                     # the MoE archs' capacity factor here
SHARD_KEY = "blocks.0.mixer.wq"      # (nb, D, H, hd): fsdp x tp sharded
EXPERT_KEY = "blocks.0.ffn.w_gate"   # (nb, E, D, F): tp x fsdp sharded


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
def _ranks_main(rank, shape, in_dir, out_dir):
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import specs
    from repro_torch.models import convert, parallel, zoo
    from repro_torch.models import transformer as tf

    torch.set_num_threads(1)
    n = math.prod(shape)
    mesh = (launch.training_mesh("cpu", "2d") if shape == (2, 2)
            else tmesh.make_production_mesh(n))
    host = tmesh.make_host_mesh(n, "ranks")
    out = {"mesh/shape": np.asarray(tuple(mesh.mesh.shape)),
           "mesh/names": np.asarray(mesh.mesh_dim_names),
           "host/shape": np.asarray(tuple(host.mesh.shape)),
           "host/names": np.asarray(host.mesh_dim_names)}
    policy = specs.make_policy(mesh, B)
    for name in MESH_ARCHS:
        cfg = smoke_f32(name)
        arrays = dict(np.load(os.path.join(in_dir, f"{name}.npz")))
        batch = {k[6:]: torch.from_numpy(v) for k, v in arrays.items()
                 if k.startswith("batch.")}
        whole = convert.train_state_from_numpy(
            cfg, {k[6:]: v for k, v in arrays.items()
                  if k.startswith("state.")}, "cpu")
        sp = tf.param_specs(cfg, policy)
        state = convert.shard_train_state(whole, sp, mesh, rank)
        local = parallel.dp_rows(batch, policy.ctx)
        leaves = convert.flatten(state.params)
        for key in (SHARD_KEY, EXPERT_KEY):
            out[f"{name}/shape/{key}"] = np.asarray(
                leaves[key].shape if key in leaves else ())
        loss, grads = zoo.loss_and_grads(state.params, cfg, local,
                                         policy=policy)
        out[f"{name}/loss"] = np.float64(loss)
        for k, g in convert.flatten(
                convert.gather_params(grads, sp, mesh)).items():
            out[f"{name}/grad/{k}"] = g.numpy()
        step = zoo.make_train_step(cfg, policy=policy)
        for i in range(STEPS):
            state, m = step(state, local)
            out[f"{name}/{i}/loss"] = np.float64(m["loss"])
            out[f"{name}/{i}/grad_norm"] = np.float64(m["grad_norm"])
            for k, a in convert.flatten(
                    convert.gather_train_state(state, sp, mesh)).items():
                out[f"{name}/{i}/state/{k}"] = a.numpy()
    # the train cell of qwen3-4b at full width, as meta tensors
    cell = specs.build_cell("qwen3-4b", "train_4k", mesh)
    st, b = cell.args
    out["cell/kind"] = np.asarray(cell.kind)
    out["cell/callable"] = np.asarray(callable(cell.fn))
    for k, a in convert.flatten(st).items():
        out[f"cell/state/{k}"] = np.asarray(tuple(a.shape) + (
            str(a.dtype), a.device.type), dtype=object)
    for k, a in b.items():
        out[f"cell/batch/{k}"] = np.asarray(tuple(a.shape) + (
            str(a.dtype), a.device.type), dtype=object)
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

    root = tmp_path_factory.mktemp("lm_mesh")
    for name in MESH_ARCHS:
        jcfg, _ = configs(name)
        jp = ref_params(jcfg)
        state = flat(jzoo.TrainState(jp, jadamw.init(jp)))
        batch = make_batch(jcfg, B, S)
        np.savez(root / f"{name}.npz",
                 **{f"state.{k}": v for k, v in state.items()},
                 **{f"batch.{k}": v for k, v in batch.items()})
    out = {}
    for shape in MESH_SHAPES:
        d = root / f"mesh{shape[0]}x{shape[1]}"
        launch.spawn(_ranks_main, math.prod(shape),
                     args=(shape, str(root), str(d)), store_dir=str(root))
        out[shape] = dict(np.load(d / "rank0.npz", allow_pickle=True))
    return out


def _arch_part(res: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", MESH_ARCHS)
def test_mesh_loss_and_grads_match_reference(runs, shape, name):
    from test_torch_lm_train import (GRAD_REL, LOSS_REL, assert_grads_close,
                                     reference_grads)

    (jl, jg), _ = reference_grads(name, capacity_factor=capacity(name))
    res = runs[shape]
    tl = float(res[f"{name}/loss"])
    assert np.isfinite(tl) and abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    got = {k: v.astype(np.float64)
           for k, v in _arch_part(res, f"{name}/grad/").items()}
    assert_grads_close(jg, got, GRAD_REL)


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", MESH_ARCHS)
def test_mesh_train_steps_match_reference(runs, shape, name):
    from test_torch_lm_train_steps import assert_steps_match, run_steps

    ref = run_steps(name, capacity_factor=capacity(name))
    res = runs[shape]
    steps = []
    for i, (jm, _, js, _) in enumerate(ref):
        tm = {"loss": float(res[f"{name}/{i}/loss"]),
              "grad_norm": float(res[f"{name}/{i}/grad_norm"])}
        ts = {k: (v.astype(np.float64) if v.dtype.kind == "f" else v)
              for k, v in _arch_part(res, f"{name}/{i}/state/").items()}
        steps.append((jm, tm, js, ts))
    assert_steps_match(steps)


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_builders(runs, shape):
    """``make_production_mesh(n)`` puts n <= 8 ranks on the model axis;
    the launcher's mesh is (n // 2, 2); ``make_host_mesh`` is one axis of
    every rank."""
    res = runs[shape]
    assert tuple(res["mesh/shape"]) == shape
    assert tuple(res["mesh/names"]) == ("data", "model")
    assert tuple(res["host/shape"]) == (math.prod(shape),)
    assert tuple(res["host/names"]) == ("ranks",)


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ranks_hold_shards(runs, shape):
    """qwen3-4b smoke (d_model 64, 4 heads of 16): the first block's wq is
    (1, 64 / |data|, 4 / |model|, 16) on a rank."""
    d, t = shape
    got = tuple(runs[shape][f"qwen3-4b/shape/{SHARD_KEY}"])
    assert got == (1, 64 // d, 4 // t, 16)


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ranks_hold_their_experts(runs, shape):
    """The smoke qwen3-moe-30b-a3b (8 experts of d_model 64, moe_d_ff
    32): a rank holds 8 / |model| experts' w_gate, their D split over
    |data|, so its mesh steps above ran expert-parallel."""
    d, t = shape
    got = tuple(runs[shape][f"qwen3-moe-30b-a3b/shape/{EXPERT_KEY}"])
    assert got == (1, 8 // t, 64 // d, 32)


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_build_cell_gives_the_ranks_meta_shards(runs, shape):
    """qwen3-4b x train_4k: the step, this rank's meta shards of the full
    state (bf16 params, float32 master / m / v) and its rows of the
    256 x 4096 batch."""
    d, t = shape
    res = runs[shape]
    assert str(res["cell/kind"]) == "train" and bool(res["cell/callable"])
    cfg = tarchs.QWEN3_4B
    H, hd, D = cfg.num_heads, cfg.hd, cfg.d_model
    wq = tuple(res["cell/state/params.blocks.0.mixer.wq"])
    assert wq == (cfg.num_layers, D // d, H // t, hd, "torch.bfloat16",
                  "meta")
    m = tuple(res["cell/state/opt.m.embed"])
    assert m == (153_600 // t, D // d, "torch.float32", "meta")
    assert tuple(res["cell/batch/tokens"]) == (256 // d, 4096,
                                               "torch.int32", "meta")
