"""The port's expert-parallel MoE (``moe.moe_ffn_ep``: an all-to-all over
the "model" axis, ``parallel.all_to_all``) against the JAX package's, on
gloo ranks spawned as processes: one spawn for each mesh (1, 2), (2, 2),
(1, 4), (2, 4) and (1, 8) (2, 4 and 8 ranks), the smoke
``qwen3-moe-30b-a3b`` (8 experts, top 2) in float32, B = 4, S = 16.

* (a) At capacity factor 8 (no routing is dropped) each mesh's output
  equals the reference's one-device ``moe_ffn_local`` in this process
  within 1e-5 of the output's largest magnitude.
* (b) At the default capacity factor 1.25 each shard sizes its own
  buffers, so the mesh drops other routings than one device: the output
  is held against the reference's own ``moe_ffn_ep``, run in a subprocess
  on 8 forced host devices on a mesh of Auto axes (``jax.make_mesh``'s
  default Explicit axes make the reference's ``with_sharding_constraint``
  raise: the failure of ``test_distributed.py::test_moe_ep_matches_local``),
  within 1e-5 of scale; each rank's count of kept routings equals a numpy
  reckoning of the reference's per-shard rule on its tokens.
* (c) S = 1 and S = 6 (where the sequence does not split, every tp rank
  routes all of its rows; S = 6 on (2, 2) is where the per-shard and the
  local capacity rules differ) against the reference's ``moe_ffn_ep``,
  1e-5 of scale; and at
  capacity factor 8 the input's and every weight's gradient against the
  port's one-device gradient, 1e-5 of scale (the output's gradient is
  divided by tp, as each expert sees tp copies of a token).
* (d) The whole smoke model on (1, 2), (2, 2) and (1, 4): ``loss_and_grads``
  at the default capacity factor against the reference's mesh
  ``value_and_grad`` (same subprocess), the loss within 1e-5 relative and
  every gathered gradient leaf within 1e-4 of its scale (PR 20's bounds).
  The same model at capacity factor 8 against the reference's one-device
  step, two ``train_step``s included, is a case of
  ``test_torch_lm_mesh_steps.py`` (both MoE archs are among its
  ``MESH_ARCHS``).
* (e) A planted fault: the router without its ``copy_in`` (its gradient a
  partial sum over tp) on (1, 2); (d)'s check must fail.

This module imports no JAX at its top: the spawned ranks import it by
name.
"""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import archs as tarchs
from repro_torch.distributed import launch

ARCH = "qwen3-moe-30b-a3b"
B, S = 4, 16
NO_DROP_CF = 8.0
MESHES = [(1, 2), (2, 2), (1, 4), (2, 4), (1, 8)]
STEP_MESHES = [(1, 2), (2, 2), (1, 4)]
PLANTED = "planted"
SCALE_REL = 1e-5
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")

_REFERENCE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs.archs import smoke
from repro.launch import specs
from repro.models import moe, transformer, zoo
in_dir, meshes, step_meshes = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
inp = dict(np.load(in_dir + "/inputs.npz"))
cfg = dataclasses.replace(smoke(%r), dtype=jnp.float32)
p = moe.MoEParams(*(jnp.asarray(inp["moe." + k]) for k in %r))
params = transformer.init_params(jax.random.key(0), cfg)
batch = {k: jnp.asarray(inp["batch." + k]) for k in ("tokens", "labels")}
out = {}
for shape in meshes:
    tag = "%%dx%%d" %% shape
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        pol = specs.make_policy(mesh, %d)
        ep = jax.jit(lambda p, x: moe.moe_ffn_ep(p, cfg, x, pol))
        out[tag + "/ep"] = np.asarray(ep(p, jnp.asarray(inp["x"])))
        out[tag + "/ep_s1"] = np.asarray(ep(p, jnp.asarray(inp["x1"])))
        out[tag + "/ep_s6"] = np.asarray(ep(p, jnp.asarray(inp["x6"])))
        if shape in step_meshes:
            vg = jax.jit(jax.value_and_grad(
                lambda q, b: zoo.loss_fn(q, cfg, pol, b)))
            loss, grads = vg(params, batch)
            out[tag + "/loss"] = np.asarray(loss)
            leaves, _ = jax.tree_util.tree_flatten_with_path(grads)
            for path, v in leaves:
                k = ".".join(str(getattr(e, "name", getattr(e, "idx", None)))
                             for e in path)
                out[tag + "/grad/" + k] = np.asarray(v)
np.savez(in_dir + "/reference.npz", **out)
print("OK")
""" % (ARCH, MOE_KEYS, B)


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# the gloo ranks (spawned; importable by name, so no JAX at module level)
# ---------------------------------------------------------------------------
def _ranks_main(rank, shape, in_dir, out_dir, planted):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import specs
    from repro_torch.models import convert, moe, parallel, zoo
    from repro_torch.models import transformer as tf

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    policy = specs.make_policy(mesh, B)
    ctx = policy.ctx
    inp = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    base = dataclasses.replace(tarchs.smoke(ARCH), dtype=torch.float32)
    exact = dataclasses.replace(base, capacity_factor=NO_DROP_CF)
    out = {"coord": np.asarray([ctx.coord["data"], ctx.coord["model"]])}
    if planted:
        real_copy_in = parallel.copy_in
        parallel.copy_in = lambda x, c: (  # noqa: E731
            x if x.dim() == 2 and x.shape[1] == base.num_experts
            else real_copy_in(x, c))
    else:
        full = moe.MoEParams(*(torch.from_numpy(inp["moe." + k])
                               for k in MOE_KEYS))
        specs_ = moe.moe_specs(base, policy)
        coord, size = parallel.mesh_coords(mesh, rank)
        p = parallel.shard_tree(full, specs_, coord, size)
        kept, real_route = [], moe.route

        def counting_route(*args):
            r = real_route(*args)
            kept.append(int(r.keep.sum()))
            return r

        moe.route = counting_route
        for key, cfg, x in (("ep8", exact, "x"), ("ep", base, "x"),
                            ("ep_s1", base, "x1"), ("ep_s6", base, "x6")):
            xl = parallel.dp_rows({"x": torch.from_numpy(inp[x])}, ctx)["x"]
            out[key] = moe.moe_ffn(p, cfg, xl, policy=policy).numpy()
        out["kept"] = np.asarray(kept[1])
        moe.route = real_route
        # S = 1 at cf 8: the gradients against one device's
        leaves = moe.MoEParams(*(t.clone().requires_grad_(True) for t in p))
        xl = parallel.dp_rows({"x": torch.from_numpy(inp["x1"])}, ctx)["x"]
        xl.requires_grad_(True)
        w = parallel.dp_rows({"w": torch.from_numpy(inp["w1"])}, ctx)["w"]
        (moe.moe_ffn(leaves, exact, xl, policy=policy) * w).sum().backward()
        out["s1_grad_x"] = xl.grad.numpy()
        for k, g in convert.flatten(parallel.gather_tree(
                moe.MoEParams(*(t.grad for t in leaves)), specs_,
                ctx)).items():
            out[f"s1_grad/{k}"] = g.numpy()
    if shape in STEP_MESHES:
        whole = convert.train_state_from_numpy(
            base, {k[6:]: v for k, v in inp.items()
                   if k.startswith("state.")}, "cpu")
        sp = tf.param_specs(base, policy)
        state = convert.shard_train_state(whole, sp, mesh, rank)
        batch = parallel.dp_rows(
            {k: torch.from_numpy(inp["batch." + k])
             for k in ("tokens", "labels")}, ctx)
        loss, grads = zoo.loss_and_grads(state.params, base, batch,
                                         policy=policy)
        out["loss"] = np.float64(loss)
        for k, g in convert.flatten(
                convert.gather_params(grads, sp, mesh)).items():
            out[f"grad/{k}"] = g.numpy()
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs written once; the reference's subprocess started, then
    one spawn a mesh (and the planted fault's) while it runs.
    {tag: [each rank's results]}, and the reference's arrays."""
    import jax

    from test_torch_lm_archs import flat
    from test_torch_lm_train import configs, make_batch, ref_params

    from repro.models import moe as jmoe
    from repro.models import zoo as jzoo
    from repro.optim import adamw as jadamw

    root = tmp_path_factory.mktemp("moe_ep")
    jcfg, _ = configs(ARCH)
    rng = np.random.default_rng(0)
    jp = ref_params(jcfg)
    arrays = {"x": rng.standard_normal((B, S, jcfg.d_model)),
              "x1": rng.standard_normal((B, 1, jcfg.d_model)),
              "w1": rng.standard_normal((B, 1, jcfg.d_model)),
              "x6": rng.standard_normal((B, 6, jcfg.d_model))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    moe_p = jmoe.init_moe(jax.random.key(0), jcfg)
    arrays.update({f"moe.{k}": np.array(getattr(moe_p, k))
                   for k in MOE_KEYS})
    arrays.update({f"state.{k}": v for k, v in flat(
        jzoo.TrainState(jp, jadamw.init(jp))).items()})
    arrays.update({f"batch.{k}": v
                   for k, v in make_batch(jcfg, B, S).items()})
    np.savez(root / "inputs.npz", **arrays)

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [env["PYTHONPATH"]] * bool(env.get("PYTHONPATH")))
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(root), repr(MESHES),
         repr(STEP_MESHES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out = {}
        for shape, planted in [(s, False) for s in MESHES] + [
                ((1, 2), True)]:
            tag = PLANTED if planted else _tag(shape)
            d = root / tag
            n = math.prod(shape)
            launch.spawn(_ranks_main, n,
                         args=(shape, str(root), str(d), planted),
                         store_dir=str(root))
            out[tag] = [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "OK" in stdout, stderr[-3000:]
    return out, dict(np.load(root / "reference.npz")), arrays


def _rows(ranks, key) -> np.ndarray:
    """The global output: the dp blocks of the model-coordinate-0 ranks,
    in data order (the tp ranks hold the same rows)."""
    lead = sorted((r for r in ranks if r["coord"][1] == 0),
                  key=lambda r: r["coord"][0])
    return np.concatenate([r[key] for r in lead])


def _assert_scaled(got, want, rel=SCALE_REL):
    err = np.abs(got.astype(np.float64) - want).max()
    bound = rel * np.abs(want).max()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_ep_matches_local_without_drops(runs, shape):
    """(a): capacity factor 8 against the reference's one-device
    dispatch."""
    import jax.numpy as jnp

    from test_torch_lm_train import configs

    from repro.models import moe as jmoe
    from repro.models.common import NO_SHARDING

    ranks, _, arrays = runs
    jcfg = dataclasses.replace(configs(ARCH)[0], capacity_factor=NO_DROP_CF)
    p = jmoe.MoEParams(*(jnp.asarray(arrays["moe." + k]) for k in MOE_KEYS))
    want = np.asarray(jmoe.moe_ffn_local(p, jcfg, jnp.asarray(arrays["x"]),
                                         NO_SHARDING))
    _assert_scaled(_rows(ranks[_tag(shape)], "ep8"), want)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_ep_matches_reference_ep_with_drops(runs, shape):
    """(b): the default capacity factor against the reference's EP."""
    ranks, ref, _ = runs
    _assert_scaled(_rows(ranks[_tag(shape)], "ep"), ref[f"{_tag(shape)}/ep"])


def _kept_reckoning(xs: np.ndarray, router: np.ndarray, cfg) -> int:
    """The reference's routing of one shard's tokens in numpy: softmax,
    top k (the lower expert first on ties), token-major ranks, the
    per-shard capacity ceil(T K / E) * cf."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    xt = xs.reshape(-1, xs.shape[-1]).astype(np.float64)
    logits = xt @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    top = np.argsort(-probs, axis=-1, kind="stable")[:, :K].reshape(-1)
    C = max(1, int(max(1, -(-xt.shape[0] * K // E)) * cfg.capacity_factor))
    seen = np.zeros(E, np.int64)
    kept = 0
    for e in top:
        kept += seen[e] < C
        seen[e] += 1
    return kept


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_each_shard_keeps_the_reference_routings(runs, shape):
    """(b): every rank's kept routings, counted by ``moe.route``, equal the
    reference's per-shard rule on that rank's tokens, and some routings
    are dropped (the capacity is what the case exercises)."""
    ranks, _, arrays = runs
    cfg = tarchs.smoke(ARCH)
    d, t = shape
    x = arrays["x"]
    total = 0
    for r in ranks[_tag(shape)]:
        i, j = r["coord"]
        rows, cols = B // d, S // t
        xs = x[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]
        want = _kept_reckoning(xs, arrays["moe.router"], cfg)
        assert int(r["kept"]) == want, (r["coord"], int(r["kept"]), want)
        total += want
    assert total < B * S * cfg.num_experts_per_tok


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_ep_one_token_forward_matches_reference(runs, shape):
    """(c): S = 1, every tp rank routing all of its rows."""
    ranks, ref, _ = runs
    _assert_scaled(_rows(ranks[_tag(shape)], "ep_s1"),
                   ref[f"{_tag(shape)}/ep_s1"])


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_ep_uneven_capacity_matches_reference(runs, shape):
    """(b), (c): S = 6 against the reference's EP.  On (2, 2) a shard
    holds 2 x 3 tokens, where the per-shard capacity ceil(T K / E) * cf
    (2) and the local rule int(T K / E * cf) (1) differ; on tp = 4 and 8
    the sequence does not split and every tp rank routes all its rows."""
    ranks, ref, _ = runs
    _assert_scaled(_rows(ranks[_tag(shape)], "ep_s6"),
                   ref[f"{_tag(shape)}/ep_s6"])


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_ep_one_token_gradients_match_one_device(runs, shape):
    """(c): S = 1 at capacity factor 8: the input's gradient on every rank
    and each weight's gathered gradient equal the port's one-device
    ``moe_ffn_local`` gradients."""
    from repro_torch.models import moe

    ranks, _, arrays = runs
    cfg = dataclasses.replace(tarchs.smoke(ARCH), dtype=torch.float32,
                              capacity_factor=NO_DROP_CF)
    p = moe.MoEParams(*(torch.from_numpy(arrays["moe." + k])
                        .requires_grad_(True) for k in MOE_KEYS))
    x = torch.from_numpy(arrays["x1"]).requires_grad_(True)
    (moe.moe_ffn_local(p, cfg, x) * torch.from_numpy(arrays["w1"])
     ).sum().backward()
    d, _ = shape
    for r in ranks[_tag(shape)]:
        i = r["coord"][0]
        _assert_scaled(r["s1_grad_x"],
                       x.grad.double().numpy()[i * (B // d):
                                               (i + 1) * (B // d)])
        for k, w in zip(MOE_KEYS, p):
            _assert_scaled(r[f"s1_grad/{k}"], w.grad.double().numpy())


def _assert_matches_mesh_reference(res: dict, ref: dict, tag: str):
    from test_torch_lm_train import GRAD_REL, LOSS_REL, assert_grads_close

    jl = float(ref[f"{tag}/loss"])
    tl = float(res["loss"])
    assert np.isfinite(tl) and abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    n = len(f"{tag}/grad/")
    want = {k[n:]: v for k, v in ref.items() if k.startswith(f"{tag}/grad/")}
    got = {k[5:]: v.astype(np.float64) for k, v in res.items()
           if k.startswith("grad/")}
    assert_grads_close(want, got, GRAD_REL)


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_tag)
def test_mesh_loss_and_grads_match_reference_mesh(runs, shape):
    """(d): the whole smoke model at the default capacity factor against
    the reference's ``value_and_grad`` on the same mesh."""
    ranks, ref, _ = runs
    _assert_matches_mesh_reference(ranks[_tag(shape)][0], ref, _tag(shape))


def test_router_without_copy_in_is_caught(runs):
    """(e): the router's gradient left a partial sum over tp fails (d)."""
    ranks, ref, _ = runs
    with pytest.raises(AssertionError):
        _assert_matches_mesh_reference(ranks[PLANTED][0], ref, "1x2")
