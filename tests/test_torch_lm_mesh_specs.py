"""The LM zoo's mesh tables in the port (``launch/roofline.py``,
``launch/specs.py``, ``transformer.param_specs``, ``zoo.decode_state_specs``,
``launch/mesh.py``) against the JAX package's, on the CPU, with no process
group: every function here reads mesh shapes only.

Bounds: all exact.  ``param_counts`` and ``model_flops`` equal (``==``)
the reference's for every ``configs.archs.cells()`` entry (plain Python
arithmetic on the same configs); ``input_specs`` matches in shape and
dtype for every cell (meta tensors against ShapeDtypeStructs); the spec
tables match leaf by leaf, in axis names, for every arch at meshes (1, 2),
(2, 2) and (2, 4); ``make_policy`` matches field by field.  Both packages'
policies get a stand-in mesh with only the shape (the reference's
``shard_if`` reads ``mesh.shape``, the port's ``mesh.size``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import archs as jarchs
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.models import zoo as jzoo
from repro_torch.configs import archs as tarchs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs
from repro_torch.models import convert
from repro_torch.models import transformer as ttf
from repro_torch.models import zoo as tzoo
from repro_torch.models.common import P

CELLS = jarchs.cells()
ARCH_NAMES = sorted(jarchs.ARCHS)
MESHES = [(1, 2), (2, 2), (2, 4)]
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


class PortMesh:
    """A ("data", "model") mesh stand-in for the port's policy: names and
    sizes, no devices."""

    def __init__(self, shape):
        self.mesh_dim_names = ("data", "model")
        self.shape = tuple(shape)

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_coordinate(self):
        return [0] * len(self.shape)


def ref_mesh(shape):
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))


def policies(shape, batch=8, kind="train"):
    return (jspecs.make_policy(ref_mesh(shape), batch, kind),
            tspecs.make_policy(PortMesh(shape), batch, kind))


def ref_spec_table(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {".".join(str(getattr(k, "name", getattr(k, "idx", None)))
                     for k in path): tuple(v) for path, v in leaves}


def port_spec_table(tree) -> dict:
    return {k: tuple(v) for k, v in convert.flatten(tree).items()}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_counts_equal_reference(name):
    assert troof.param_counts(tarchs.ARCHS[name]) == \
        jroof.param_counts(jarchs.ARCHS[name])


def test_qwen3_4b_param_count_leaves_out_norms():
    """The reference counts no norm weights: 4,026,531,840 where qwen3-4b's
    tensors hold 4,026,727,936 (36 layers of two (2560,) norms and two
    (128,) qk-norms, plus the final norm)."""
    cfg = tarchs.QWEN3_4B
    total, active = troof.param_counts(cfg)
    assert total == active == 4_026_531_840
    norms = cfg.num_layers * (2 * cfg.d_model + 2 * cfg.hd) + cfg.d_model
    assert total + norms == 4_026_727_936


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_reference(arch, shape):
    got = troof.model_flops(arch, shape)
    assert got == jroof.model_flops(arch, shape)
    sh = tarchs.SHAPES[shape]
    assert troof.step_flops(tarchs.ARCHS[arch], sh["kind"],
                            sh["global_batch"], sh["seq_len"]) == got


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    ref = jspecs.input_specs(arch, shape)
    got = tspecs.input_specs(arch, shape)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(r.shape), k
        assert got[k].dtype == DTYPES[r.dtype.type], k


def test_train_micro_equals_reference():
    assert tspecs.TRAIN_MICRO == jspecs.TRAIN_MICRO


@pytest.mark.parametrize("shape", MESHES + [(1, 1), (4, 2)])
@pytest.mark.parametrize("batch,kind", [(8, "train"), (1, "train"),
                                        (3, "prefill"), (128, "decode")])
def test_make_policy_matches_reference(shape, batch, kind):
    ref, got = policies(shape, batch, kind)
    for f in ("dp", "tp", "fsdp", "sp", "enabled", "weight_gather"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.tp_size() == ref.tp_size() == shape[1]
    for n in (1, 2, 3, 4, 8, 10, 16):
        assert got.shard_if(n) == ref.shard_if(n), n


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_reference(name, shape):
    ref, got = policies(shape)
    want = ref_spec_table(jtf.param_specs(jarchs.ARCHS[name], ref))
    table = port_spec_table(ttf.param_specs(tarchs.ARCHS[name], got))
    assert table == want
    assert all(isinstance(v, P) for v in
               convert.flatten(ttf.param_specs(tarchs.ARCHS[name],
                                               got)).values())


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_state_specs_match_reference(name, shape):
    ref, got = policies(shape, batch=128, kind="decode")
    want = ref_spec_table(jzoo.decode_state_specs(jarchs.ARCHS[name], ref))
    assert port_spec_table(tzoo.decode_state_specs(tarchs.ARCHS[name],
                                                   got)) == want


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_cover_every_param(name):
    """Every leaf of the smoke params has a spec of its rank, and the specs
    of absent leaves (a bias without ``qkv_bias``) are the reference's
    only extra keys."""
    cfg = tarchs.smoke(name)
    _, pol = policies((2, 2))
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0))
    specs = convert.flatten(ttf.param_specs(cfg, pol))
    leaves = convert.flatten(params)
    assert set(leaves) <= set(specs)
    for k, t in leaves.items():
        assert len(specs[k]) == t.dim(), k
    for k in set(specs) - set(leaves):
        assert k.split(".")[-1] in ("bq", "bk", "bv", "q_norm", "k_norm"), k


def test_spec_entries_normalise_as_jax():
    assert tuple(P(("data",), "model")) == tuple(JP(("data",), "model"))
    assert tuple(P(("pod", "data"), None)) == tuple(JP(("pod", "data"), None))
    assert P(None) == (None,) and P() == ()


def test_h100_constants():
    """The roofline's denominators are the H100 SXM data sheet's (the
    collective bandwidths: NVLink 4 inside a host, 400 Gb/s NDR between
    hosts), and chip_smoke.py takes its own from this module."""
    import chip_smoke

    assert (tmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_F32, tmesh.HBM_BW,
            tmesh.HBM_BYTES) == (989e12, 67e12, 3.35e12, 80e9)
    assert (tmesh.NVLINK_BW, tmesh.NETWORK_BW) == (900e9, 50e9)
    assert tmesh.axis_bandwidth("model", 256) == tmesh.NVLINK_BW
    assert tmesh.axis_bandwidth("data", 256) == tmesh.NETWORK_BW
    assert tmesh.axis_bandwidth("data", 4) == tmesh.NVLINK_BW
    assert chip_smoke.BF16_FLOPS is tmesh.PEAK_FLOPS_BF16
    assert chip_smoke.FP32_FLOPS is tmesh.PEAK_FLOPS_F32
    assert chip_smoke.HBM_BYTES_PER_S is tmesh.HBM_BW


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k", "long_500k"])
def test_build_cell_refuses_serving_cells(kind):
    """Prefill and decode cells are built now (no longer refused): the
    step, and the meta shards of the rank at (0, 0) of a (2, 2) mesh.
    gemma2-27b: the prefill's params (heads over "model", d_model over
    "data") and rows of the 32 x 32,768 batch; decode_32k's global cache
    (batch over "data", KV heads over "model"); long_500k's (B = 1: the
    slots over "data", context parallelism).  No process group is
    touched."""
    cfg = tarchs.ARCHS["gemma2-27b"]
    cell = tspecs.build_cell("gemma2-27b", kind, PortMesh((2, 2)))
    sh = tarchs.SHAPES[kind]
    assert cell.kind == sh["kind"] and callable(cell.fn)
    assert cell.policy.weight_gather == (sh["kind"] != "decode")
    params = cell.args[0]
    wq = params.blocks[0].mixer.wq
    nb, D, H, hd = cfg.num_blocks, cfg.d_model, cfg.num_heads, cfg.hd
    fs = 2 if cell.policy.dp else 1
    assert (tuple(wq.shape), wq.dtype, wq.device.type) == (
        (nb, D // fs, H // 2, hd), torch.bfloat16, "meta")
    if sh["kind"] == "prefill":
        assert tuple(cell.args[1]["tokens"].shape) == (16, 32_768)
        return
    _, state, token = cell.args
    k = state.layer_states[1].k            # the global layers' cache
    if kind == "decode_32k":
        assert tuple(k.shape) == (nb, 64, 32_768, 8, hd)
        assert tuple(token.shape) == (64, 1)
    else:
        assert tuple(k.shape) == (nb, 1, 262_144, 8, hd)
        assert tuple(state.layer_states[1].pos.shape) == (nb, 262_144)
        assert tuple(token.shape) == (1, 1)
    assert k.device.type == "meta" and k.dtype == torch.bfloat16


def test_build_cell_returns_the_moe_train_cell():
    """qwen3-moe-30b-a3b x train_4k on (2, 2), as the rank at (0, 0): the
    step, and the meta shards of its experts (128 over "model", d_model
    2048 over "data") and of its rows of the 256 x 4096 batch; no process
    group is touched."""
    cell = tspecs.build_cell("qwen3-moe-30b-a3b", "train_4k",
                             PortMesh((2, 2)))
    assert cell.kind == "train" and callable(cell.fn)
    state, batch = cell.args
    cfg = tarchs.ARCHS["qwen3-moe-30b-a3b"]
    wg = state.params.blocks[0].ffn.w_gate
    assert (tuple(wg.shape), wg.dtype, wg.device.type) == (
        (cfg.num_layers, 64, 1024, 768), torch.bfloat16, "meta")
    assert tuple(state.opt.m.blocks[0].ffn.router.shape) == (
        cfg.num_layers, 1024, 128)
    assert tuple(batch["tokens"].shape) == (128, 4096)


def test_meta_params_have_the_params_shapes():
    cfg = tarchs.smoke("whisper-large-v3")
    meta = convert.flatten(tspecs.meta_params(cfg))
    real = convert.flatten(ttf.init_params(cfg, torch.Generator()))
    assert sorted(meta) == sorted(real)
    for k, t in real.items():
        assert meta[k].device.type == "meta"
        assert meta[k].shape == t.shape and meta[k].dtype == t.dtype, k


def test_meta_params_of_a_full_config_allocate_nothing():
    meta = convert.flatten(tspecs.meta_params(tarchs.ARCHS["qwen1.5-110b"]))
    n = sum(t.numel() for t in meta.values())
    assert n > 1e11 and all(t.device.type == "meta" for t in meta.values())
    assert np.isclose(n, troof.param_counts(tarchs.ARCHS["qwen1.5-110b"])[0],
                      rtol=1e-3)


def test_lm_mesh_collectives_satisfy_the_checker():
    """A train step over a (1, 2) and a (2, 1) mesh as two recorded ranks:
    every collective from a declared scope of models/parallel.py, float32
    on the wire, over the model and the data group respectively."""
    from repro_torch.analysis import collectives

    assert collectives.check_lm_mesh_wires() == []


def test_lm_mesh_moe_collectives_satisfy_the_checker(monkeypatch):
    """The same for the MoE smoke arch: its expert all-to-all comes from
    ``parallel._all_to_all`` over the model group, float32 on the wire."""
    from repro_torch.analysis import collectives

    calls = []
    real = collectives.check_recorded
    monkeypatch.setattr(collectives, "check_recorded",
                        lambda c: calls.extend(c) or real(c))
    assert collectives.check_lm_mesh_wires(arch="qwen3-moe-30b-a3b") == []
    a2a = [c for c in calls if c["call"] == "all_to_all_single"]
    assert a2a and {(c["scope"], c["role"], c["dtype"]) for c in a2a} == {
        ("_all_to_all", "model", "float32")}


def test_lm_mesh_checker_catches_a_wrong_group(monkeypatch):
    """Planted: the mesh hands out its groups swapped, so the tp
    collectives ride the data group; the checker reports CC001."""
    from repro_torch.analysis import collectives

    real = collectives._SimMesh.get_group
    monkeypatch.setattr(collectives._SimMesh, "get_group",
                        lambda self, dim: real(self, 1 - dim))
    found = collectives.check_lm_mesh_wires(cases=(((1, 2), "model"),))
    assert found and {f.code for f in found} == {"CC001"}
