"""The port's dry run (``launch/dryrun.py``, ``hlo_breakdown.py``,
``perf_report.py``, ``roofline.analyze_cell`` / ``render_table``): a train
step traced on fake tensors over a ``fake`` process group.  Every dry run
runs in one subprocess (a fake default group must not share a process with
the other tests' groups), which writes its records as JSON; the tests read
them.

* (a) Each of the ten ``train_4k`` cells on the 256-card (32, 8) mesh:
  parameter, gradient and optimizer bytes a card equal a reckoning from
  ``param_specs`` written here (each leaf's elements over the product of
  its spec's axis sizes), exactly.
* (b) At a small depth (the smoke qwen3-4b and qwen3-moe-30b-a3b, 3
  blocks, a (2, 2) mesh, B = 4, S = 256), the 1- and 2-block probe
  extrapolated equals a trace of all 3 blocks exactly for the FLOPs, the
  op bytes and the collective bytes; the activations the forward holds
  extrapolate within 1e-3 relative of the 3-block trace's; the memory
  record's peak is the 3-block trace's peak above the state, which is
  not extrapolated (the peak moves with the depth).
* (c) The qwen3-moe-30b-a3b cell's all-to-all bytes against the C_loc
  reckoning: T_loc = 256 / 32 rows x 4096 / 8 tokens, C = ceil(T_loc K /
  E) x 1.25, a (E, C, D) bf16 buffer six times a layer (dispatch and
  return in the forward, the block's recompute and the backward).
* (d) The three serving cells of gemma2-27b (prefill_32k, decode_32k,
  long_500k: the batch over "data", the KV heads over "model", and the
  cache's slots over "data" when the batch cannot shard) are ``ok`` with
  costs; a decode cell's cache bytes a card equal a reckoning from the
  decode-state specs (each leaf's elements over the product of its spec's
  axis sizes), exactly, and a prefill holds no cache.
* (e) ``render_table``, ``perf_report`` and ``hlo_breakdown`` render the
  records.
"""
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.configs import archs as tarchs

TRAIN = sorted(a for a, s in tarchs.cells() if s == "train_4k")
SMALL = ("qwen3-4b", "qwen3-moe-30b-a3b")
PEAK_REL = 1e-3

_DRIVER = r"""
import dataclasses, json, sys
from repro_torch.configs.archs import ARCHS, smoke
from repro_torch.launch import dryrun, specs
from repro_torch.launch import hlo_breakdown
from torch.distributed.device_mesh import init_device_mesh
out_dir, train = sys.argv[1], sys.argv[2].split(",")
recs = {"nop/" + a: dryrun.run_cell(a, "train_4k", 256, probe=False)
        for a in train}
for shape in ("prefill_32k", "decode_32k", "long_500k"):
    recs["serve/" + shape] = dryrun.run_cell("gemma2-27b", shape, 256)
recs["cell/moe"] = dryrun.run_cell("qwen3-moe-30b-a3b", "train_4k", 256)
for a in %r:
    cfg = dataclasses.replace(smoke(a), num_layers=3)
    with dryrun.fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cell = specs.train_cell(cfg, 4, 256, mesh)
        recs["probe/" + a] = dict(costs=dryrun.probe_costs(cfg, 4, 256, mesh),
                                  memory=dryrun.memory(cell, mesh))
        for nb in (1, 2, 3):
            t = dryrun.trace_step(specs.train_cell(
                dryrun.at_depth(cfg, nb), 4, 256, mesh), mesh)
            t.pop("collectives")
            recs["trace" + str(nb) + "/" + a] = t
rows = hlo_breakdown.breakdown("qwen3-moe-30b-a3b", "train_4k", 2, 256)
recs["breakdown"] = [list(r) for r in rows]
with open(out_dir + "/records.json", "w") as f:
    json.dump(recs, f)
with open(out_dir + "/cells.json", "w") as f:
    json.dump([recs["cell/moe"], recs["serve/decode_32k"],
               dict(arch="mamba2-130m", shape="long_500k", status="skip")], f)
print("OK")
""" % (SMALL,)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [env["PYTHONPATH"]] * bool(env.get("PYTHONPATH")))
    res = subprocess.run([sys.executable, "-c", _DRIVER, str(root),
                          ",".join(TRAIN)], capture_output=True, text=True,
                         env=env, timeout=600)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-3000:]
    with open(root / "records.json") as f:
        return json.load(f), root, res.stdout


class StandIn:
    """A ("data", "model") mesh stand-in for ``make_policy``: sizes only."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape):
        self.shape = shape

    def size(self, dim: int) -> int:
        return self.shape[dim]


@pytest.mark.parametrize("arch", TRAIN)
def test_state_bytes_a_card_equal_the_spec_reckoning(records, arch):
    """(a)"""
    from repro_torch.launch import specs
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf

    recs, _, _ = records
    rec = recs[f"nop/{arch}"]
    assert rec["status"] == "ok" and rec["mesh"] == "32x8"
    size = {"data": 32, "model": 8}
    cfg = tarchs.ARCHS[arch]
    policy = specs.make_policy(StandIn((32, 8)), 256)
    spec = convert.flatten(tf.param_specs(cfg, policy))
    micro = math.gcd(specs.TRAIN_MICRO.get(arch, 1), 256 // 32)
    params = grads = opt = 0
    for k, t in convert.flatten(specs.meta_params(cfg)).items():
        ranks = math.prod(size[a] for e in spec[k] if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        n = t.numel() // ranks
        params += n * t.element_size()
        grads += n * (4 if micro > 1 else t.element_size())
        opt += 3 * 4 * n
    mem = rec["memory"]
    assert (mem["param_bytes"], mem["grad_bytes"], mem["opt_bytes"]) == (
        params, grads, opt + 4)
    assert rec["micro"] == micro


def _probe_vs_full(recs, arch):
    return recs[f"probe/{arch}"], recs[f"trace3/{arch}"]


@pytest.mark.parametrize("arch", SMALL)
@pytest.mark.parametrize("term", ["flops", "op_bytes", "coll_bytes"])
def test_probe_extrapolation_equals_the_full_trace(records, arch, term):
    """(b): the token-linear terms, exactly."""
    probe, full = _probe_vs_full(records[0], arch)
    want = full["coll"] if term == "coll_bytes" else full[term]
    assert probe["costs"][term] == want


@pytest.mark.parametrize("arch", SMALL)
@pytest.mark.parametrize("term", ["peak", "activations"])
def test_probe_memory_is_within_bound_of_the_full_trace(records, arch, term):
    """(b): the activations extrapolate from 1 and 2 blocks within 1e-3;
    the record's peak is the full trace's, above the exact state."""
    recs, _, _ = records
    mem = recs[f"probe/{arch}"]["memory"]
    one, two, full = (recs[f"trace{n}/{arch}"] for n in (1, 2, 3))
    if term == "activations":
        got = one["saved"] + 2 * (two["saved"] - one["saved"])
        assert full["saved"] == mem["activation_bytes"]
        assert abs(got - full["saved"]) <= PEAK_REL * full["saved"], (
            got, full["saved"])
    else:
        assert mem["peak_device_bytes"] == (
            mem["param_bytes"] + mem["opt_bytes"] + mem["batch_bytes"]
            + full["peak"])
        assert full["peak"] >= mem["grad_bytes"] + mem["temp_bytes"] > 0


def test_moe_all_to_all_bytes_equal_the_capacity_reckoning(records):
    """(c)"""
    cfg = tarchs.ARCHS["qwen3-moe-30b-a3b"]
    t_loc = 256 // 32 * 4096 // 8
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = int(-(-t_loc * K // E) * cfg.capacity_factor)
    assert C == 320
    want = 6 * cfg.num_layers * E * C * cfg.d_model * 2
    rec = records[0]["cell/moe"]
    assert rec["costs"]["coll_bytes"]["all-to-all"] == {"model": want}
    assert rec["status"] == "ok" and rec["fits_hbm"]
    mem = rec["memory"]
    # one micro-batch: every gradient is alive when the optimizer starts
    assert mem["peak_device_bytes"] >= (
        mem["param_bytes"] + mem["opt_bytes"] + mem["batch_bytes"]
        + mem["grad_bytes"] + mem["temp_bytes"])


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_serving_cells_are_skips_naming_13f(records, shape):
    """(d): the serving cell is ``ok`` (no longer a skip), with its costs,
    and its cache bytes a card equal the reckoning from the decode-state
    specs."""
    from repro_torch.launch import specs
    from repro_torch.models import convert, zoo

    rec = records[0][f"serve/{shape}"]
    sh = tarchs.SHAPES[shape]
    assert rec["status"] == "ok" and rec["kind"] == sh["kind"]
    assert rec["mesh"] == "32x8" and isinstance(rec["fits_hbm"], bool)
    costs = rec["costs"]
    assert costs["flops"] > 0 and costs["op_bytes"] > 0
    assert costs["coll_bytes"] and all(
        b > 0 for by_axis in costs["coll_bytes"].values()
        for b in by_axis.values())
    mem = rec["memory"]
    assert mem["peak_device_bytes"] == (mem["param_bytes"]
                                        + mem["cache_bytes"]
                                        + mem["batch_bytes"]
                                        + mem["temp_bytes"])
    if sh["kind"] == "prefill":
        assert mem["cache_bytes"] == 0
        return
    cfg = tarchs.ARCHS["gemma2-27b"]
    B, S = sh["global_batch"], sh["seq_len"]
    mesh = StandIn((32, 8))
    policy = specs.make_policy(mesh, B, "decode")
    d_specs = zoo.decode_state_specs(cfg, policy)
    if not policy.dp:
        d_specs = specs._context_parallel_specs(cfg, mesh, d_specs)
    spec = convert.flatten(d_specs)
    size = {"data": 32, "model": 8}
    want = 0
    for k, t in convert.flatten(specs.meta_decode_state(cfg, B, S)).items():
        ranks = math.prod(size[a] for e in spec[k] if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        want += t.numel() // ranks * t.element_size()
    assert mem["cache_bytes"] == want


def test_render_table_and_perf_report(records):
    """(e): the table has the reference's columns and a row for the probed
    cell; perf_report's before/after of the same file is that cell, every
    column unchanged."""
    from repro_torch.launch import perf_report, roofline

    _, root, _ = records
    path = str(root / "cells.json")
    table = roofline.render_table(path).splitlines()
    assert table[0].startswith("| arch | shape | compute s | memory s | "
                               "collective s | bound | MODEL/HLO |")
    assert len(table) == 4 and table[2].startswith(
        "| qwen3-moe-30b-a3b | train_4k |")
    assert table[3].startswith("| gemma2-27b | decode_32k |")
    r = roofline.analyze_cell(json.load(open(path))[0])
    assert r["bound"] in ("compute", "memory", "collective")
    assert r["step_time"] == max(r["t_compute"], r["t_memory"],
                                 r["t_collective"]) > 0
    rep = perf_report.report(path, path).splitlines()
    assert len(rep) == 4 and "| qwen3-moe-30b-a3b | train_4k |" in rep[3]
    assert "| gemma2-27b | decode_32k |" in rep[2]
    assert f"{r['bound']}→{r['bound']}" in rep[3]


def test_hlo_breakdown_lists_the_expert_all_to_alls(records):
    """(e): the largest collectives of the MoE probe are its all-to-alls
    over "model", each sourced from models/moe.py or a backward."""
    recs, _, stdout = records
    rows = recs["breakdown"]
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    a2a = [r for r in rows if r[1] == "all-to-all"]
    assert len(a2a) == 2 * 6 and all(r[2] == "model" for r in a2a)
    assert all("moe.py" in r[4] or "(backward)" in r[4] for r in a2a)
    assert "all-to-all" in stdout and "top 25:" in stdout
