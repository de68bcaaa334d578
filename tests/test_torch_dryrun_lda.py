"""The dry run's LDA cells (``launch/dryrun.py``: ``run_lda_cell``,
``lda_modes``, ``trace_lda_step``) and its record of sequence parallelism
in the LM cells.  Every dry run runs in one subprocess (a fake default
group must not share a process with the other tests' groups), which
writes its records as JSON; the tests read them.

* (a) A small Zipf corpus (256 documents, V = 3,000, K = 64) on an 8-rank
  fake (2, 4) ("data", "model") mesh, the four modes 1d, 2d, 1d_c16 and
  2d_c16, with the int16 flux bound cut to 200 occurrences so that the
  byte wire has heavy rows: each mode's collective bytes by axis and op
  equal, exactly, a reckoning from the plan's shapes (the (V_local, K)
  int32 delta over the doc axes, or the byte wire's ``all_to_all_single``
  and ``all_gather`` of 2 G ceil(V_local K / G) bytes and the heavy rows'
  (H, K) int32; in 2d the (D_local, K) theta partials and the (K,)
  phi_sum over "model"; the three float32 stats over every axis); K1 and
  K2 each appear once in the trace, as their custom ops, K4 never, and
  the plain versions are never called; the FLOPs are K1's and K2's shape
  reckonings; the held bytes are the state's, the shard's, K2's table's
  and the uniforms' shapes.
* (b) ``--lda`` at 256 cards (the reference's stand-in corpora) prints
  both datasets with the four modes ``ok``.
* (c) qwen3-4b ``train_4k`` on 256 cards, traced with and without the
  policy's ``sp``: the forward's held bytes fall by the saved residual's
  (tp - 1) / tp of its 36 block inputs, less the one tp-th of the
  stack's output that the head's gathered input replaces; with sp the
  tensor-parallel collectives over "model" are all-gathers and
  reduce-scatters of (B, S, D)-sized activations, and no all-reduce over
  "model" moves one.
* (d) The records say whether sp was on: whisper-large-v3's 1,500
  encoder frames do not divide over tp = 8 (``sp_encoder`` false), its
  4,096 tokens do; a decode cell never is.

The real step on gloo ranks stays bit-equal to the reference's
(``tests/test_torch_distributed.py``).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

MODES = ("1d", "2d", "1d_c16", "2d_c16")
K, V, DOCS, FLUX = 64, 3000, 256, 200
MESH = {"data": 2, "model": 4}

_DRIVER = r"""
import dataclasses, json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.data import synthetic
from repro_torch.distributed import partition
from repro_torch.kernels.lda_sample import ref as k1_ref
from repro_torch.kernels.phi_update import ref as k24_ref
from repro_torch.launch import dryrun, mesh as mesh_lib, specs
out_dir = sys.argv[1]
recs = {}
plain = {"k1": 0, "k2": 0, "k4": 0}
def counting(name, fn):
    def wrapped(*a, **k):
        plain[name] += 1
        return fn(*a, **k)
    return wrapped
k1_ref.lda_sample_tiles_ref = counting("k1", k1_ref.lda_sample_tiles_ref)
k24_ref.phi_delta_tiles_ref = counting("k2", k24_ref.phi_delta_tiles_ref)
k24_ref.phi_update_tiles_ref = counting("k4", k24_ref.phi_update_tiles_ref)
partition.INT16_FLUX_BOUND = %d
corpus = synthetic.zipf_corpus(num_docs=%d, num_words=%d, avg_doc_len=50,
                               seed=0)
with dryrun.fake_group(8):
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    recs["small"] = dryrun.lda_modes(mesh, corpus, %d)
recs["plain"] = plain
partition.INT16_FLUX_BOUND = 1 << 15
recs["cell"] = [dryrun.run_lda_cell(256, dataset=ds)
                for ds in dryrun.LDA_DATASETS]
with dryrun.fake_group(256):
    mesh = mesh_lib.make_production_mesh(256)
    cell = specs.build_cell("qwen3-4b", "train_4k", mesh)
    for sp in (True, False):
        c = cell._replace(policy=dataclasses.replace(cell.policy, sp=sp))
        t = dryrun.trace_step(c, mesh)
        model = {}
        for x in t["collectives"]:
            if x["axis"] == "model":
                key = x["op"] + ":" + "x".join(map(str, x["shape"]))
                model[key] = model.get(key, 0) + 1
        recs["lm/sp" if sp else "lm/nosp"] = dict(saved=t["saved"],
                                                  model=model)
recs["whisper"] = dryrun.run_cell("whisper-large-v3", "train_4k", 256,
                                  probe=False)
recs["decode"] = dryrun.run_cell("qwen3-4b", "decode_32k", 256,
                                 probe=False)
with open(out_dir + "/records.json", "w") as f:
    json.dump(recs, f)
print("OK")
""" % (FLUX, DOCS, V, K)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun_lda")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [env["PYTHONPATH"]] * bool(env.get("PYTHONPATH")))
    res = subprocess.run([sys.executable, "-c", _DRIVER, str(root)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-3000:]
    with open(root / "records.json") as f:
        return json.load(f)


def _doc_axes(mode: str) -> tuple[str, ...]:
    return ("data", "model") if mode.startswith("1d") else ("data",)


def reckoned_collectives(mode: str, rec: dict) -> dict:
    """{op: {axes: bytes}} of one step from the plan's shapes."""
    doc = "+".join(_doc_axes(mode))
    G = math.prod(MESH[a] for a in _doc_axes(mode))
    Vl, Dl, H = rec["words_local"], rec["docs_local"], rec["heavy_rows"]
    out: dict = {}

    def add(op, axes, n):
        by = out.setdefault(op, {})
        by[axes] = by.get(axes, 0) + n

    if mode.endswith("_c16"):
        wire = 2 * G * -(-Vl * K // G)
        add("all-to-all", doc, wire)
        add("all-gather", doc, wire)
        if H:
            add("all-reduce", doc, H * K * 4)
    else:
        add("all-reduce", doc, Vl * K * 4)
    if mode.startswith("2d"):
        add("all-reduce", "model", Dl * K * 4 + K * 4)   # theta, phi_sum
    add("all-reduce", "data+model", 3 * 4)              # the stats
    return out


@pytest.mark.parametrize("mode", MODES)
def test_lda_collective_bytes_equal_the_plan_reckoning(records, mode):
    """(a)"""
    rec = records["small"][mode]
    assert rec["coll_bytes"] == reckoned_collectives(mode, rec)
    if mode.endswith("_c16"):
        assert rec["heavy_rows"] > 0     # the flux bound was cut to make some


@pytest.mark.parametrize("mode", MODES)
def test_k1_and_k2_are_traced_once_as_custom_ops(records, mode):
    """(a): the step reaches the kernels' ops (the kernel route of
    ``ops.py`` on fake cuda tensors), not their plain versions."""
    rec = records["small"][mode]
    assert rec["launches"] == {"lda_sample_tiles": 1, "phi_delta_tiles": 1,
                               "phi_update_tiles": 0}
    assert records["plain"] == {"k1": 0, "k2": 0, "k4": 0}


@pytest.mark.parametrize("mode", MODES)
def test_lda_flops_are_the_kernels_reckonings(records, mode):
    """(a): the step does no matmul; its FLOPs are K1's and K2's shape
    reckonings."""
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.phi_update import kernel as k24

    rec = records["small"][mode]
    n, t = rec["tiles"], rec["tile_tokens"]
    assert rec["flops"] == (k1.ops_reckoning(n, t, K)
                            + k24.ops_reckoning(n, t, True))


@pytest.mark.parametrize("mode", MODES)
def test_lda_held_bytes_are_the_shapes(records, mode):
    """(a): phi (V_local, K) int32, phi_sum, z (n, t) int16, the uniforms
    (n, t, 2) float32, the heavy rows int64; the peak is what is held plus
    the step's transients."""
    rec = records["small"][mode]
    sb = rec["state_bytes"]
    n, t = rec["tiles"], rec["tile_tokens"]
    assert (sb["phi"], sb["phi_sum"], sb["z"], sb["uniforms"],
            sb["heavy_rows"]) == (rec["words_local"] * K * 4, K * 4,
                                  n * t * 2, n * t * 2 * 4,
                                  rec["heavy_rows"] * 8)
    assert sb["k2_tables"] > 0 and sb["tiles"] > 0
    held = sum(v for k, v in sb.items() if k != "ell")
    assert rec["peak_device_bytes"] == held + rec["temp_bytes"]
    assert rec["temp_bytes"] >= sb["ell"] > 0


@pytest.mark.parametrize("dataset", ["nytimes", "pubmed"])
def test_lda_cells_at_256_cards(records, dataset):
    """(b): the reference's stand-in corpus, K = 1024, four modes ``ok``;
    phi full size in 1d, a word shard of it in 2d."""
    rec = next(r for r in records["cell"]
               if r["arch"] == f"lda-{dataset}-k1024")
    assert rec["status"] == "ok" and rec["mesh"] == "32x8"
    assert rec["docs"] == 4096 and sorted(rec["modes"]) == sorted(MODES)
    full = {"nytimes": 101_636, "pubmed": 141_043}[dataset]
    for mode, m in rec["modes"].items():
        assert m["peak_device_bytes"] > m["state_bytes"]["phi"] > 0
        assert m["launches"]["lda_sample_tiles"] == 1
        assert (m["words_local"] == full) == mode.startswith("1d")
    # the byte wire halves the delta's bytes on the doc axes
    one, c16 = rec["modes"]["1d"], rec["modes"]["1d_c16"]
    assert c16["coll_bytes"]["all-to-all"]["data+model"] * 2 == pytest.approx(
        one["coll_bytes"]["all-reduce"]["data+model"], rel=1e-3)


def test_sequence_parallel_cuts_the_saved_residual(records):
    """(c): qwen3-4b, B = 256 over data = 32 (8 rows a rank), S = 4096, D
    = 2560 bf16, tp = 8."""
    from repro_torch.configs import archs

    cfg = archs.ARCHS["qwen3-4b"]
    tp, rows, S = 8, 256 // 32, 4096
    F = rows * S * cfg.d_model * 2               # one (B, S, D) bf16
    want = cfg.num_blocks * F * (tp - 1) // tp - F // tp
    sp, nosp = records["lm/sp"], records["lm/nosp"]
    assert nosp["saved"] - sp["saved"] == want


def test_sequence_parallel_collectives_over_model(records):
    """(c): no all-reduce over "model" moves a (B, S, D) activation with
    sp; all-gathers (S, B, D) and reduce-scatters (S / tp, B, D) do
    (more gathers than scatters: a block's recompute gathers its MLP's
    input again but stops before the MLP's reduce-scatter, whose output
    nothing saved); without sp the all-reduces do."""
    from repro_torch.configs import archs

    D = archs.ARCHS["qwen3-4b"].d_model
    act = 8 * 4096 * D

    def numel(key):
        dims = key.split(":")[1]
        return math.prod(int(d) for d in dims.split("x")) if dims else 1

    def big(model, op):
        return sum(n for k, n in model.items() if k.startswith(op + ":")
                   and numel(k) * 8 >= act)

    sp, nosp = records["lm/sp"]["model"], records["lm/nosp"]["model"]
    assert big(sp, "all-reduce") == 0
    gathers = sp.get(f"all-gather:4096x8x{D}", 0)
    scatters = sp.get(f"reduce-scatter:512x8x{D}", 0)
    assert gathers >= scatters > 0
    assert big(nosp, "all-reduce") > 0
    assert nosp.get(f"all-gather:4096x8x{D}", 0) == 0


def test_records_say_whether_sp_was_on(records):
    """(d)"""
    w = records["whisper"]
    assert w["status"] == "ok" and w["sp"] is True
    assert w["sp_encoder"] is False              # 1,500 % 8 != 0
    d = records["decode"]
    assert d["status"] == "ok" and d["sp"] is False
    assert np.isfinite(w["memory"]["peak_device_bytes"])
