"""The port's V-sharded serving (ShardedModelSnapshot, fold_in_sharded under
psum and all2all, the engine, the sharded publish) on the CPU, held against
the JAX package and against the port's own dense path.

One process drives every shard: here ``devices=("cpu",) * S``, so S shards
run in-process.  The reference's sharded fold-in needs a mesh, so one
subprocess on 4 forced host devices runs it (``impl="ref"``) on inputs this
module writes, and saves the randoms it drew, its outputs and a
``.sharded`` directory it wrote.  Everything else of the reference (plans,
routing, layouts, the reader) is called in-process.

Bounds:

* the host-side layout and routing (contiguous plan, dense split, doc
  slices, routing plans and their byte counts, the bucketing) equal the
  reference's exactly, with padding, B in {1, 6, 32}, S in {1, 2, 3, 4};
* the port's sharded fold-in equals its dense ``fold_in`` bit for bit on
  the same randoms (theta, top_topics, top_weights, sparse_frac,
  mean_s_over_sq), psum and all2all, S in {1, 2, 3, 4};
* against the reference's 4-device fold-in: theta within atol 1e-6,
  top_topics exact, sparse_frac / mean_s_over_sq within rtol 1e-5 (the
  tolerances of ``test_torch_serve.py``);
* ``.sharded`` directories cross between the packages with phi, phi_sum,
  alpha / beta, meta, vocab and the comm tag intact.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import run_subprocess
from repro.distributed import partition as jpart
from repro.serve import snapshot as jsnap
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed import partition as tpart
from repro_torch.kernels.fold_in import ops
from repro_torch.serve import (EngineConfig, FaultPlan, HotSwapModel,
                               InferConfig, LDAServeEngine,
                               ShardedModelSnapshot, SnapshotIntegrityError,
                               assemble_sharded_snapshot, heldout_perplexity,
                               load_any_snapshot, load_sharded_snapshot,
                               save_sharded_snapshot, save_snapshot,
                               serving_devices, shard_snapshot,
                               snapshot_from_numpy)
from repro_torch.serve import snapshot as tsnap
from repro_torch.serve.engine import _bucket
from repro_torch.serve.infer import (_host_batch_from_buffer, fold_in_config,
                                     fold_in_sharded, pack_docs,
                                     pack_request_buffer, routing_plan)

V, K, L = 97, 16, 48
BURN_IN, SAMPLES = 3, 2
REF_BATCHES = (6, 32)
OUTPUTS = ("theta", "top_topics", "top_weights", "sparse_frac",
           "mean_s_over_sq")

REFERENCE = """
import numpy as np, jax
from repro.serve import ModelSnapshot, save_sharded_snapshot, shard_snapshot
from repro.serve.infer import InferConfig, fold_in_sharded
from repro.kernels.fold_in.ops import draw_fold_in_randoms

assert jax.local_device_count() == 4
inp = np.load({inp!r})
phi = inp["phi"]
snap = ModelSnapshot(phi_vk=jax.numpy.asarray(phi),
                     phi_sum=jax.numpy.asarray(phi.sum(0)), alpha=0.3,
                     beta=0.05, num_words_total={V} + 5,
                     meta={{"iteration": 9, "source": "jax"}},
                     vocab=tuple(f"w{{v}}" for v in range({V})))
out = {{}}
for comm in ("psum", "all2all"):
    sh = shard_snapshot(snap, 4, comm=comm)
    for B in {batches!r}:
        tokens, mask = inp[f"tokens{{B}}"], inp[f"mask{{B}}"]
        key = jax.random.key(11 + B)
        z0, uni = draw_fold_in_randoms(key, B, {L}, {K}, {n})
        out[f"z0/{{B}}"], out[f"uni/{{B}}"] = np.asarray(z0), np.asarray(uni)
        res = fold_in_sharded(sh, tokens, mask, key, InferConfig(
            burn_in={burn_in}, samples={samples}, impl="ref", comm=comm))
        for f in {outputs!r}:
            out[f"{{comm}}/{{B}}/{{f}}"] = np.asarray(getattr(res, f))
save_sharded_snapshot({sharded!r}, shard_snapshot(snap, 4, comm="all2all"))
np.savez({out!r}, **out)
print("OK")
"""


def random_phi(seed=0, V=V, K=K):
    rng = np.random.default_rng(seed)
    return ((rng.random((V, K)) < 0.2)
            * rng.integers(1, 300, (V, K))).astype(np.int32)


def batch(B, seed=1, V=V, L=L):
    """B docs of random lengths in [1, L) and one of 0 tokens when B > 1
    (a doc of padding only), packed to L."""
    rng = np.random.default_rng(seed + B)
    lens = rng.integers(1, L, B)
    if B > 1:
        lens[B // 2] = 0
    return pack_docs([rng.integers(0, V, n).astype(np.int32) for n in lens],
                     L)


def port_snapshot(phi=None, **kw):
    phi = random_phi() if phi is None else phi
    return snapshot_from_numpy(phi, phi.sum(0), kw.pop("alpha", 0.3),
                               kw.pop("beta", 0.05),
                               kw.pop("num_words_total", phi.shape[0]),
                               device="cpu", **kw)


def cpus(S):
    return ("cpu",) * S


def cfg(**kw):
    return InferConfig(burn_in=BURN_IN, samples=SAMPLES, **kw)


def assert_same(a, b):
    for f in OUTPUTS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's 4-device sharded fold-in on this module's inputs."""
    root = tmp_path_factory.mktemp("sharded")
    inp, out = str(root / "in.npz"), str(root / "out.npz")
    arrays = {"phi": random_phi()}
    for B in REF_BATCHES:
        arrays[f"tokens{B}"], arrays[f"mask{B}"] = batch(B)
    np.savez(inp, **arrays)
    code = REFERENCE.format(inp=inp, out=out, sharded=str(root / "j.sharded"),
                            V=V, K=K, L=L, n=BURN_IN + SAMPLES,
                            burn_in=BURN_IN, samples=SAMPLES,
                            batches=REF_BATCHES, outputs=OUTPUTS)
    assert "OK" in run_subprocess(code, devices=4)
    return dict(np.load(out)), arrays, str(root / "j.sharded")


# ---------------------------------------------------------------------------
# host-side layout and routing against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_words,S", [(97, 1), (97, 3), (100, 4), (5, 4)])
def test_contiguous_plan_and_split_match_jax(num_words, S):
    got = tsnap.plan_contiguous_shards(num_words, S)
    want = jsnap.plan_contiguous_shards(num_words, S)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    phi = random_phi(V=num_words)
    for g, w in zip(tsnap.split_dense_phi(torch.from_numpy(phi), S),
                    jsnap.split_dense_phi(phi, S)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("B", [1, 6, 32])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_doc_slices_match_jax(B, S):
    for g, w in zip(tpart.doc_slice_bounds(B, S),
                    jpart.doc_slice_bounds(B, S)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tpart.doc_slice_owner(B, S),
                    jpart.doc_slice_owner(B, S)):
        np.testing.assert_array_equal(g, w)


def _lpt_maps(S):
    """A non-contiguous word->shard map, as a 2d trainer publishes."""
    rng = np.random.default_rng(S)
    shard_of = rng.integers(0, S, V).astype(np.int32)
    local_id = np.zeros(V, np.int32)
    for s in range(S):
        local_id[shard_of == s] = np.arange(int((shard_of == s).sum()))
    return shard_of, local_id


@pytest.mark.parametrize("B", [1, 6, 32])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_routing_plan_and_buckets_match_jax(B, S):
    """The plan's capacity and byte counts, and each doc slice's buckets
    (payload and source slots, padding routed nowhere), equal the
    reference's."""
    tokens, mask = batch(B)
    shard_of, local_id = _lpt_maps(S)
    got = tpart.plan_token_routing(shard_of, tokens, mask, S, K)
    want = jpart.plan_token_routing(shard_of, tokens, mask, S, K)
    assert got == tpart.TokenRoutingPlan(**vars(want))
    starts, Bs = tpart.doc_slice_bounds(B, S)
    for s in range(S):
        sl = slice(int(starts[s]), int(starts[s]) + Bs)
        flat, m = tokens[sl].reshape(-1), mask[sl].reshape(-1)
        owner = np.where(m, shard_of[flat], S).astype(np.int32)
        send, src = tpart.route_buckets(torch.from_numpy(owner),
                                        torch.from_numpy(local_id[flat]), S,
                                        got.capacity)
        jsend, jsrc = jpart.route_buckets(jnp.asarray(owner),
                                          jnp.asarray(local_id[flat]), S,
                                          got.capacity)
        np.testing.assert_array_equal(send.numpy(), np.asarray(jsend))
        np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
        assert send.dtype == src.dtype == torch.int32


def test_routing_plan_counts_duplicated_docs_and_psum_bytes():
    """B = 6 over S = 4: slices [0,2) [2,4) [4,6) [4,6), so the last two
    docs are routed twice; psum bytes are the ring all-reduce's."""
    tokens, mask = batch(6)
    shard_of, _ = _lpt_maps(4)
    plan = tpart.plan_token_routing(shard_of, tokens, mask, 4, K)
    assert plan.routed_tokens == int(mask.sum()) + int(mask[4:].sum())
    assert plan.psum_bytes == 4 * 2 * 3 * 6 * L * K
    assert plan.capacity & (plan.capacity - 1) == 0
    assert plan.capacity <= plan.docs_per_shard * L


def test_route_buckets_drops_slots_past_capacity():
    """A capacity below the bucket load drops the overflow (the plan never
    picks one); padding slots route nowhere."""
    owner = torch.tensor([1, 0, 1, 2, 1, 0], dtype=torch.int32)   # 2 = pad
    payload = torch.tensor([10, 11, 12, 13, 14, 15], dtype=torch.int32)
    send, src = tpart.route_buckets(owner, payload, 2, 2)
    assert send.tolist() == [[11, 15], [10, 12]]
    assert src.tolist() == [[1, 5], [0, 2]]


# ---------------------------------------------------------------------------
# the sharded fold-in
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("comm", ["psum", "all2all"])
def test_sharded_fold_in_bit_identical_to_dense(S, comm):
    """psum and all2all on S CPU shards give the dense fold_in's draws bit
    for bit on the same randoms, at B = 1, 6 and 32 (overlapping slices,
    an all-padding doc), contiguous and LPT maps."""
    dense = port_snapshot()
    contiguous = shard_snapshot(dense, S, devices=cpus(S), comm=comm)
    shard_of, local_id = _lpt_maps(S)
    blocks = [np.zeros((int((shard_of == s).sum()) + 1, K), np.int32)
              for s in range(S)]
    for s, blk in enumerate(blocks):
        words = np.flatnonzero(shard_of == s)
        blk[local_id[words]] = random_phi()[words]
    lpt = tsnap._sharded_from_blocks(
        [np.pad(b, ((0, max(map(len, blocks)) - len(b)), (0, 0)))
         for b in blocks], dense.phi_sum, shard_of, local_id, 0.3, 0.05, V,
        {}, None, cpus(S), comm=comm)
    for B in (1, 6, 32):
        tokens, mask = batch(B)
        gen = torch.Generator().manual_seed(B)
        randoms = ops.draw_fold_in_randoms(gen, B, L, K, BURN_IN + SAMPLES,
                                           "cpu")
        want = fold_in_config(dense, tokens, mask, randoms, cfg())
        for sh in (contiguous, lpt):
            assert_same(fold_in_config(sh, tokens, mask, randoms, cfg()),
                        want)


@pytest.mark.parametrize("comm", ["psum", "all2all"])
@pytest.mark.parametrize("B", REF_BATCHES)
def test_sharded_fold_in_matches_jax_4_devices(ref, comm, B):
    out, arrays, _ = ref
    snap = shard_snapshot(port_snapshot(arrays["phi"],
                                        num_words_total=V + 5), 4,
                          devices=cpus(4), comm=comm)
    got = fold_in_sharded(snap, arrays[f"tokens{B}"], arrays[f"mask{B}"],
                          (out[f"z0/{B}"], out[f"uni/{B}"]), cfg(impl="ref"))
    w = {f: out[f"{comm}/{B}/{f}"] for f in OUTPUTS}
    np.testing.assert_allclose(got.theta.numpy(), w["theta"], atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got.top_topics.numpy(), w["top_topics"])
    np.testing.assert_allclose(got.top_weights.numpy(), w["top_weights"],
                               atol=1e-6, rtol=0)
    for f in ("sparse_frac", "mean_s_over_sq"):
        np.testing.assert_allclose(float(getattr(got, f)), float(w[f]),
                                   rtol=1e-5)


def test_sharded_fold_in_checks_word_ids():
    snap = shard_snapshot(port_snapshot(), 2, devices=cpus(2))
    tokens, mask = batch(6)
    tokens[0, 0] = V
    with pytest.raises(ValueError, match="word ids"):
        fold_in_sharded(snap, tokens, mask, torch.Generator(), cfg())
    with pytest.raises(ValueError, match="comm"):
        fold_in_sharded(snap, *batch(6), torch.Generator(), cfg(comm="ring"))


# ---------------------------------------------------------------------------
# the on-disk layout, across the packages
# ---------------------------------------------------------------------------
def _vocab_snapshot():
    return port_snapshot(meta={"iteration": 7, "source": "port"},
                         vocab=tuple(f"w{v}" for v in range(V)),
                         num_words_total=V + 3)


def test_port_sharded_dir_assembles_in_jax(tmp_path):
    snap = _vocab_snapshot()
    sh = shard_snapshot(snap, 3, devices=cpus(3), comm="all2all")
    p = save_sharded_snapshot(str(tmp_path / "m.sharded"), sh)
    back = jsnap.assemble_sharded_snapshot(p)
    np.testing.assert_array_equal(np.asarray(back.phi_vk), snap.phi_vk.numpy())
    np.testing.assert_array_equal(np.asarray(back.phi_sum),
                                  snap.phi_sum.numpy())
    assert (back.alpha, back.beta, back.num_words_total) == (0.3, 0.05, V + 3)
    assert back.meta == {"iteration": 7, "source": "port"}
    assert back.vocab == snap.vocab
    with open(os.path.join(p, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["comm"] == "all2all" and manifest["num_shards"] == 3
    assert sorted(os.listdir(p)) == ["manifest.json", "maps.npz",
                                     "shard_0000.npz", "shard_0001.npz",
                                     "shard_0002.npz"]
    # a dense snapshot split at save time keeps the default tag
    p2 = save_sharded_snapshot(str(tmp_path / "d.sharded"), snap, 2)
    assert load_sharded_snapshot(p2, devices=cpus(2)).comm == "psum"


def test_jax_sharded_dir_loads_in_port(ref):
    _, arrays, path = ref
    sh = load_sharded_snapshot(path, devices=cpus(4))
    assert isinstance(sh, ShardedModelSnapshot) and sh.num_shards == 4
    assert sh.comm == "all2all"
    dense = sh.assemble()
    np.testing.assert_array_equal(dense.phi_vk.numpy(), arrays["phi"])
    np.testing.assert_array_equal(sh.phi_sum.numpy(), arrays["phi"].sum(0))
    assert (sh.alpha, sh.beta, sh.num_words_total) == (0.3, 0.05, V + 5)
    assert sh.meta == {"iteration": 9, "source": "jax"}
    assert sh.vocab == tuple(f"w{v}" for v in range(V))
    assert sh.num_words == V and dense.device == torch.device("cpu")
    flat = assemble_sharded_snapshot(path, device="cpu")
    assert torch.equal(flat.phi_vk, dense.phi_vk)
    assert load_sharded_snapshot(path, devices=cpus(4),
                                 comm="psum").comm == "psum"


def test_corrupt_shard_raises(tmp_path):
    p = save_sharded_snapshot(str(tmp_path / "m.sharded"), port_snapshot(), 2)
    fp = os.path.join(p, "shard_0001.npz")
    raw = bytearray(open(fp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(fp, "wb").write(bytes(raw))
    with pytest.raises(SnapshotIntegrityError, match="shard_0001"):
        load_sharded_snapshot(p, devices=cpus(2))
    with pytest.raises(jsnap.SnapshotIntegrityError):
        jsnap.assemble_sharded_snapshot(p)       # the reference agrees


def test_shard_load_error_fails_or_delays(tmp_path):
    p = save_sharded_snapshot(str(tmp_path / "m.sharded"), port_snapshot(), 2)
    with pytest.raises(SnapshotIntegrityError, match="injected"):
        load_sharded_snapshot(p, devices=cpus(2),
                              fault_plan=FaultPlan.parse("shard_load_error@1"))
    slow = FaultPlan.parse("shard_load_error@0:0.05")
    sh = load_any_snapshot(p, devices=cpus(2), fault_plan=slow)
    assert sh.num_shards == 2 and slow.fired() == {"shard_load_error": 1}


def test_rewrite_replaces_the_directory_whole(tmp_path):
    p = str(tmp_path / "m.sharded")
    save_sharded_snapshot(p, port_snapshot(), 3)
    save_sharded_snapshot(p, port_snapshot(random_phi(5)), 2)
    assert sorted(os.listdir(tmp_path)) == ["m.sharded"]
    np.testing.assert_array_equal(
        assemble_sharded_snapshot(p, device="cpu").phi_vk.numpy(),
        random_phi(5))
    assert len(os.listdir(p)) == 4


def test_serving_devices_needs_cards():
    assert serving_devices(3, "cpu") == (torch.device("cpu"),) * 3
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA cards")
    with pytest.raises(ValueError, match="4 phi shards needs 4 CUDA "
                                         "devices; have 0"):
        serving_devices(4)
    with pytest.raises(ValueError, match="devices"):
        shard_snapshot(port_snapshot(), 2)
    with pytest.raises(ValueError, match="3 devices for 2"):
        shard_snapshot(port_snapshot(), 2, devices=cpus(3))


def test_load_any_dispatches_on_layout(tmp_path):
    dense_p = save_snapshot(str(tmp_path / "m.npz"), port_snapshot())
    shard_p = save_sharded_snapshot(str(tmp_path / "m.sharded"),
                                    port_snapshot(), 3)
    assert not isinstance(load_any_snapshot(dense_p, device="cpu"),
                          ShardedModelSnapshot)
    assert load_any_snapshot(shard_p, device="cpu").num_shards == 3
    resh = load_any_snapshot(dense_p, shards=2, comm="all2all", device="cpu")
    assert resh.num_shards == 2 and resh.comm == "all2all"
    assert resh.devices == (torch.device("cpu"),) * 2


# ---------------------------------------------------------------------------
# the engine and evaluation on a sharded snapshot
# ---------------------------------------------------------------------------
def _engine(snap, comm="auto", seed=5, sanitize=False):
    return LDAServeEngine(HotSwapModel(snap), EngineConfig(
        max_batch=4, max_delay_ms=5.0, length_buckets=(32, 64),
        infer=cfg(comm=comm), sanitize=sanitize), seed=seed)


def _docs(n=5):
    rng = np.random.default_rng(3)
    return [rng.integers(0, V, rng.integers(1, 60)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("comm", ["psum", "all2all"])
def test_engine_sharded_matches_dense_engine(comm):
    """One doc a batch (so both engines form the same batches and draw the
    same seeds): the sharded engine's theta equals the dense engine's, one
    H2D copy a batch, and the comm counter is the sum of the batches'
    planned bytes."""
    dense = port_snapshot()
    sh = shard_snapshot(dense, 3, devices=cpus(3))
    docs = _docs()
    e_dense, e_shard = _engine(dense), _engine(sh, comm, sanitize=True)
    try:
        for d in docs:
            r1, r2 = e_dense.infer(d), e_shard.infer(d)
            np.testing.assert_array_equal(r1["theta"], r2["theta"])
            np.testing.assert_array_equal(r1["top_topics"], r2["top_topics"])
        s = e_shard.stats()
        ec = e_shard.cfg
    finally:
        e_dense.stop()
        e_shard.stop()
    assert s["batches"] == len(docs) == s["h2d_transfers"]
    want = 0
    for d in docs:
        B = _bucket(1, ec.batch_buckets())
        Lb = _bucket(len(d), ec.length_buckets)
        plan = routing_plan(sh, *_host_batch_from_buffer(
            pack_request_buffer([d], B, Lb, 0)))
        want += plan.a2a_bytes if comm == "all2all" else plan.psum_bytes
    assert s["comm_bytes_moved"] == want > 0
    assert e_dense.stats()["comm_bytes_moved"] == 0


def test_engine_hot_swaps_across_layouts():
    dense = port_snapshot()
    eng = _engine(dense)
    docs = _docs(3)
    try:
        base = [eng.infer(d)["theta"] for d in docs]
        v2 = eng.model.publish(shard_snapshot(dense, 2, devices=cpus(2),
                                              comm="all2all"))
        r2 = [eng.infer(d) for d in docs]
        v3 = eng.model.publish(dense)
        r3 = eng.infer(docs[0])
        moved = eng.stats()["comm_bytes_moved"]
    finally:
        eng.stop()
    assert (v2, v3) == (2, 3)
    assert all(r["model_version"] == 2 for r in r2)
    assert r3["model_version"] == 3
    assert moved > 0
    for b, r in zip(base, r2):      # another seed a batch, same model
        assert abs(b.sum() - r["theta"].sum()) < 1e-5


def test_auto_comm_defers_to_snapshot_tag():
    from repro_torch.serve.infer import resolve_comm

    sh = shard_snapshot(port_snapshot(), 2, devices=cpus(2), comm="all2all")
    assert resolve_comm(sh, cfg()) == "all2all"
    assert resolve_comm(sh, cfg(comm="psum")) == "psum"
    eng = _engine(sh)
    try:
        eng.infer(_docs(1)[0])
        traced = [ev["name"] for ev in
                  eng.obs.tracer.to_chrome()["traceEvents"]]
        moved = eng.stats()["comm_bytes_moved"]
    finally:
        eng.stop()
    assert "route" in traced
    plan = routing_plan(sh, *_host_batch_from_buffer(
        pack_request_buffer(_docs(1), 1, 64, 0)))
    assert moved == plan.a2a_bytes != plan.psum_bytes


def test_heldout_perplexity_same_sharded_and_dense():
    dense = port_snapshot()
    docs = _docs(6)
    a = heldout_perplexity(dense, docs, cfg(), seed=2)
    for comm in ("psum", "all2all"):
        b = heldout_perplexity(shard_snapshot(dense, 3, devices=cpus(3),
                                              comm=comm), docs, cfg(), seed=2)
        assert a == b


# ---------------------------------------------------------------------------
# publishing and the launcher
# ---------------------------------------------------------------------------
def test_publish_sharded_snapshot_from_state(tmp_path):
    phi = random_phi()
    state = type("S", (), dict(phi_vk=torch.from_numpy(phi),
                               phi_sum=torch.from_numpy(phi.sum(0)),
                               iteration=4))
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=1)
    p = mgr.publish_snapshot(state, 0.3, 0.05, num_words_total=V, shards=2)
    assert p.endswith("snapshot_00000004.sharded")
    assert mgr.latest_snapshot_path() == p
    back = assemble_sharded_snapshot(p, device="cpu")
    np.testing.assert_array_equal(back.phi_vk.numpy(), phi)
    assert back.meta["iteration"] == 4
    state.iteration = 5
    p2 = mgr.publish_snapshot(state, 0.3, 0.05, num_words_total=V)
    assert mgr.latest_snapshot_path() == p2 and not os.path.exists(p)
    shard_of, local_id, _ = tsnap.plan_contiguous_shards(V, 3)
    blocks = (b for b in tsnap.split_dense_phi(phi, 3)[0])   # one at a time
    p3 = mgr.publish_snapshot(blocks=blocks, phi_sum=phi.sum(0),
                              shard_of=shard_of, local_id=local_id,
                              iteration=6, alpha=0.3, beta=0.05,
                              num_words_total=V)
    assert mgr.latest_snapshot_path() == p3 and not os.path.exists(p2)
    np.testing.assert_array_equal(
        jsnap.assemble_sharded_snapshot(p3).phi_vk, phi)
    with pytest.raises(TypeError, match="missing"):
        mgr.publish_snapshot(blocks=[phi], iteration=7)


def test_serve_lda_shards_and_comm(tmp_path):
    from repro_torch.launch import serve_lda

    dense_p = save_snapshot(str(tmp_path / "m.npz"), port_snapshot())
    args = serve_lda.build_argparser().parse_args(
        ["--snapshot", dense_p, "--device", "cpu", "--shards", "4",
         "--comm", "all2all"])
    assert (args.shards, args.comm) == (4, "all2all")
    snap = serve_lda.load_model(args)
    assert snap.num_shards == 4 and snap.comm == "all2all"
    assert "V-sharded x4 (comm=all2all)" in serve_lda.layout(snap)
    model, engine = serve_lda.make_engine(args, snap)
    try:
        res = engine.infer(_docs(1)[0])
        v = model.publish(serve_lda.load_model(args, dense_p))
    finally:
        engine.stop()
    assert res["theta"].shape == (K,) and v == 2
    assert engine.cfg.infer.comm == "all2all"
    plain = serve_lda.build_argparser().parse_args(
        ["--snapshot", dense_p, "--device", "cpu"])
    assert (plain.shards, plain.comm) == (0, "auto")
    assert serve_lda.layout(serve_lda.load_model(plain)) == "dense on cpu"
    shard_p = save_sharded_snapshot(str(tmp_path / "m.sharded"),
                                    port_snapshot(), 2)
    plain.snapshot = shard_p
    assert serve_lda.load_model(plain).num_shards == 2
    plain.fault_plan = "shard_load_error@0"
    with pytest.raises(SnapshotIntegrityError):
        serve_lda.load_model(plain, fault_plan=serve_lda.make_fault_plan(
            plain))
