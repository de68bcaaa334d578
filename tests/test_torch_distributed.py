"""The port's multi-device training (repro_torch.core.sync,
repro_torch.distributed.partition, fit(mesh=...)) held against the JAX
package's DistributedLDA, on the CPU: gloo ranks spawned as processes
against the reference's forced host devices.

In-process: the host-side partition functions (vocabulary LPT, shards,
heavy rows, the 2d phi un-permute, the 2d ELL type) against the reference
or against counts rebuilt on the host.

Across processes, on the reference's tiny corpus (K = 8): one reference run
on 4 forced host devices writes its starting z, the uniforms each device
drew (rebuilt from the key chain of ``DistributedLDA.step`` and
``trainer.lda_iteration``) and its states; one spawn of 4 gloo ranks
restores the same z and steps with the same uniforms.

Bounds:

* z, phi and phi_sum equal the reference's exactly after 2 iterations, 1d
  and 2d, int32 and the int16 byte wire, WS2 with ``sync_overlap`` off and
  on (fault F2 allows no flip at K <= 256); LL/token within 1e-4 (float32
  sums in another order); stats within 1e-6;
* the compressed wire equals the int32 sync, and the overlapped sync the
  serialized one, bit for bit; the byte wire equals an int32 sum on deltas
  planted past +-2^15, on 2 and on 4 ranks;
* a reference-written 1d checkpoint restored onto a 2d mesh: phi_sum exact,
  LL/token within 2e-3;
* a 4-rank chain and the single-device chain (different random streams)
  after 12 iterations: LL/token within 0.4 nats
  (``test_multidevice_matches_singledevice_distribution``).
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_subprocess
from repro_torch.core import trainer as ttrainer
from repro_torch.core import updates as tupdates
from repro_torch.core.corpus import Corpus
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed import launch
from repro_torch.distributed import partition as tpart

CORPUS = dict(num_docs=48, num_words=96, num_topics=8, avg_doc_len=40, seed=1)
BASE = dict(num_topics=8, tile_tokens=32, tiles_per_step=8, seed=0)
HEAVY_BOUND = 8      # INT16_FLUX_BOUND patched down: real words become heavy
ITERS = 2
CHAIN_ITERS = 12

# name: (mode, config overrides)
CASES = {
    "1d": ("1d", {}),
    "1d_c": ("1d", dict(compressed_sync=True)),
    "1d_m2": ("1d", dict(micro_chunks=2)),
    "1d_m2_o": ("1d", dict(micro_chunks=2, sync_overlap=True)),
    "1d_m2_c": ("1d", dict(micro_chunks=2, compressed_sync=True)),
    "1d_m2_oc": ("1d", dict(micro_chunks=2, sync_overlap=True,
                            compressed_sync=True)),
    "2d": ("2d", {}),
    "2d_c": ("2d", dict(compressed_sync=True)),
}

REFERENCE = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.core import sampler, trainer
from repro.data.synthetic import lda_corpus
from repro.distributed import checkpoint as ckpt, partition
from repro.distributed.partition import DistributedLDA

CASES, OUT, CKPT = {cases!r}, {out!r}, {ckpt!r}
partition.INT16_FLUX_BOUND = {bound}
corpus = lda_corpus(**{corpus!r})
base = trainer.LDAConfig(**{base!r})
meshes = dict(zip(("1d", "2d"), (jax.make_mesh((4,), ("data",)),
                                 jax.make_mesh((2, 2), ("data", "model")))))


def uniforms(dl, mode, it):
    # the key chain of DistributedLDA.step and trainer.lda_iteration
    _, n, t = dl.stacked["token_doc"].shape
    M = dl.cfg.micro_chunks
    out = []
    for g in range(4):
        k = jax.random.fold_in(jax.random.key(dl.cfg.seed + 1), it)
        for i in ((g,) if mode == "1d" else (g // 2, g % 2)):
            k = jax.random.fold_in(k, i)
        if M == 1:
            u = sampler.draw_sweep_uniforms(k, n, t)
        else:
            nc = (n + (-n % M)) // M
            u = jnp.concatenate([sampler.draw_sweep_uniforms(km, nc, t)
                                 for km in jax.random.split(k, M)])
        out.append(np.asarray(u))
    return np.stack(out)


res = {{}}
for name, (mode, over) in CASES.items():
    cfg = dataclasses.replace(base, **over)
    dl = DistributedLDA(cfg, meshes[mode], corpus, mode=mode,
                        doc_axes=("data",),
                        word_axes=("model",) if mode == "2d" else ())
    if cfg.compressed_sync:
        assert dl._heavy.shape[1] > 0
    uid = dl.stacked["token_uid"]
    st = dl.init()
    res[name + "/z0"] = ckpt.gather_canonical_z(st.z, uid, corpus.num_tokens)
    us = []
    for it in range({iters}):
        us.append(uniforms(dl, mode, it))
        st, stats = dl.step(st)
    res[name + "/u"] = np.stack(us)
    res[name + "/z"] = ckpt.gather_canonical_z(st.z, uid, corpus.num_tokens)
    res[name + "/phi"] = dl.gather_phi(st)
    res[name + "/phi_sum"] = np.asarray(st.phi_sum)
    res[name + "/ll"] = np.float64(dl.log_likelihood(st))
    res[name + "/stats"] = np.asarray([float(stats.sparse_frac),
                                       float(stats.mean_s_over_sq),
                                       float(stats.ell_overflow)])
    if name == "1d":
        dl.save_checkpoint(ckpt.CheckpointManager(CKPT, async_write=False), st)
np.savez(OUT, **res)
print("OK")
"""


def as_port(c) -> Corpus:
    return Corpus(c.doc_ids, c.word_ids, c.num_docs, c.num_words)


def port_corpus():
    from repro_torch.data.synthetic import lda_corpus
    return lda_corpus(**CORPUS)


def port_cfg(**over):
    return ttrainer.LDAConfig(**BASE, **over)


# ---------------------------------------------------------------------------
# the gloo ranks (spawned; importable by name, so no JAX at module level)
# ---------------------------------------------------------------------------
def _meshes():
    from torch.distributed.device_mesh import init_device_mesh
    return {"1d": init_device_mesh("cpu", (4,), mesh_dim_names=("data",)),
            "2d": init_device_mesh("cpu", (2, 2),
                                   mesh_dim_names=("data", "model"))}


def _dl(cfg, mesh, corpus, mode):
    return tpart.DistributedLDA(
        cfg, mesh, corpus, mode=mode, doc_axes=("data",),
        word_axes=("model",) if mode == "2d" else ())


def _planted(rank: int) -> torch.Tensor:
    """A (5, 7) delta whose sums over 2 or 4 ranks leave int16 in rows 1
    and 2 (35 entries: padded to a multiple of both rank counts)."""
    d = torch.zeros((5, 7), dtype=torch.int32)
    d[1, 2] = 20000 + rank
    d[2, 0] = -9000 * (rank + 1)
    d[2, 5] = 17000
    d[0, 1] = rank - 2
    d[4, 6] = 123 * rank
    return d


def _byte_wire(rank, out):
    from repro_torch.core import sync

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    heavy = torch.tensor([2, 1, 1, 0])        # duplicates and a light row
    for G, group in ((4, dist.group.WORLD), (2, pairs[rank // 2])):
        exact = _planted(rank)
        dist.all_reduce(exact, group=group)
        wrapped = sync.compressed_sync_phi(_planted(rank), group)
        fixed = sync.compressed_sync_phi(_planted(rank), group, heavy)
        pending = sync.sync_phi_delta(_planted(rank), group, heavy,
                                      compressed=True, async_op=True)
        light = torch.ones(5, dtype=torch.bool)
        light[[1, 2]] = False
        out[f"wire{G}/{rank}"] = np.stack([
            exact.numpy(), wrapped.numpy(), fixed.numpy(),
            pending.wait().numpy(), (exact.to(torch.int16).to(torch.int32)
                                     ).numpy()])
        assert torch.equal(wrapped[light], exact[light])


def _no_gather(state):
    raise AssertionError("the LPT publish gathered the whole phi")


def _publish_sharded(dl, st, out_dir, out):
    """Sharded snapshots of the 2d state: 2 shards (the word shards' own
    blocks, sent to rank 0 one at a time, never gathered) and 3 (the
    canonical phi gathered and split contiguously)."""
    for n in (2, 3):
        mgr = tckpt.CheckpointManager(os.path.join(out_dir, f"sharded{n}"))
        if n == 2:
            dl.gather_phi = _no_gather
        path = mgr.publish_snapshot(st, partition=dl, shards=n)
        if n == 2:
            del dl.gather_phi
        out[f"publish{n}/path"] = np.asarray(path)
        out[f"publish{n}/same_path"] = np.asarray(
            path == mgr.snapshot_path(ITERS, sharded=True))


def _ranks_main(rank, ref_path, ckpt_dir, out_dir):
    torch.set_num_threads(1)
    tpart.INT16_FLUX_BOUND = HEAVY_BOUND
    ref = np.load(ref_path)
    corpus = port_corpus()
    meshes = _meshes()
    out = {}
    for name, (mode, over) in CASES.items():
        dl = _dl(port_cfg(**over), meshes[mode], corpus, mode)
        if dl.cfg.compressed_sync:
            assert dl.heavy_rows is not None and dl.heavy_rows.numel() > 0
        st = dl.restore(ref[name + "/z0"], 0)
        for it in range(ITERS):
            st, stats = dl.step(st, torch.from_numpy(
                ref[name + "/u"][it, dl.rank]))
        out[name + "/z"] = dl.gather_canonical_z(st)
        out[name + "/phi"] = dl.gather_phi(st)
        out[name + "/phi_sum"] = st.phi_sum.numpy()
        out[name + "/ll"] = np.float64(dl.log_likelihood(st))
        out[name + "/stats"] = np.asarray([float(stats.sparse_frac),
                                           float(stats.mean_s_over_sq),
                                           float(stats.ell_overflow)])
        out[name + "/iteration"] = np.int64(st.iteration)
        if name == "2d":          # a dense snapshot through the partition
            mgr = tckpt.CheckpointManager(os.path.join(out_dir, "snaps"))
            out["publish/path"] = np.asarray(mgr.publish_snapshot(
                st, partition=dl))
            _publish_sharded(dl, st, out_dir, out)
    # elastic: the reference's 1d checkpoint onto this 2d mesh
    it, z, meta = tckpt.CheckpointManager(ckpt_dir).latest()
    dl = _dl(port_cfg(), meshes["2d"], corpus, "2d")
    st = dl.restore(z, it)
    out["elastic/phi_sum"] = st.phi_sum.numpy()
    out["elastic/ll"] = np.float64(dl.log_likelihood(st))
    out["elastic/meta_mode"] = np.asarray(meta["mode"])
    for _ in range(3):          # training goes on after the move
        st, _ = dl.step(st)
    out["elastic/ll_after"] = np.float64(dl.log_likelihood(st))
    # a chain of the port's own draws
    dl = _dl(port_cfg(), meshes["1d"], corpus, "1d")
    st = dl.init()
    for _ in range(CHAIN_ITERS):
        st, _ = dl.step(st)
    out["chain/ll"] = np.float64(dl.log_likelihood(st))
    out["chain/phi_total"] = np.int64(st.phi_vk.sum())
    _byte_wire(rank, out)
    wire = {k: v for k, v in out.items() if k.startswith("wire")}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **(out if rank == 0 else wire))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference run, then the port's 4 gloo ranks on its inputs."""
    root = tmp_path_factory.mktemp("dist")
    ref_path, ckpt_dir = str(root / "ref.npz"), str(root / "ckpt")
    code = REFERENCE.format(cases=CASES, out=ref_path, ckpt=ckpt_dir,
                            bound=HEAVY_BOUND, corpus=CORPUS, base=BASE,
                            iters=ITERS)
    assert "OK" in run_subprocess(code, devices=4)
    launch.spawn(_ranks_main, 4, args=(ref_path, ckpt_dir, str(root)),
                 store_dir=str(root))
    ref = dict(np.load(ref_path))
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(4)]
    return ref, ranks


# ---------------------------------------------------------------------------
# across processes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_jax(runs, name):
    ref, ranks = runs
    got = ranks[0]
    np.testing.assert_array_equal(got[name + "/z"], ref[name + "/z"])
    np.testing.assert_array_equal(got[name + "/phi"], ref[name + "/phi"])
    np.testing.assert_array_equal(got[name + "/phi_sum"],
                                  ref[name + "/phi_sum"])
    assert int(got[name + "/iteration"]) == ITERS
    assert abs(float(got[name + "/ll"]) - float(ref[name + "/ll"])) < 1e-4
    np.testing.assert_allclose(got[name + "/stats"], ref[name + "/stats"],
                               atol=1e-6)
    assert got[name + "/phi"].sum() == port_corpus().num_tokens


@pytest.mark.parametrize("a,b", [
    ("1d", "1d_c"), ("1d_m2", "1d_m2_o"), ("1d_m2", "1d_m2_c"),
    ("1d_m2", "1d_m2_oc"), ("2d", "2d_c")])
def test_wire_and_schedule_leave_the_state_unchanged(runs, a, b):
    """The int16 byte wire equals the int32 sync, and the per-chunk
    overlapped sync the end-of-iteration one, bit for bit."""
    got = runs[1][0]
    for f in ("z", "phi", "phi_sum"):
        np.testing.assert_array_equal(got[f"{a}/{f}"], got[f"{b}/{f}"])


@pytest.mark.parametrize("G", [2, 4])
def test_byte_wire_matches_int32_sum(runs, G):
    """Deltas planted past +-2^15: the plain byte wire wraps them (the
    hazard), the heavy-row correction and its async form restore the int32
    sum; light entries are exact either way."""
    for r, rank in enumerate(runs[1]):
        exact, wrapped, fixed, pending, wrap16 = rank[f"wire{G}/{r}"]
        assert np.abs(exact).max() > 1 << 15
        np.testing.assert_array_equal(wrapped, wrap16)
        assert not np.array_equal(wrapped, exact)
        np.testing.assert_array_equal(fixed, exact)
        np.testing.assert_array_equal(pending, exact)


def test_elastic_restore_jax_1d_checkpoint_onto_2d(runs):
    ref, ranks = runs
    got = ranks[0]
    assert str(got["elastic/meta_mode"]) == "1d"
    np.testing.assert_array_equal(got["elastic/phi_sum"], ref["1d/phi_sum"])
    assert abs(float(got["elastic/ll"]) - float(ref["1d/ll"])) < 2e-3
    assert float(got["elastic/ll_after"]) >= float(got["elastic/ll"]) - 0.05


def test_publish_snapshot_through_2d_partition(runs):
    """A 2d-trained state publishes the canonical phi (rows un-permuted),
    written once by rank 0."""
    from repro_torch.serve import load_snapshot

    ref, ranks = runs
    path = str(ranks[0]["publish/path"])
    snap = load_snapshot(path, device="cpu")
    corpus = port_corpus()
    expected = np.zeros((corpus.num_words, 8), np.int32)
    np.add.at(expected, (corpus.word_ids, ref["2d/z"].astype(np.int64)), 1)
    np.testing.assert_array_equal(snap.phi_vk.numpy(), expected)
    assert snap.num_words_total == corpus.num_words
    assert snap.meta["mode"] == "2d" and snap.meta["iteration"] == ITERS
    assert os.listdir(os.path.dirname(path)) == [os.path.basename(path)]


@pytest.mark.parametrize("n,layout", [(2, "lpt"), (3, "contiguous")])
def test_2d_partition_publishes_sharded_snapshot(runs, n, layout):
    """A 2d-trained state publishes V-sharded: at the word-shard count the
    trainer's own LPT blocks (no rank gathered phi), otherwise a
    contiguous re-split; both assemble to the reference's canonical phi."""
    from repro_torch.serve import load_sharded_snapshot

    ref, ranks = runs
    path = str(ranks[0][f"publish{n}/path"])
    assert path.endswith(".sharded") and bool(ranks[0][f"publish{n}/same_path"])
    snap = load_sharded_snapshot(path, devices=("cpu",) * n)
    assert snap.num_shards == n
    assert snap.meta == {"mode": "2d", "layout": layout, "iteration": ITERS}
    np.testing.assert_array_equal(snap.assemble().phi_vk.numpy(),
                                  ref["2d/phi"])
    np.testing.assert_array_equal(snap.phi_sum.numpy(), ref["2d/phi_sum"])
    if layout == "lpt":
        plan = tpart.partition_vocabulary(port_corpus(), 2)
        np.testing.assert_array_equal(snap.word_shard_of, plan[0])
        np.testing.assert_array_equal(snap.word_local_id, plan[1])
        assert snap.phi_blocks[0].shape == (plan[2], 8)


def test_multirank_chain_matches_single_device_chain(runs):
    from repro_torch.train import fit

    got = runs[1][0]
    corpus = port_corpus()
    assert int(got["chain/phi_total"]) == corpus.num_tokens
    single = fit(corpus, port_cfg(), CHAIN_ITERS, device="cpu",
                 eval_every=CHAIN_ITERS)
    assert abs(single.ll_per_token[-1] - float(got["chain/ll"])) < 0.4


# ---------------------------------------------------------------------------
# in-process: the host-side partition against the reference
# ---------------------------------------------------------------------------
def _jax_corpus(kind):
    from repro.data import synthetic as jsyn
    if kind == "lda":
        return jsyn.lda_corpus(**CORPUS)
    return jsyn.zipf_corpus(num_docs=64, num_words=200, avg_doc_len=50,
                            seed=3)


@pytest.mark.parametrize("kind", ["lda", "zipf"])
@pytest.mark.parametrize("mode,n_doc,n_word", [("1d", 4, 1), ("2d", 2, 2),
                                               ("2d", 1, 3)])
def test_build_shards_matches_jax(kind, mode, n_doc, n_word):
    from repro.distributed import partition as jpart

    c = _jax_corpus(kind)
    jshards, jplan, jfull = jpart.build_shards(c, n_doc, n_word, mode, 16)
    tshards, tplan = tpart.build_shards(as_port(c), n_doc, n_word, mode, 16)
    assert len(tshards) == len(jshards) == n_doc * n_word
    for f in ("word_shard_of", "word_local_id"):
        a, b = getattr(jplan, f), getattr(tplan, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    assert jplan.vocab_shard_size == tplan.vocab_shard_size
    for g, (j, t) in enumerate(zip(jshards, tshards)):
        for f in ("tile_word", "token_doc", "token_mask", "tile_first",
                  "token_uid", "doc_global"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                          getattr(t, f).numpy(),
                                          err_msg=f"{f} of shard {g}")
        np.testing.assert_array_equal(jfull[g], t.doc_length.numpy())
        assert t.max_doc_length == int(jfull[g].max())
        for f in ("num_tokens", "num_words", "num_docs_local",
                  "num_words_total"):
            assert getattr(j, f) == getattr(t, f), f
    only = tpart.build_shards(as_port(c), n_doc, n_word, mode, 16,
                              only=n_doc * n_word - 1)[0]
    np.testing.assert_array_equal(only[0].token_uid.numpy(),
                                  tshards[-1].token_uid.numpy())


@pytest.mark.parametrize("shards", [2, 3])
def test_partition_vocabulary_matches_jax(shards):
    from repro.distributed import partition as jpart

    c = _jax_corpus("zipf")
    for a, b in zip(jpart.partition_vocabulary(c, shards),
                    tpart.partition_vocabulary(as_port(c), shards)):
        np.testing.assert_array_equal(a, b)


def test_heavy_word_rows_1d_and_2d(monkeypatch):
    """As the reference's test: words at or above the flux bound get int32
    rows, global ids in 1d, the owning word shard's local rows in 2d, padded
    with row 0, doc-major; and the port's rows equal the reference's."""
    from repro.core.corpus import Corpus as JCorpus
    from repro.distributed import partition as jpart

    bound = tpart.INT16_FLUX_BOUND
    word_ids = np.concatenate([
        np.full(bound + 100, 3), np.full(bound, 7), np.full(bound - 2, 5),
        np.arange(10)]).astype(np.int32)
    doc_ids = (np.arange(word_ids.size) % 16).astype(np.int32)
    order = np.argsort(doc_ids, kind="stable")
    corpus = Corpus(doc_ids[order], word_ids[order], 16, 12)
    jc = JCorpus(doc_ids[order], word_ids[order], 16, 12)

    plan_1d = tpart.PartitionPlan("1d", ("data",), (), 4, 1)
    rows = tpart.heavy_word_rows(corpus, plan_1d)
    assert rows.shape == (4, 2) and (rows == np.array([3, 7])).all()
    shard_of = (np.arange(12) % 2).astype(np.int32)
    local_id = (np.arange(12) // 2).astype(np.int32)
    plans = [tpart.PartitionPlan("2d", ("data",), ("model",), 2, 2,
                                 word_shard_of=shard_of,
                                 word_local_id=local_id, vocab_shard_size=6),
             jpart.PartitionPlan("2d", ("data",), ("model",), 2, 2,
                                 word_shard_of=shard_of,
                                 word_local_id=local_id, vocab_shard_size=6)]
    rows = tpart.heavy_word_rows(corpus, plans[0])
    assert rows.shape == (4, 2)
    for d in (0, 1):
        assert rows[2 * d].tolist() == [0, 0]
        assert rows[2 * d + 1].tolist() == [1, 3]
    np.testing.assert_array_equal(rows, jpart.heavy_word_rows(jc, plans[1]))
    monkeypatch.setattr(tpart, "INT16_FLUX_BOUND", 1 << 30)
    assert tpart.heavy_word_rows(corpus, plans[0]).shape == (4, 0)


def test_gather_phi_2d_unpermutes_to_canonical_rows():
    """2d word shards hold phi rows in (shard, LPT-local row) order; the
    rows gather_phi un-permutes give phi counted on the host from the
    canonical z."""
    corpus = as_port(_jax_corpus("zipf"))
    shards, plan = tpart.build_shards(corpus, 1, 3, "2d", 16)
    rng = np.random.default_rng(0)
    z_canon = rng.integers(0, 5, corpus.num_tokens).astype(np.int16)
    blocks = []
    for s in shards:
        z = torch.from_numpy(tckpt.scatter_canonical_z(z_canon, s.token_uid)
                             .astype(np.int64))
        blocks.append(tupdates.phi_from_z(z, s.tile_word, s.token_mask,
                                          plan.vocab_shard_size, 5).numpy())
    got = tpart.canonical_phi(np.stack(blocks), plan)
    expected = np.zeros((corpus.num_words, 5), np.int32)
    np.add.at(expected, (corpus.word_ids, z_canon.astype(np.int64)), 1)
    np.testing.assert_array_equal(got, expected)
    assert not np.array_equal(np.concatenate(blocks)[:corpus.num_words],
                              expected)


def test_2d_ell_type_follows_whole_document_length():
    """A 40,000-token document split over two word shards: each shard sees
    fewer than 2^15 of its tokens, but the ELL holds the model-group sum,
    which reaches 40,000, so the ELL must be int32, not int16."""
    words = np.arange(40_000, dtype=np.int32) % 40
    docs = np.zeros(40_000, np.int32)
    corpus = Corpus(np.concatenate([docs, [1, 1]]).astype(np.int32),
                    np.concatenate([words, [0, 1]]).astype(np.int32), 2, 40)
    shards, _ = tpart.build_shards(corpus, 1, 2, "2d", 256)
    K = 64
    cfg = ttrainer.LDAConfig(num_topics=K, tile_tokens=256)
    cfg = ttrainer.resolve_config(cfg, corpus)
    thetas = []
    for s in shards:
        local = int(np.bincount(s.token_doc.numpy()[s.token_mask.numpy()]
                                ).max())
        assert local < 1 << 15 and s.max_doc_length == 40_000
        z = torch.zeros_like(s.token_doc, dtype=torch.int16)  # one topic
        _, counts, _, _ = ttrainer.theta_and_ell(cfg, s, z)
        assert counts.dtype == torch.int32
        assert tupdates.ell_dtype(K, local) == torch.int16   # the hazard
        thetas.append(tupdates.theta_from_z(z, s.token_doc, s.token_mask,
                                            s.num_docs_local, K))
    counts, _, _ = tupdates.theta_to_ell(thetas[0] + thetas[1], 8,
                                         tupdates.ell_dtype(
                                             K, shards[0].max_doc_length))
    assert int(counts[0, 0]) == 40_000


def test_mesh_device_follows_the_mesh():
    """A rank's device is the mesh's device type, and nothing else: a
    device of another type is refused (no fallback to the CPU)."""
    import types

    cpu_mesh = types.SimpleNamespace(device_type="cpu")
    assert tpart.mesh_device(cpu_mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="not on the cpu mesh"):
        tpart.mesh_device(cpu_mesh, "meta")
