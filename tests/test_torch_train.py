"""The port's training path (repro_torch.core.{corpus, updates, likelihood,
trainer}, repro_torch.train, repro_torch.distributed.checkpoint and the
launchers) held against the JAX package on the same numpy inputs, on the
CPU (where the kernels' plain versions run).

Tolerances:

* tilings, counts, deltas, ELL counts and topics: exact;
* one ``lda_iteration`` from the same state and uniforms: draws exact at
  K <= 256, at most 1e-4 of real tokens flipped at K = 1024 (fault F2),
  and phi == phi_old + delta == phi_from_z(z_new) exactly;
* likelihood terms: rtol 1e-5 (float32 sums in another order);
* whole ``fit`` runs use different random streams (torch's generator, not
  jax.random), so they are compared by their final LL/token: the mean over
  three seeds within 0.15 nats/token after 20 iterations.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import corpus as jcorpus
from repro.core import dense_sampler as jdense
from repro.core import likelihood as jlik
from repro.core import sampler as jsampler
from repro.core import trainer as jtrainer
from repro.core import updates as jupdates
from repro.data import synthetic as jsyn
from repro.distributed import checkpoint as jckpt
from repro.train import fit as jfit
from repro_torch.core import corpus as tcorpus
from repro_torch.core import likelihood as tlik
from repro_torch.core import trainer as ttrainer
from repro_torch.core import updates as tupdates
from repro_torch.data import synthetic as tsyn
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.train import fit as tfit

FIELDS = ("tile_word", "token_doc", "token_mask", "tile_first", "doc_length",
          "doc_global", "token_uid")
SCALARS = ("num_tokens", "num_words", "num_docs_local", "num_words_total")


def as_port(c):
    return tcorpus.Corpus(c.doc_ids, c.word_ids, c.num_docs, c.num_words)


def assert_shards_equal(j, t):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)
    for f in SCALARS:
        assert getattr(j, f) == getattr(t, f), f


def corpus_of(kind):
    if kind == "lda":
        return jsyn.lda_corpus(num_docs=40, num_words=96, num_topics=8,
                               avg_doc_len=36, seed=1)
    return jsyn.zipf_corpus(num_docs=64, num_words=200, avg_doc_len=50,
                            seed=3)


# ---------------------------------------------------------------------------
# corpus: partition, tiling, ELL capacity, UCI reader
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["lda", "zipf"])
@pytest.mark.parametrize("extra_pad", [0, 7])
def test_tile_shard_matches_jax(kind, extra_pad):
    c = corpus_of(kind)
    docs = jcorpus.partition_by_document(c, 2)[1]
    n = jcorpus.tile_shard(c, docs, 16).tile_word.shape[0]
    pad = n + extra_pad if extra_pad else None
    j = jcorpus.tile_shard(c, docs, 16, pad)
    t = tcorpus.tile_shard(as_port(c), docs, 16, pad)
    assert_shards_equal(j, t)
    assert t.token_mask.dtype == torch.bool and t.token_doc.dtype == torch.int32
    assert t.max_doc_length == int(np.asarray(j.doc_length).max())


@pytest.mark.parametrize("kind", ["lda", "zipf"])
def test_port_synthetic_corpus_and_tile_corpus_match_jax(kind):
    c = corpus_of(kind)
    tc = (tsyn.lda_corpus(num_docs=40, num_words=96, num_topics=8,
                          avg_doc_len=36, seed=1) if kind == "lda" else
          tsyn.zipf_corpus(num_docs=64, num_words=200, avg_doc_len=50,
                           seed=3))
    np.testing.assert_array_equal(c.doc_ids, tc.doc_ids)
    np.testing.assert_array_equal(c.word_ids, tc.word_ids)
    for a, b in zip(jcorpus.partition_by_document(c, 3),
                    tcorpus.partition_by_document(tc, 3)):
        np.testing.assert_array_equal(a, b)
    for j, t in zip(jcorpus.tile_corpus(c, 2, 32),
                    tcorpus.tile_corpus(tc, 2, 32)):
        assert_shards_equal(j, t)
    for q in (1.0, 0.5):
        for K in (8, 1024):
            assert (jcorpus.ell_capacity(c, K, q)
                    == tcorpus.ell_capacity(tc, K, q))


def test_shard_to_device_keeps_every_array():
    t = tcorpus.tile_corpus(as_port(corpus_of("lda")), 1, 32)[0]
    moved = t.to("cpu")
    assert moved is not t and moved.device == torch.device("cpu")
    for f in FIELDS:
        assert torch.equal(getattr(moved, f), getattr(t, f))


def test_read_uci_bow_matches_jax(tmp_path):
    path = tmp_path / "docword.txt"
    path.write_text("3\n5\n5\n1 1 2\n1 4 1\n2 2 3\n3 5 1\n3 1 2\n")
    for max_docs in (None, 2):
        j = jcorpus.read_uci_bow(str(path), max_docs)
        t = tcorpus.read_uci_bow(str(path), max_docs)
        np.testing.assert_array_equal(j.doc_ids, t.doc_ids)
        np.testing.assert_array_equal(j.word_ids, t.word_ids)
        assert (j.num_docs, j.num_words) == (t.num_docs, t.num_words)


# ---------------------------------------------------------------------------
# updates: exact scatter-adds and the ELL slice
# ---------------------------------------------------------------------------
def test_count_updates_exact():
    rng = np.random.default_rng(0)
    n, t, D, V, K = 30, 16, 12, 20, 40
    tw = np.sort(rng.integers(0, V, n)).astype(np.int32)
    td = rng.integers(0, D, (n, t)).astype(np.int32)
    tm = rng.random((n, t)) < 0.8
    zo = rng.integers(0, K, (n, t)).astype(np.int16)
    zn = rng.integers(0, K, (n, t)).astype(np.int16)
    J, T = jnp.asarray, torch.from_numpy
    np.testing.assert_array_equal(
        np.asarray(jupdates.phi_delta(J(zo), J(zn), J(tw), J(tm), V, K)),
        tupdates.phi_delta(T(zo), T(zn), T(tw), T(tm), V, K).numpy())
    np.testing.assert_array_equal(
        np.asarray(jupdates.theta_delta(J(zo), J(zn), J(td), J(tm), D, K)),
        tupdates.theta_delta(T(zo), T(zn), T(td), T(tm), D, K).numpy())
    phi = rng.integers(0, 1000, (V, K)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jupdates.phi_totals(J(phi))),
                                  tupdates.phi_totals(T(phi)).numpy())
    assert tupdates.phi_totals(T(phi)).dtype == torch.int32
    # phi_old + delta == phi_from_z(z_new)
    old = tupdates.phi_from_z(T(zo), T(tw), T(tm), V, K)
    new = tupdates.phi_from_z(T(zn), T(tw), T(tm), V, K)
    assert torch.equal(old + tupdates.phi_delta(T(zo), T(zn), T(tw), T(tm),
                                                V, K), new)


@pytest.mark.parametrize("capacity", [4, 16])
def test_theta_to_ell_matches_lax_top_k(capacity):
    """Ties everywhere (small counts) and rows beyond capacity (overflow)."""
    rng = np.random.default_rng(capacity)
    theta = (rng.random((50, 32)) < 0.3) * rng.integers(1, 4, (50, 32))
    theta = theta.astype(np.int32)
    jc, jt, jo = jupdates.theta_to_ell(jnp.asarray(theta), capacity)
    tc, tt, to = tupdates.theta_to_ell(torch.from_numpy(theta), capacity)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    assert bool(to.any()) or capacity > 4     # capacity 4 overflows


# ---------------------------------------------------------------------------
# likelihood
# ---------------------------------------------------------------------------
def test_trainer_hands_the_sweep_int16_ell():
    """C7 for the ELL: int16 counts and topics while K and the longest
    document fit, int32 beyond; the values equal the int32 ELL's, which
    ``theta_to_ell`` still returns by default."""
    assert tupdates.ell_dtype(1024, 5000) == torch.int16
    assert tupdates.ell_dtype(32767, 32767) == torch.int16
    assert tupdates.ell_dtype(32768, 10) == torch.int32
    assert tupdates.ell_dtype(64, 40000) == torch.int32
    corpus = as_port(corpus_of("zipf"))
    cfg = ttrainer.resolve_config(ttrainer.LDAConfig(num_topics=48,
                                                     tile_tokens=16), corpus)
    shard = tcorpus.tile_corpus(corpus, 1, 16)[0]
    s0 = ttrainer.init_state(cfg, shard)
    theta, c, t, over = ttrainer.theta_and_ell(cfg, shard, s0.z)
    assert c.dtype == t.dtype == torch.int16
    wc, wt, wo = tupdates.theta_to_ell(theta, cfg.ell_capacity)
    assert wc.dtype == torch.int32
    assert torch.equal(c.int(), wc) and torch.equal(t.int(), wt)
    assert torch.equal(over, wo)


def test_likelihood_terms_match_jax():
    rng = np.random.default_rng(1)
    D, V, K = 30, 60, 24
    theta = rng.integers(0, 20, (D, K)).astype(np.int32)
    theta[3] = 0                                  # an empty (padding) doc
    dl = theta.sum(1).astype(np.int32)
    phi = rng.integers(0, 50, (V, K)).astype(np.int32)
    ps = phi.sum(0).astype(np.int32)
    a, b = 50.0 / K, 0.01
    J, T = jnp.asarray, torch.from_numpy
    pairs = [
        (jlik.doc_term(J(theta), J(dl), a), tlik.doc_term(T(theta), T(dl), a)),
        (jlik.word_inner_term(J(phi), b), tlik.word_inner_term(T(phi), b)),
        (jlik.word_outer_term(J(ps), b, 500), tlik.word_outer_term(T(ps), b,
                                                                   500)),
        (jlik.joint_log_likelihood(J(theta), J(dl), J(phi), J(ps), a, b),
         tlik.joint_log_likelihood(T(theta), T(dl), T(phi), T(ps), a, b)),
    ]
    for j, t in pairs:
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_likelihood_direct():
    """The pure-python lgamma case of tests/test_trainer.py."""
    theta = np.array([[2, 0], [1, 3]], np.int64)
    dl = theta.sum(1)
    phi = np.array([[1, 1], [1, 3]], np.int64)  # K x V
    phi_sum = phi.sum(1)
    a, b, K, V = 0.5, 0.1, 2, 2
    lg = math.lgamma
    want = 0.0
    for d in range(2):
        want += lg(K * a) - lg(dl[d] + K * a)
        for k in range(K):
            want += lg(theta[d, k] + a) - lg(a)
    for k in range(K):
        want += lg(V * b) - lg(phi_sum[k] + V * b)
        for v in range(V):
            want += lg(phi[k, v] + b) - lg(b)
    got = float(tlik.joint_log_likelihood(
        torch.from_numpy(theta), torch.from_numpy(dl),
        torch.from_numpy(phi.T.copy()), torch.from_numpy(phi_sum), a, b))
    assert abs(got - want) < 1e-3, (got, want)


# ---------------------------------------------------------------------------
# one lda_iteration from the same state and uniforms
# ---------------------------------------------------------------------------
def jax_iteration_uniforms(cfg, state, key, n, t):
    """The uniforms the JAX lda_iteration draws from ``key``."""
    k = jax.random.fold_in(key, state.iteration)
    M = cfg.micro_chunks
    nc = (n + (-n % M)) // M
    if cfg.sampler == "dense":
        draw = lambda kk, m: jax.vmap(  # noqa: E731
            lambda x: jdense.tile_uniforms_dense(x, t))(jax.random.split(kk, m))
    else:
        draw = lambda kk, m: jsampler.draw_sweep_uniforms(kk, m, t)  # noqa
    if M == 1:
        return np.asarray(draw(k, n))
    return np.concatenate([np.asarray(draw(km, nc))
                           for km in jax.random.split(k, M)])


ITER_CASES = [  # (K, micro_chunks, topic dtype, sampler)
    (64, 1, "int16", "sq"), (64, 2, "int16", "sq"), (64, 4, "int32", "sq"),
    (200, 1, "int32", "sq"), (1024, 1, "int16", "sq"),
    (16, 1, "int16", "dense"), (16, 3, "int32", "dense")]


@pytest.mark.parametrize("K,M,dtype,smp", ITER_CASES)
def test_lda_iteration_matches_jax(K, M, dtype, smp):
    corpus = jsyn.lda_corpus(num_docs=30, num_words=80, num_topics=6,
                             avg_doc_len=40, seed=5)
    jcfg = jtrainer.resolve_config(jtrainer.LDAConfig(
        num_topics=K, tile_tokens=16, tiles_per_step=8, micro_chunks=M,
        sampler=smp, topic_dtype=getattr(jnp, dtype)), corpus)
    tcfg = ttrainer.LDAConfig(
        num_topics=K, tile_tokens=16, tiles_per_step=8, micro_chunks=M,
        sampler=smp, topic_dtype=getattr(torch, dtype),
        ell_capacity=jcfg.ell_capacity)
    jshard = jcorpus.tile_corpus(corpus, 1, 16)[0]
    tshard = tcorpus.tile_corpus(as_port(corpus), 1, 16)[0]
    n, t = jshard.token_doc.shape
    if M == 4:
        assert n % 4, "the M = 4 case must pad the tile count"
    key = jax.random.key(K + M)
    js0 = jtrainer.init_state(jcfg, jshard, key)
    js1, jst = jtrainer.lda_iteration(jcfg, jshard, js0, key)
    uni = jax_iteration_uniforms(jcfg, js0, key, n, t)

    ts0 = ttrainer.state_from_numpy(tcfg, tshard, np.asarray(js0.z), 0,
                                    phi=np.asarray(js0.phi_vk),
                                    phi_sum=np.asarray(js0.phi_sum))
    ts1, tst = ttrainer.lda_iteration(tcfg, tshard, ts0,
                                      uniforms=torch.from_numpy(uni))
    assert ts1.z.dtype == getattr(torch, dtype) and ts1.iteration == 1
    mask = tshard.token_mask.numpy()
    flips = int(((np.asarray(js1.z) != ts1.z.numpy()) & mask).sum())
    if K <= 256:
        assert flips == 0
        np.testing.assert_array_equal(np.asarray(js1.phi_vk),
                                      ts1.phi_vk.numpy())
        assert abs(float(jst.sparse_frac) - float(tst.sparse_frac)) < 1e-6
        assert abs(float(jst.mean_s_over_sq)
                   - float(tst.mean_s_over_sq)) < 1e-6
    else:
        assert flips <= 1e-4 * mask.sum() + 1, flips
    delta = tupdates.phi_delta(ts0.z, ts1.z, tshard.tile_word,
                               tshard.token_mask, corpus.num_words, K)
    rebuilt = tupdates.phi_from_z(ts1.z, tshard.tile_word, tshard.token_mask,
                                  corpus.num_words, K)
    assert torch.equal(ts1.phi_vk, ts0.phi_vk + delta)
    assert torch.equal(ts1.phi_vk, rebuilt)
    assert torch.equal(ts1.phi_sum, tupdates.phi_totals(rebuilt))
    assert int(tst.ell_overflow) == int(jst.ell_overflow) == 0


def test_iteration_draws_depend_only_on_seed_and_iteration():
    corpus = as_port(corpus_of("lda"))
    cfg = ttrainer.resolve_config(ttrainer.LDAConfig(num_topics=8,
                                                     tile_tokens=32), corpus)
    shard = tcorpus.tile_corpus(corpus, 1, 32)[0]
    s0 = ttrainer.init_state(cfg, shard)
    a, _ = ttrainer.lda_iteration(cfg, shard, s0)
    b, _ = ttrainer.lda_iteration(cfg, shard, s0)
    c, _ = ttrainer.lda_iteration(cfg, shard, s0._replace(iteration=5))
    assert torch.equal(a.z, b.z) and not torch.equal(a.z, c.z)
    assert torch.equal(ttrainer.init_state(cfg, shard).z, s0.z)


def test_sync_options_leave_one_device_state_unchanged():
    """compressed_sync and sync_overlap shape multi-device syncs; on one
    device the reference returns the same state with or without them, and
    so does the port."""
    import dataclasses

    corpus = as_port(corpus_of("lda"))
    base = ttrainer.resolve_config(ttrainer.LDAConfig(
        num_topics=8, tile_tokens=16, micro_chunks=2), corpus)
    shard = tcorpus.tile_corpus(corpus, 1, 16)[0]
    s0 = ttrainer.init_state(base, shard)
    ref, _ = ttrainer.lda_iteration(base, shard, s0)
    got, _ = ttrainer.lda_iteration(dataclasses.replace(
        base, compressed_sync=True, sync_overlap=True), shard, s0)
    assert torch.equal(ref.z, got.z) and torch.equal(ref.phi_vk, got.phi_vk)


# ---------------------------------------------------------------------------
# fit, checkpoints, the carried-across state
# ---------------------------------------------------------------------------
def convergence_case():
    corpus = jsyn.lda_corpus(num_docs=40, num_words=96, num_topics=8,
                             avg_doc_len=36, seed=1)
    kw = dict(num_topics=8, tile_tokens=32, tiles_per_step=8)
    return corpus, jtrainer.LDAConfig(**kw), ttrainer.LDAConfig(**kw)


def test_fit_tracks_jax_fit():
    """Mean final LL/token over three seeds within 0.15 nats: a single
    chain of either package can settle in another local mode (seed 1 here
    differs by ~0.3 between the packages)."""
    import dataclasses

    corpus, jcfg, tcfg = convergence_case()
    js, ts = [], []
    for seed in range(3):
        js.append(jfit(corpus, dataclasses.replace(jcfg, seed=seed), 20,
                       eval_every=20))
        ts.append(tfit(as_port(corpus), dataclasses.replace(tcfg, seed=seed),
                       20, device="cpu", eval_every=5))
    j_ll = np.mean([r.ll_per_token[-1] for r in js])
    t_ll = np.mean([r.ll_per_token[-1] for r in ts])
    assert abs(t_ll - j_ll) < 0.15, (t_ll, j_ll)
    t = ts[0]
    assert len(t.ll_per_token) == 4 and len(t.tokens_per_sec) == 20
    assert t.ll_per_token[-1] > t.ll_per_token[0] + 0.3
    assert t.cfg.ell_capacity == js[0].cfg.ell_capacity
    assert t.compile_sec > 0 and len(t.stats) == 20


def test_fit_telemetry_and_metrics_rows(tmp_path):
    import json

    from repro_torch.obs import Observability

    corpus, _, tcfg = convergence_case()
    obs = Observability.default(trace=True)
    out = tmp_path / "rows.jsonl"
    res = tfit(as_port(corpus), tcfg, 3, device="cpu", obs=obs,
               metrics_out=str(out), eval_every=2)
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [0, 1, 2]
    assert rows[0]["ll_per_token"] is None and rows[1]["ll_per_token"]
    spans = [e for e in obs.tracer.to_chrome()["traceEvents"]
             if e["ph"] == "X"]
    assert {"compile", "sample", "eval"} <= {e["name"] for e in spans}

    def inside(outer):      # the spans that lie within each ``outer`` span
        return [[e["name"] for e in spans if e["name"].startswith("lda.")
                 and o["ts"] <= e["ts"] and e["ts"] + e["dur"]
                 <= o["ts"] + o["dur"]]
                for o in spans if o["name"] == outer]

    # every step's phases inside its sample span, the likelihood's in eval
    samples = inside("sample")
    assert len(samples) == 3
    for names in samples:
        assert names.count("lda.step") == 1
        assert {"lda.uniforms", "lda.theta", "lda.ell", "lda.sweep",
                "lda.advance", "lda.sync"} <= set(names)
    assert inside("eval") == [["lda.ll"], ["lda.ll"]]
    assert len(res.ll_per_token) == 2


def test_checkpoint_jax_to_port(tmp_path, capsys):
    corpus, jcfg, tcfg = convergence_case()
    j = jfit(corpus, jcfg, 3, eval_every=3, checkpoint_dir=str(tmp_path),
             checkpoint_every=3)
    tshard = tcorpus.tile_corpus(as_port(corpus), 1, 32)[0]
    it, z, _ = tckpt.CheckpointManager(str(tmp_path)).latest()
    assert it == 3
    st = ttrainer.state_from_numpy(
        ttrainer.resolve_config(tcfg, as_port(corpus)), tshard,
        tckpt.scatter_canonical_z(z, tshard.token_uid), it)
    np.testing.assert_array_equal(st.phi_vk.numpy(), np.asarray(j.state.phi_vk))
    res = tfit(as_port(corpus), tcfg, 5, device="cpu", eval_every=5,
               checkpoint_dir=str(tmp_path))
    assert "[resume] iteration 3" in capsys.readouterr().out
    assert len(res.tokens_per_sec) == 2 and res.state.iteration == 5


def test_checkpoint_port_to_jax(tmp_path, capsys):
    corpus, jcfg, tcfg = convergence_case()
    t = tfit(as_port(corpus), tcfg, 3, device="cpu", eval_every=3,
             checkpoint_dir=str(tmp_path), checkpoint_every=3)
    jshard = jcorpus.tile_corpus(corpus, 1, 32)[0]
    it, z, meta = jckpt.CheckpointManager(str(tmp_path)).latest()
    assert it == 3 and meta["fingerprint"] == jckpt.corpus_fingerprint(corpus)
    js = jtrainer.state_from_z(
        jcfg, jshard,
        jnp.asarray(jckpt.scatter_canonical_z(z, jshard.token_uid)
                    ).astype(jcfg.topic_dtype), it)
    np.testing.assert_array_equal(np.asarray(js.phi_vk), t.state.phi_vk.numpy())
    res = jfit(corpus, jcfg, 5, eval_every=5, checkpoint_dir=str(tmp_path))
    assert "[resume] iteration 3" in capsys.readouterr().out
    assert len(res.tokens_per_sec) == 2


def test_fingerprint_and_canonical_z_match_jax():
    corpus = corpus_of("zipf")
    assert (tckpt.corpus_fingerprint(as_port(corpus))
            == jckpt.corpus_fingerprint(corpus))
    jshard = jcorpus.tile_corpus(corpus, 1, 16)[0]
    tshard = tcorpus.tile_corpus(as_port(corpus), 1, 16)[0]
    rng = np.random.default_rng(0)
    zc = rng.integers(0, 50, corpus.num_tokens).astype(np.int16)
    jt = jckpt.scatter_canonical_z(zc, jshard.token_uid)
    tt = tckpt.scatter_canonical_z(zc, tshard.token_uid)
    np.testing.assert_array_equal(jt, tt)
    back = tckpt.gather_canonical_z(torch.from_numpy(tt), tshard.token_uid,
                                    corpus.num_tokens)
    np.testing.assert_array_equal(back, zc)


def test_state_from_numpy_gives_jax_log_likelihood():
    corpus, jcfg, tcfg = convergence_case()
    j = jfit(corpus, jcfg, 4, eval_every=4)
    jshard = jcorpus.tile_corpus(corpus, 1, 32)[0]
    tshard = tcorpus.tile_corpus(as_port(corpus), 1, 32)[0]
    tcfg = ttrainer.resolve_config(tcfg, as_port(corpus))
    st = ttrainer.state_from_numpy(tcfg, tshard, np.asarray(j.state.z), 4,
                                   phi=np.asarray(j.state.phi_vk),
                                   phi_sum=np.asarray(j.state.phi_sum))
    np.testing.assert_allclose(
        float(ttrainer.log_likelihood(tcfg, tshard, st)),
        float(jtrainer.log_likelihood(j.cfg, jshard, j.state)), rtol=1e-5)
    bad = np.asarray(j.state.phi_vk).copy()
    bad[0, 0] += 1
    with pytest.raises(ValueError, match="phi"):
        ttrainer.state_from_numpy(tcfg, tshard, np.asarray(j.state.z), 4,
                                  phi=bad)


def test_checkpoint_manager_gc_and_snapshots(tmp_path):
    from repro_torch.serve import assemble_sharded_snapshot, load_snapshot

    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for it in (1, 2, 3):
        mgr.save(it, np.full(5, it, np.int16), {"fingerprint": "x"})
    assert mgr.list_steps() == [2, 3]
    it, z, meta = mgr.latest()
    assert it == 3 and (z == 3).all() and meta["iteration"] == 3
    corpus, _, tcfg = convergence_case()
    res = tfit(as_port(corpus), tcfg, 2, device="cpu", eval_every=2)
    path = mgr.publish_snapshot(res.state, 0.1, 0.01, num_words_total=96)
    assert path.endswith("snapshot_00000002.npz")
    assert mgr.latest_snapshot_path() == path
    snap = load_snapshot(path, device="cpu")
    assert torch.equal(snap.phi_vk, res.state.phi_vk)
    sharded = mgr.publish_snapshot(res.state, 0.1, 0.01, shards=2)
    assert sharded.endswith("snapshot_00000002.sharded")
    assert mgr.latest_snapshot_path() == sharded and os.path.exists(path)
    back = assemble_sharded_snapshot(sharded, device="cpu")
    assert torch.equal(back.phi_vk, res.state.phi_vk)


# ---------------------------------------------------------------------------
# configuration, launchers
# ---------------------------------------------------------------------------
def test_lda_config_validation():
    with pytest.raises(ValueError, match="'sq'"):
        ttrainer.LDAConfig(sampler="pallas")
    with pytest.raises(ValueError, match="unknown sampler"):
        ttrainer.LDAConfig(sampler="gibbs")
    with pytest.raises(ValueError, match="does not fit"):
        ttrainer.LDAConfig(num_topics=40_000)
    with pytest.raises(ValueError, match="integer dtype"):
        ttrainer.LDAConfig(topic_dtype=torch.float32)
    assert ttrainer.LDAConfig(num_topics=32768).num_topics == 32768
    assert ttrainer.LDAConfig(num_topics=40_000,
                              topic_dtype=torch.int32).num_topics == 40_000
    assert ttrainer.LDAConfig(num_topics=64).resolved_alpha() == 50.0 / 64


def test_nytimes_config_matches_jax():
    from repro.configs import lda_nytimes as jny
    from repro_torch.configs import lda_nytimes as tny

    for f in ("num_topics", "beta", "tile_tokens", "tiles_per_step",
              "micro_chunks", "sampler", "seed"):
        assert getattr(jny.CONFIG, f) == getattr(tny.CONFIG, f), f
    assert jny.FULL == tny.FULL
    np.testing.assert_array_equal(jny.scaled(0.0005).word_ids,
                                  tny.scaled(0.0005).word_ids)


@pytest.mark.parametrize("flags,refusal", [
    (["--workload", "lm", "--arch", "qwen3-4b", "--host-devices", "2"], None),
    (["--workload", "lm", "--arch", "qwen3-moe-30b-a3b", "--host-devices",
      "2"], None),
    (["--workload", "lm", "--arch", "qwen3-4b", "--host-devices", "3"],
     "use an even count"),
    (["--workload", "lm", "--arch", "qwen3-4b"], None),
    (["--mode", "2d"], None),
    (["--host-devices", "2", "--mode", "2d", "--compressed-sync"], None),
    (["--distributed"], None)])
def test_launch_train_refuses_mesh_flags(flags, refusal, tmp_path, capfd):
    """--workload lm trains on one device and over the reference's (1, 2)
    mesh of 2 spawned gloo ranks, a MoE arch there through its
    expert-parallel MoE; an odd rank count is refused (the (1, 2) mesh
    would not cover 3 ranks); the LDA mesh flags train:
    --mode 2d alone on one device (as the reference does), --host-devices
    as spawned gloo ranks, --distributed from a 1-rank torchrun environment
    with a file store (in a process of its own: no process group in the
    test's)."""
    import subprocess
    import sys

    from repro_torch.launch import train

    tiny = ["--device", "cpu", "--iters", "2", "--topics", "8", "--scale",
            "0.0001", "--ckpt-dir", str(tmp_path / "c"), "--ckpt-every", "1"]
    if refusal:
        assert train.main(flags + ["--device", "cpu"]) != 0
        assert refusal in capfd.readouterr().err
        return
    if "lm" in flags:
        assert train.main(flags + ["--device", "cpu", "--iters", "2"]) == 0
        out = capfd.readouterr().out
        where = ("a (1, 2) mesh of 2 cpu ranks" if "--host-devices" in flags
                 else "cpu")
        arch = flags[flags.index("--arch") + 1]
        assert f"[done] {arch}-smoke on {where}: 2 steps" in out
        assert out.count("[done]") == 1      # rank 0 alone reports
        loss = float(out.split("final loss ")[1].split(",")[0])
        assert np.isfinite(loss) and loss > 0.5
        return
    if flags == ["--distributed"]:
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                           "src"))
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *flags,
             "--init-method", f"file://{tmp_path / 'store'}", *tiny],
            capture_output=True, text=True, env=env, timeout=300)
        assert res.returncode == 0, res.stderr
        out = res.stdout
        assert "[done] 1 ranks (1d, int32 sync)" in out
    else:
        assert train.main(flags + tiny) == 0
        out = capfd.readouterr().out
        assert "[done]" in out
        if "--host-devices" in flags:
            assert "[done] 2 ranks (2d, int16 bytes sync)" in out
    assert tckpt.CheckpointManager(str(tmp_path / "c")).list_steps() == [1, 2]


def test_launch_train_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    rc = train.main(["--device", "cpu", "--iters", "2", "--topics", "16",
                     "--scale", "0.0002", "--ckpt-dir", str(tmp_path),
                     "--ckpt-every", "1",
                     "--metrics-out", str(tmp_path / "m.jsonl")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "LL/token" in out and "[done] cpu" in out
    assert tckpt.CheckpointManager(str(tmp_path)).list_steps() == [1, 2]


def test_serve_bench_trains_and_hot_swaps(tmp_path, capsys):
    from repro_torch.launch import serve_lda
    from repro_torch.serve import load_snapshot

    path = str(tmp_path / "trained.npz")
    rc = serve_lda.main(["--snapshot", path, "--bench", "--device", "cpu",
                         "--train-iters", "5", "--bench-docs", "16",
                         "--burn-in", "4", "--samples", "2",
                         "--max-batch", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "training a K=32 synthetic model (5 iters)" in out
    assert "training 20 iters for the v2 snapshot" in out
    assert "hot-swapped to model_version=2" in out
    snap = load_snapshot(path, device="cpu")
    assert snap.meta["iteration"] == 20 and snap.num_words == 400
    assert snap.num_topics == 32 and "planted_seed" not in snap.meta
