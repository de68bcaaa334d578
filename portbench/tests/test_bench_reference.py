"""The plain reference against the port's plain CPU path at a tiny size:
the same counts, ELL, draws, uniforms and log-likelihood."""
import math

import numpy as np
import pytest
import torch

from portbench import corpus as gen
from portbench.reference import lda as ref
from repro_torch.core import trainer, updates
from repro_torch.core.corpus import Corpus, tile_corpus

D, V, L, K, SEED = 200, 300, 30, 64, 2**33 + 11
ALPHA, BETA = 50 / K, 0.01     # handed to both sides alike


@pytest.fixture(scope="module")
def setup():
    doc, word = gen.zipf_corpus(D, V, L, 1.1, SEED, "cpu")
    corpus = Corpus(doc.numpy(), word.numpy(), D, V)
    cfg = trainer.resolve_config(
        trainer.LDAConfig(num_topics=K, alpha=ALPHA, beta=BETA, seed=SEED),
        corpus)
    shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0]
    state = trainer.init_state(cfg, shard)
    for _ in range(3):
        state, _ = trainer.lda_iteration(cfg, shard, state)
    mask = shard.token_mask
    order = torch.argsort(shard.token_uid[mask].long())
    canon = lambda a: a[mask][order]          # noqa: E731
    return dict(doc=doc, word=word, cfg=cfg, shard=shard, state=state,
                canon=canon)


def test_corpus_is_the_seeds_alone():
    a = gen.zipf_corpus(D, V, L, 1.1, SEED, "cpu")
    b = gen.zipf_corpus(D, V, L, 1.1, SEED, "cpu")
    c = gen.zipf_corpus(D, V, L, 1.1, SEED + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1][:1000], c[1][:1000])
    doc, word = a
    assert int(doc.max()) == D - 1 and int(word.max()) < V
    assert torch.all(torch.diff(doc) >= 0)
    assert abs(doc.numel() / D - L) < 3


def test_uniforms_are_the_programs(setup):
    st = setup["state"]
    n, t = st.z.shape
    assert torch.equal(
        trainer.iteration_uniforms(setup["cfg"], st),
        ref.iteration_uniforms(SEED, st.iteration, None, n, t, "cpu"))
    assert torch.equal(
        trainer.iteration_uniforms(setup["cfg"], st, rank=2),
        ref.iteration_uniforms(SEED, st.iteration, 2, n, t, "cpu"))


def test_counts_and_ell_are_the_programs(setup):
    st, shard, canon = setup["state"], setup["shard"], setup["canon"]
    z = canon(st.z)
    phi = ref.topic_word_counts(setup["word"], z, V, K)
    assert torch.equal(phi, st.phi_vk.long())
    assert torch.equal(phi.sum(0), st.phi_sum.long())
    theta, cnt, tpc, over = trainer.theta_and_ell(setup["cfg"], shard, st.z)
    rc, rt, live = ref.ell(setup["doc"], z, D, K)
    assert not over.any()
    assert torch.equal((cnt > 0).sum(1), live)
    W = rc.shape[1]
    assert torch.equal(cnt[:, :W].long(), rc)
    held = rc > 0
    assert torch.equal(tpc[:, :W].long()[held], rt[held])
    d, k, c = ref.doc_topic_pairs(setup["doc"], z, K)
    assert torch.equal(theta[d, k].long(), c) and int(theta.sum()) == z.numel()


def test_draws_are_the_programs(setup):
    st, shard, canon, cfg = (setup["state"], setup["shard"], setup["canon"],
                             setup["cfg"])
    n, t = st.z.shape
    u = ref.iteration_uniforms(SEED, st.iteration, None, n, t, "cpu")
    new, _ = trainer.lda_iteration(cfg, shard, st, u)
    z = canon(st.z)
    phi = ref.topic_word_counts(setup["word"], z, V, K)
    rc, rt, _ = ref.ell(setup["doc"], z, D, K)
    tables = ref.WordTables(phi, phi.sum(0), ALPHA, BETA, V)
    u_c = u[shard.token_mask][torch.argsort(
        shard.token_uid[shard.token_mask].long())]
    z_ref, sparse = ref.sample(tables, rc, rt, setup["word"], setup["doc"],
                               u_c, block=1000)
    z_new = canon(new.z).long()
    flipped = (z_ref != z_new).nonzero().flatten()
    assert flipped.numel() <= 1e-3 * z.numel()
    assert 0.3 < float(sparse.float().mean()) < 1
    if flipped.numel():
        m = ref.flip_margins(phi, phi.sum(0), ALPHA, BETA, V, rc, rt,
                             setup["word"][flipped],
                             setup["doc"][flipped], u_c[flipped],
                             z_new[flipped])
        assert float(m.max()) < 1e-5


def test_margin_of_a_draw_the_rule_makes_is_zero_and_of_others_not(setup):
    st = setup["state"]
    z = setup["canon"](st.z)
    phi = ref.topic_word_counts(setup["word"], z, V, K)
    rc, rt, _ = ref.ell(setup["doc"], z, D, K)
    tables = ref.WordTables(phi, phi.sum(0), ALPHA, BETA, V,
                            dtype=torch.float64)
    u = torch.rand((z.numel(), 2), generator=torch.Generator().manual_seed(1))
    z_ref, _ = ref.sample(tables, rc, rt, setup["word"], setup["doc"], u)
    args = (phi, phi.sum(0), ALPHA, BETA, V, rc, rt,
            setup["word"], setup["doc"], u)
    assert float(ref.flip_margins(*args, z_ref).max()) < 1e-12
    other = ref.flip_margins(*args, (z_ref + K // 2) % K)
    assert float(torch.median(other)) > 1e-3


def test_log_likelihood_is_the_programs(setup):
    st, shard, cfg = setup["state"], setup["shard"], setup["cfg"]
    z = setup["canon"](st.z)
    phi = ref.topic_word_counts(setup["word"], z, V, K)
    lengths = torch.bincount(setup["doc"].long(), minlength=D)
    got = float(ref.doc_log_likelihood(setup["doc"], z, lengths, K, ALPHA)
                + ref.word_log_likelihood(phi, phi.sum(0), BETA, V))
    a, b = ALPHA, BETA
    theta = updates.theta_from_z(st.z, shard.token_doc, shard.token_mask, D,
                                 K)
    plain = sum(math.lgamma(K * a) - math.lgamma(int(n) + K * a)
                for n in theta.sum(1))
    plain += sum(math.lgamma(int(c) + a) - math.lgamma(a)
                 for c in theta.flatten() if c)
    plain += sum(math.lgamma(int(c) + b) - math.lgamma(b)
                 for c in st.phi_vk.flatten() if c)
    plain += sum(math.lgamma(V * b) - math.lgamma(int(s) + V * b)
                 for s in st.phi_sum)
    assert got == pytest.approx(plain, rel=1e-12)
    prog = float(trainer.log_likelihood(cfg, shard, st))
    assert prog == pytest.approx(got, rel=1e-5)
    assert np.isfinite(got) and got < 0
