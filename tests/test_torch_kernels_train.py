"""The port's training kernels' plain versions (repro_torch.kernels.lda_sample,
repro_torch.kernels.phi_update) and sweeps (repro_torch.core.sampler,
dense_sampler) held against the JAX package on the same numpy inputs.

Randomness is data: the sweep uniforms are drawn with
``repro.core.sampler.draw_sweep_uniforms`` (and the dense sweep's with its
per-tile key split) and handed to both packages.  Tolerances:

* counts (phi delta, phi rebuild) are exact;
* draws are exact at K <= 256; at K = 1024 the two frameworks' float32
  cumsums sum in another order (fault F2) and may flip a boundary draw:
  at most 1e-4 of real tokens;
* sweep statistics (sparse share, mean S/(S+Q)) within 1e-6 absolute when
  the draws are exact.

The JAX kernels run as the JAX package's own tests run them on the CPU:
the Pallas kernels in interpret mode, and their jnp oracles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dense_sampler as jdense
from repro.core import sampler as jsampler
from repro.core import updates as jupdates
from repro.core.corpus import ell_capacity, tile_corpus
from repro.data.synthetic import lda_corpus
from repro.kernels.lda_sample import ops as jlda_ops
from repro.kernels.lda_sample import ref as jlda_ref
from repro.kernels.phi_update import ops as jphi_ops
from repro_torch.core import dense_sampler as tdense
from repro_torch.core import sampler as tsampler
from repro_torch.core import updates as tupdates
from repro_torch.kernels.lda_sample import ops as tlda_ops
from repro_torch.kernels.lda_sample import ref as tlda_ref
from repro_torch.kernels.phi_update import ops as tphi_ops
from repro_torch.kernels.phi_update import ref as tphi_ref

FLIP_BOUND = 1e-4


def sweep_case(K, tile_tokens=32, num_docs=40, num_words=60, seed=0,
               avg_doc_len=40):
    """A tiled corpus with random z, its counts, ELL and one sweep's
    uniforms — numpy arrays (the counts made with numpy, the ELL in
    ``lax.top_k`` order)."""
    corpus = lda_corpus(num_docs=num_docs, num_words=num_words, num_topics=4,
                        avg_doc_len=avg_doc_len, seed=seed)
    shard = tile_corpus(corpus, 1, tile_tokens)[0]
    tw, td, tm = (np.asarray(shard.tile_word), np.asarray(shard.token_doc),
                  np.asarray(shard.token_mask))
    n, t = td.shape
    rng = np.random.default_rng(seed)
    z = rng.integers(0, K, (n, t)).astype(np.int16)
    phi = np.zeros((corpus.num_words, K), np.int32)
    np.add.at(phi, (np.broadcast_to(tw[:, None], (n, t))[tm], z[tm]), 1)
    theta = np.zeros((shard.num_docs_local, K), np.int32)
    np.add.at(theta, (td[tm], z[tm]), 1)
    cnts, tpcs = tupdates.ell_topk(torch.from_numpy(theta),
                                   ell_capacity(corpus, K))
    key = jax.random.key(seed)
    arrays = dict(tile_word=tw, token_doc=td, token_mask=tm, z=z, phi=phi,
                  phi_sum=phi.sum(0).astype(np.int32), cnts=cnts.numpy(),
                  tpcs=tpcs.numpy(),
                  uniforms=np.asarray(jsampler.draw_sweep_uniforms(key, n, t)))
    kw = dict(alpha=50.0 / K, beta=0.01, num_words_total=corpus.num_words)
    return {k: np.array(v) for k, v in arrays.items()}, kw, key


def port_args(a):
    """The port kernel's argument order, as CPU tensors."""
    T = torch.from_numpy
    return (T(a["tile_word"]), T(a["token_doc"]), T(a["token_mask"]),
            T(a["z"]), T(a["phi"]), T(a["phi_sum"]), T(a["cnts"]),
            T(a["tpcs"]), T(a["uniforms"]))


def assert_draws(jz, tz, mask, K):
    jz, tz = np.asarray(jz).astype(np.int64), tz.numpy().astype(np.int64)
    flips = int(((jz != tz) & mask).sum())
    if K <= 256:
        assert flips == 0
    else:
        assert flips <= FLIP_BOUND * mask.sum() + 1, flips
    return flips


# K = 96: 32-wide search blocks (nb = 3); 256: 128-wide (nb = 2); 1024: nb = 8
@pytest.mark.parametrize("K", [96, 256, 1024])
def test_plain_k1_matches_jax_oracle(K):
    a, kw, _ = sweep_case(K, seed=K)
    j = jlda_ref.lda_sample_tiles_ref(
        jnp.asarray(a["tile_word"]), jnp.asarray(a["token_doc"]),
        jnp.asarray(a["phi"]), jnp.asarray(a["phi_sum"]),
        jnp.asarray(a["cnts"]), jnp.asarray(a["tpcs"]),
        jnp.asarray(a["uniforms"]), jnp.asarray(a["token_mask"], jnp.int32),
        jnp.asarray(a["z"], jnp.int32), **kw)
    t = tlda_ref.lda_sample_tiles_ref(*port_args(a), tiles_per_step=7, **kw)
    mask = a["token_mask"]
    assert_draws(j[0], t[0], mask, K)
    if K <= 256:
        np.testing.assert_array_equal(np.asarray(j[1]) != 0, t[1].numpy())
        np.testing.assert_allclose(np.asarray(j[2]), t[2].numpy(),
                                   rtol=1e-5, atol=1e-7)
    # padding slots keep z and report nothing
    assert (t[0].numpy()[~mask] == a["z"][~mask]).all()
    assert not t[1].numpy()[~mask].any()


@pytest.mark.parametrize("K", [128, 256])
def test_plain_k1_matches_pallas_interpret(K):
    a, kw, key = sweep_case(K, tile_tokens=16, num_docs=24, num_words=48,
                            seed=3)
    jz, js = jlda_ops.lda_sample(
        *(jnp.asarray(a[k]) for k in ("tile_word", "token_doc", "token_mask",
                                      "z", "phi", "phi_sum", "cnts", "tpcs")),
        key, impl="pallas", interpret=True, tiles_per_step=8, **kw)
    tz, ts = tlda_ops.lda_sample(*port_args(a), **kw)
    assert_draws(jz, tz, a["token_mask"], K)
    assert tz.dtype == torch.int16
    assert abs(float(js.sparse_frac) - float(ts.sparse_frac)) < 1e-6
    assert abs(float(js.mean_s_over_sq) - float(ts.mean_s_over_sq)) < 1e-6


@pytest.mark.parametrize("K", [96, 1024])
def test_sample_sweep_matches_jax(K):
    a, kw, key = sweep_case(K, seed=11)
    jz, js = jsampler.sample_sweep(
        *(jnp.asarray(a[k]) for k in ("phi", "phi_sum", "tile_word",
                                      "token_doc", "token_mask", "z", "cnts",
                                      "tpcs")), key, tiles_per_step=8, **kw)
    T = torch.from_numpy
    tz, ts = tsampler.sample_sweep(
        *(T(a[k]) for k in ("phi", "phi_sum", "tile_word", "token_doc",
                            "token_mask", "z", "cnts", "tpcs", "uniforms")),
        tiles_per_step=5, **kw)
    flips = assert_draws(jz, tz, a["token_mask"], K)
    if flips == 0:
        assert abs(float(js.sparse_frac) - float(ts.sparse_frac)) < 1e-6
        assert abs(float(js.mean_s_over_sq) - float(ts.mean_s_over_sq)) < 1e-6
    # the trainer's int16 ELL (C7) gives the same sweep
    tz16, ts16 = tsampler.sample_sweep(
        *(T(a[k]) for k in ("phi", "phi_sum", "tile_word", "token_doc",
                            "token_mask", "z")),
        T(a["cnts"].astype(np.int16)), T(a["tpcs"].astype(np.int16)),
        T(a["uniforms"]), tiles_per_step=5, **kw)
    assert torch.equal(tz, tz16) and torch.equal(ts.sparse_frac,
                                                 ts16.sparse_frac)


@pytest.mark.parametrize("K", [96, 1024])
def test_plain_k1_same_with_int16_and_int32_ell(K):
    """The plain K1 reads the ELL in either stored type (C7) and gives
    identical outputs."""
    a, kw, _ = sweep_case(K, seed=K + 2)
    args = port_args(a)
    narrow = args[:6] + (args[6].to(torch.int16), args[7].to(torch.int16),
                         args[8])
    wide = tlda_ref.lda_sample_tiles_ref(*args, tiles_per_step=6, **kw)
    short = tlda_ref.lda_sample_tiles_ref(*narrow, tiles_per_step=6, **kw)
    for w, n in zip(wide, short):
        assert torch.equal(w, n)


def test_ops_keep_int16_ell_and_pass_live_lengths(monkeypatch):
    """``ops.lda_sample`` hands the kernel the ELL as stored (int16 is not
    widened, not even copied) with each row's live length; other integer
    types become int32.  The kernel is replaced by a recorder (no card
    here)."""
    from repro_torch.kernels.lda_sample import kernel as k1

    a, kw, _ = sweep_case(64, seed=6)
    args = port_args(a)
    cnt16, tpc16 = args[6].to(torch.int16), args[7].to(torch.int16)
    got = {}

    def record(*xs, ell_live, **kw2):
        got.update(args=xs, live=ell_live, kw=kw2)
        return tlda_ref.lda_sample_tiles_ref(*xs, **kw2)

    monkeypatch.setattr(k1, "lda_sample_tiles", record)
    prepared = tlda_ops.sweep_args(*args[:6], cnt16, tpc16, args[8])
    z, sp, ssq = tlda_ops.launch_kernel(prepared, **kw)
    assert got["args"][6].data_ptr() == cnt16.data_ptr()
    assert got["args"][7].data_ptr() == tpc16.data_ptr()
    assert got["args"][6].dtype == got["args"][7].dtype == torch.int16
    assert got["live"].dtype == torch.int32
    assert torch.equal(got["live"], (cnt16 != 0).sum(1).to(torch.int32))
    assert int(got["live"].max()) < cnt16.shape[1]     # rows with zeros
    assert torch.equal(z, tlda_ref.lda_sample_tiles_ref(*args, **kw)[0])
    wide = tlda_ops.sweep_args(*args[:6], args[6].long(), args[7].long(),
                               args[8])
    assert wide[6].dtype == wide[7].dtype == torch.int32


def test_tokens_of_one_run_share_s_share():
    """Under delayed counts S and Q depend only on the tile's word and the
    document's frozen ELL row, so every token of a run (side by side slots
    of a tile with one document) gets the same S/(S+Q) bit for bit in the
    plain version: the property the kernel's one read per run rests on."""
    a, kw, _ = sweep_case(256, seed=9, num_docs=12, avg_doc_len=60)
    td, mask = a["token_doc"], a["token_mask"]
    _, _, ssq = tlda_ref.lda_sample_tiles_ref(*port_args(a), **kw)
    ssq = ssq.numpy()
    same_run = mask[:, 1:] & mask[:, :-1] & (td[:, 1:] == td[:, :-1])
    assert same_run.sum() > 100              # the corpus has real runs
    np.testing.assert_array_equal(ssq[:, 1:][same_run], ssq[:, :-1][same_run])


def test_sample_one_tile_matches_jax():
    K = 96
    a, kw, _ = sweep_case(K, seed=4)
    i = 2
    jo = jsampler.sample_one_tile(
        jnp.asarray(a["phi"][a["tile_word"][i]]), jnp.asarray(a["phi_sum"]),
        jnp.asarray(a["token_doc"][i]), jnp.asarray(a["token_mask"][i]),
        jnp.asarray(a["z"][i]), jnp.asarray(a["cnts"]),
        jnp.asarray(a["tpcs"]), jnp.asarray(a["uniforms"][i]), **kw)
    T = torch.from_numpy
    to = tsampler.sample_one_tile(
        T(a["phi"][a["tile_word"][i]]), T(a["phi_sum"]), T(a["token_doc"][i]),
        T(a["token_mask"][i]), T(a["z"][i]), T(a["cnts"]), T(a["tpcs"]),
        T(a["uniforms"][i]), **kw)
    for j, t in zip(jo, to):
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-6)


@pytest.mark.parametrize("K", [16, 96])
def test_dense_sweep_matches_jax(K):
    a, kw, key = sweep_case(K, seed=21)
    theta = jupdates.theta_from_z(
        jnp.asarray(a["z"]), jnp.asarray(a["token_doc"]),
        jnp.asarray(a["token_mask"]), int(a["token_doc"].max()) + 1, K)
    jz = jdense.sample_sweep_dense(
        *(jnp.asarray(a[k]) for k in ("phi", "phi_sum", "tile_word",
                                      "token_doc", "token_mask", "z")),
        theta, key, tiles_per_step=4, **kw)
    n, t = a["z"].shape
    uni = jax.vmap(lambda k: jdense.tile_uniforms_dense(k, t))(
        jax.random.split(key, n))
    T = torch.from_numpy
    tz = tdense.sample_sweep_dense(
        *(T(a[k]) for k in ("phi", "phi_sum", "tile_word", "token_doc",
                            "token_mask", "z")),
        T(np.asarray(theta)), T(np.asarray(uni)), tiles_per_step=3, **kw)
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())


def test_sample_one_tile_dense_matches_jax():
    K = 24
    a, kw, key = sweep_case(K, seed=8)
    i, t = 3, a["z"].shape[1]
    theta = np.zeros((int(a["token_doc"].max()) + 1, K), np.int32)
    m = a["token_mask"]
    np.add.at(theta, (a["token_doc"][m], a["z"][m]), 1)
    u = np.asarray(jdense.tile_uniforms_dense(key, t))
    jz = jdense.sample_one_tile_dense(
        jnp.asarray(a["phi"][a["tile_word"][i]]), jnp.asarray(a["phi_sum"]),
        jnp.asarray(a["token_doc"][i]), jnp.asarray(m[i]),
        jnp.asarray(a["z"][i]), jnp.asarray(theta), jnp.asarray(u), **kw)
    T = torch.from_numpy
    tz = tdense.sample_one_tile_dense(
        T(a["phi"][a["tile_word"][i]]), T(a["phi_sum"]), T(a["token_doc"][i]),
        T(m[i]), T(a["z"][i]), T(theta), T(u), **kw)
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())


def test_generator_draws_are_reproducible():
    a, kw, _ = sweep_case(64, seed=5)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        outs.append(tlda_ops.lda_sample(*port_args(a)[:8], g, **kw)[0])
    assert torch.equal(*outs)


@pytest.mark.parametrize("K", [64, 256])
def test_plain_k2_k4_match_pallas_interpret(K):
    a, _, _ = sweep_case(K, tile_tokens=16, seed=K + 1)
    rng = np.random.default_rng(K)
    z_new = rng.integers(0, K, a["z"].shape).astype(np.int16)
    V = 60 + 5                          # rows no tile visits stay zero
    first = np.r_[True, np.diff(a["tile_word"]) != 0]
    J = jnp.asarray
    jd = jphi_ops.phi_delta(J(a["tile_word"]), J(first), J(a["z"]),
                            J(z_new), J(a["token_mask"]), num_words=V,
                            num_topics=K, impl="pallas", interpret=True)
    ju = jphi_ops.phi_update(J(a["tile_word"]), J(first), J(z_new),
                             J(a["token_mask"]), num_words=V, num_topics=K,
                             impl="pallas", interpret=True)
    T = torch.from_numpy
    td = tphi_ops.phi_delta(T(a["tile_word"]), T(first), T(a["z"]),
                            T(z_new), T(a["token_mask"]), num_words=V,
                            num_topics=K)
    tu = tphi_ops.phi_update(T(a["tile_word"]), T(first), T(z_new),
                             T(a["token_mask"]), num_words=V, num_topics=K)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    assert td.dtype == tu.dtype == torch.int32
    assert int(tu[60:].abs().sum()) == 0
    old = tphi_ref.phi_update_tiles_ref(T(a["tile_word"]), None, T(a["z"]),
                                        T(a["token_mask"]), V, K)
    assert torch.equal(old + td, tu)


def test_padding_tiles_add_nothing():
    """Padding tiles alias the last word with tile_first False and an empty
    mask (core.corpus.tile_shard): the count kernels' plain versions add
    nothing for them, as the Pallas kernels do."""
    from repro_torch.core.corpus import Corpus as TCorpus
    from repro_torch.core.corpus import tile_shard

    corpus = lda_corpus(num_docs=12, num_words=20, num_topics=3,
                        avg_doc_len=15, seed=2)
    tc = TCorpus(corpus.doc_ids, corpus.word_ids, corpus.num_docs,
                 corpus.num_words)
    s = tile_shard(tc, np.arange(12), tile_tokens=8)
    sp = tile_shard(tc, np.arange(12), tile_tokens=8,
                    pad_tiles_to=s.tile_word.shape[0] + 5)
    z = torch.randint(0, 8, tuple(sp.token_doc.shape), dtype=torch.int16,
                      generator=torch.Generator().manual_seed(0))
    n = s.tile_word.shape[0]
    full = tphi_ops.phi_update(sp.tile_word, sp.tile_first, z, sp.token_mask,
                               num_words=20, num_topics=8)
    part = tphi_ops.phi_update(s.tile_word, s.tile_first, z[:n],
                               s.token_mask, num_words=20, num_topics=8)
    assert torch.equal(full, part)
    assert not sp.tile_first[n:].any()
    assert (sp.tile_word[n:] == sp.tile_word[n - 1]).all()


def test_ops_run_plain_versions_on_cpu_tensors():
    """The ops dispatch on the tensors' device alone: CPU tensors give the
    plain versions' results and launch no kernel."""
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.phi_update import kernel as k24

    a, kw, _ = sweep_case(32, seed=1)
    args = port_args(a)
    before = (k1.lda_sample_tiles.launches, k24.phi_delta_tiles.launches,
              k24.phi_update_tiles.launches)
    z, stats = tlda_ops.lda_sample(*args, **kw)
    zr, _, _ = tlda_ref.lda_sample_tiles_ref(*args, **kw)
    assert torch.equal(z, zr.to(z.dtype)) and z.device.type == "cpu"
    d = tphi_ops.phi_delta(args[0], None, args[3], z, args[2], num_words=60,
                           num_topics=32)
    assert torch.equal(d, tphi_ref.phi_delta_tiles_ref(
        args[0], None, z, args[3], args[2], 60, 32))
    u = tphi_ops.phi_update(args[0], None, z, args[2], num_words=60,
                            num_topics=32)
    assert torch.equal(u, tphi_ref.phi_update_tiles_ref(
        args[0], None, z, args[2], 60, 32))
    assert (k1.lda_sample_tiles.launches, k24.phi_delta_tiles.launches,
            k24.phi_update_tiles.launches) == before


def segments_by_walk(tile_word, tile_first, max_tiles):
    """The segment table by a walk over the tiles: a new segment where the
    word changes, tile_first is set, or the segment is full."""
    rows = []
    for i, (w, f) in enumerate(zip(tile_word, tile_first)):
        if rows and not f and rows[-1][2] == w and rows[-1][1] < max_tiles:
            rows[-1][1] += 1
        else:
            rows.append([i, 1, int(w), 0])
    owned = np.bincount([r[2] for r in rows])
    for r in rows:
        r[3] = int(owned[r[2]] == 1)
    return np.asarray(rows, np.int32).reshape(-1, 4)


@pytest.mark.parametrize("max_tiles", [1, 3, 16])
def test_segment_table_matches_reference_tiling(max_tiles):
    """K2's segment table on the JAX package's tiling of a Zipf corpus
    padded with pad_tiles_to: heavy words span several segments, most
    words one, and the padding tiles (the last word, tile_first False, an
    all-false mask) join the last word's run."""
    from repro.core.corpus import tile_shard as jtile_shard
    from repro.data.synthetic import zipf_corpus

    corpus = zipf_corpus(num_docs=60, num_words=200, avg_doc_len=50, seed=3)
    n = jtile_shard(corpus, np.arange(60), 8).tile_word.shape[0]
    sh = jtile_shard(corpus, np.arange(60), 8, pad_tiles_to=n + 7)
    tw, tf = np.array(sh.tile_word), np.array(sh.tile_first)
    assert not tf[n:].any() and (tw[n:] == tw[n - 1]).all()
    seg = tphi_ops.segment_table(torch.from_numpy(tw), torch.from_numpy(tf),
                                 max_tiles)
    assert seg.dtype == torch.int32 and seg.is_contiguous()
    np.testing.assert_array_equal(seg.numpy(),
                                  segments_by_walk(tw, tf, max_tiles))
    first, tiles, word, sole = seg.numpy().T
    covered = np.concatenate([np.arange(f, f + c) for f, c in
                              zip(first, tiles)])
    np.testing.assert_array_equal(covered, np.arange(n + 7))
    assert (tiles <= max_tiles).all()
    assert (tw[covered] == np.repeat(word, tiles)).all()
    if max_tiles == 16:   # the heaviest word spans several segments
        assert (word == tw[0]).sum() > 1 and not sole[word == tw[0]].any()
        assert sole.sum() > len(seg) // 2


def test_segment_table_cuts_where_the_word_changes():
    """A word whose tiles are not contiguous owns two segments (so neither
    is sole), as does a run that tile_first splits; an empty tiling gives
    an empty table."""
    tw = torch.tensor([4, 4, 2, 4, 7, 7, 7, 9], dtype=torch.int32)
    tf = torch.tensor([1, 0, 1, 1, 1, 0, 1, 1], dtype=torch.bool)
    seg = tphi_ops.segment_table(tw, tf, 2)
    assert seg.tolist() == [[0, 2, 4, 0], [2, 1, 2, 1], [3, 1, 4, 0],
                            [4, 2, 7, 0], [6, 1, 7, 0], [7, 1, 9, 1]]
    assert tphi_ops.segment_table(tw, None, 8).tolist() == [
        [0, 2, 4, 0], [2, 1, 2, 1], [3, 1, 4, 0], [4, 3, 7, 1],
        [7, 1, 9, 1]]
    assert tuple(tphi_ops.segment_table(tw[:0], None, 8).shape) == (0, 4)


def test_shard_keeps_its_segment_table():
    """The segment table is built once per shard (the tiling does not
    change across iterations); a CPU shard needs none, and a copy made
    by ``to`` starts without the first one's tables."""
    from repro_torch.core.corpus import Corpus as TCorpus
    from repro_torch.core.corpus import tile_shard

    corpus = lda_corpus(num_docs=12, num_words=20, num_topics=3,
                        avg_doc_len=15, seed=2)
    s = tile_shard(TCorpus(corpus.doc_ids, corpus.word_ids, corpus.num_docs,
                           corpus.num_words), np.arange(12), tile_tokens=8)
    assert tphi_ops.shard_segments(s) is None
    calls = []
    build = lambda: calls.append(1) or len(calls)  # noqa: E731
    assert s.cached("t", build) == 1 and s.cached("t", build) == 1
    assert calls == [1]
    assert s.to("cpu").cached("t", build) == 2


def rows_by_walk(tile_word, tile_first, max_tiles, num_words):
    """K4's rows to zero by a walk: every row below num_words that is not
    the word of a sole segment of ``segments_by_walk``."""
    seg = segments_by_walk(tile_word, tile_first, max_tiles)
    sole = {int(w) for w, s in zip(seg[:, 2], seg[:, 3]) if s}
    return [w for w in range(num_words) if w not in sole]


@pytest.mark.parametrize("max_tiles", [1, 3, 16])
def test_rows_to_zero_match_a_walk_on_reference_tiling(max_tiles):
    """K4's list of rows to zero on the JAX package's Zipf tiling padded
    with pad_tiles_to, for the corpus's vocabulary and for 9 rows beyond
    it: the rows of words over several segments and the rows that no tile
    visits, nothing else."""
    from repro.core.corpus import tile_shard as jtile_shard
    from repro.data.synthetic import zipf_corpus

    corpus = zipf_corpus(num_docs=60, num_words=200, avg_doc_len=50, seed=3)
    n = jtile_shard(corpus, np.arange(60), 8).tile_word.shape[0]
    sh = jtile_shard(corpus, np.arange(60), 8, pad_tiles_to=n + 7)
    tw, tf = np.array(sh.tile_word), np.array(sh.tile_first)
    seg = tphi_ops.segment_table(torch.from_numpy(tw), torch.from_numpy(tf),
                                 max_tiles)
    for V in (corpus.num_words, corpus.num_words + 9):
        rows = tphi_ops.rows_to_zero(seg, V)
        assert rows.dtype == torch.int32
        assert rows.tolist() == rows_by_walk(tw, tf, max_tiles, V)
    assert 0 < int(rows.shape[0]) < V
    if max_tiles == 1:       # every word with two tiles or more is zeroed
        assert int(tw[0]) in rows.tolist()


def test_rows_to_zero_non_contiguous_word():
    """A word whose tiles are not contiguous owns two segments, so its row
    is zeroed and added into; a run that tile_first splits likewise; rows
    of words with no tile are zeroed."""
    tw = torch.tensor([4, 4, 2, 4, 7, 7, 7, 9], dtype=torch.int32)
    tf = torch.tensor([1, 0, 1, 1, 1, 0, 1, 1], dtype=torch.bool)
    seg = tphi_ops.segment_table(tw, tf, 8)
    assert tphi_ops.rows_to_zero(seg, 11).tolist() == [0, 1, 3, 4, 5, 6, 7,
                                                       8, 10]
    assert tphi_ops.rows_to_zero(seg, 11).tolist() == rows_by_walk(
        tw.numpy(), tf.numpy(), 8, 11)
    seg = tphi_ops.segment_table(tw, None, 8)
    assert tphi_ops.rows_to_zero(seg, 10).tolist() == [0, 1, 3, 4, 5, 6, 8]
    assert tphi_ops.rows_to_zero(seg[:0], 3).tolist() == [0, 1, 2]


def k4_plan(tile_word, tile_first, z, token_mask, num_words, num_topics,
            max_tiles):
    """K4's ownership plan in plain PyTorch: an output last filled with -1,
    the listed rows zeroed, each sole segment's row written whole from its
    tokens' bincount, the other segments' counts added."""
    seg = tphi_ops.segment_table(tile_word, tile_first, max_tiles)
    out = torch.full((num_words, num_topics), -1, dtype=torch.int32)
    out[tphi_ops.rows_to_zero(seg, num_words).long()] = 0
    for first, tiles, word, sole in seg.tolist():
        sl = slice(first, first + tiles)
        counts = torch.bincount(z[sl][token_mask[sl]].long(),
                                minlength=num_topics).to(torch.int32)
        if sole:
            out[word] = counts
        else:
            out[word] += counts
    return out


@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("max_tiles", [1, 4])
def test_k4_plan_matches_pallas_interpret(K, max_tiles):
    """K4's plan (rows written whole by their sole segment, the others
    zeroed and added into) equals the Pallas K4 in interpret mode on the
    same numpy inputs, padding tiles and rows beyond the vocabulary
    included."""
    from repro.core.corpus import tile_shard as jtile_shard
    from repro.data.synthetic import zipf_corpus

    corpus = zipf_corpus(num_docs=40, num_words=80, avg_doc_len=40, seed=K)
    n = jtile_shard(corpus, np.arange(40), 16).tile_word.shape[0]
    sh = jtile_shard(corpus, np.arange(40), 16, pad_tiles_to=n + 3)
    tw, tf, tm = (np.array(sh.tile_word), np.array(sh.tile_first),
                  np.array(sh.token_mask))
    z = np.random.default_rng(K).integers(0, K, tm.shape).astype(np.int16)
    V = corpus.num_words + 4
    J, T = jnp.asarray, torch.from_numpy
    ju = jphi_ops.phi_update(J(tw), J(tf), J(z), J(tm), num_words=V,
                             num_topics=K, impl="pallas", interpret=True)
    plan = k4_plan(T(tw), T(tf), T(z), T(tm), V, K, max_tiles)
    np.testing.assert_array_equal(np.asarray(ju), plan.numpy())
    sole = tphi_ops.segment_table(T(tw), T(tf), max_tiles)[:, 3]
    assert bool((sole == 1).any()) and bool((sole == 0).any())
