"""Tests of the port that need a CUDA card: the fold-in and training kernels
against their plain PyTorch versions on the card, the wrappers' input checks,
the engine and the trainer running through the kernels, V-sharded serving
through K3 (shards on one card, and across cards where there are two), and
training over a one-rank NCCL group (spawned, never in the test's process),
and the LM zoo's smoke architectures (serving and training, on one device
and over a one-rank NCCL (1, 1) mesh; serving over two NCCL ranks where
there are two cards), its serving and training launchers and the
prefetching loader.  Skipped without a card.  This file imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fold_in import kernel, ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fold-in kernel runs only there")
    return torch.device("cuda:0")


def case(K, dev, B=8, L=64, V=300, burn_in=3, samples=2, seed=0,
         empty_last=True, P=None):
    rng = np.random.default_rng(seed)
    phi = ((rng.random((V, K)) < 0.1)
           * rng.integers(1, 300, (V, K))).astype(np.int32)
    lens = rng.integers(1, L + 1, B)
    if empty_last:
        lens[-1] = 0                              # one all-padding doc
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    args = (phi[rng.integers(0, V, (B, L))], phi.sum(0).astype(np.int32),
            np.array([50.0 / K, 0.01], np.float32),
            rng.random((B, burn_in + samples, L, 2), dtype=np.float32), mask,
            rng.integers(0, K, (B, L)).astype(np.int32))
    kw = dict(num_words_total=V, burn_in=burn_in, samples=samples,
              ell_capacity=P or min(L, K))
    return [torch.from_numpy(a).to(dev) for a in args], kw


def assert_fold_in_equal(args, kw):
    """Kernel and plain version on the same inputs: equal theta sums,
    sparse counts and final z (no float-order boundary is hit at these
    sizes), the S-share sum within rtol 1e-5 (reduced in another order),
    zeros for an all-padding doc."""
    k = kernel.fold_in_docs(*args, **kw)
    r = ref.fold_in_docs_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])
    assert torch.equal(k[3], r[3])
    torch.testing.assert_close(k[2], r[2], rtol=1e-5, atol=0)
    empty = args[4].sum(1) == 0
    assert int(k[0][empty].abs().sum()) == 0 and int(k[1][empty].sum()) == 0


@pytest.mark.parametrize("K", [96, 256, 1024])
def test_kernel_matches_plain_version(dev, K):
    """At these sizes the draws agree exactly (no float-order boundary is
    hit), so theta sums, sparse counts and final z are equal; the S-share
    sum is reduced in another order (rtol 1e-5)."""
    args, kw = case(K, dev, seed=K)
    before = kernel.fold_in_docs.launches
    k = kernel.fold_in_docs(*args, **kw)
    assert kernel.fold_in_docs.launches == before + 1
    r = ref.fold_in_docs_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])
    assert torch.equal(k[3], r[3])
    torch.testing.assert_close(k[2], r[2], rtol=1e-5, atol=0)
    assert int(k[0][-1].abs().sum()) == 0          # padding doc: zeros


@pytest.mark.parametrize("shape", [
    dict(B=1, empty_last=False),       # one doc: one cluster
    dict(B=33),                        # more docs than 32
    dict(L=60),                        # L not a multiple of a warp
    dict(L=256, B=4),                  # the largest serving bucket
    dict(P=8),                         # P below the docs' live topics
])
def test_kernel_shapes_match_plain_version(dev, shape):
    args, kw = case(256, dev, seed=len(shape) + shape.get("B", 0)
                    + shape.get("L", 0), **shape)
    if "P" in shape:
        live = [len(set(args[5][b][args[4][b] != 0].tolist()))
                for b in range(args[5].shape[0])]
        assert max(live) > kw["ell_capacity"]
    assert_fold_in_equal(args, kw)


def test_kernel_scalar_rows_match_plain_version(dev):
    """K = 90: rows are not 16-byte vectors, and the search blocks are two
    topics wide (45 of them)."""
    args, kw = case(90, dev, seed=90)
    assert_fold_in_equal(args, kw)


def test_fold_in_draw_does_not_depend_on_bucket_or_slot(dev):
    """The same documents (tokens, z0, uniforms) at L = 64 in a batch of
    three and at L = 256 in a batch of 33, at other slots, get the same
    bits: a token's draw depends on its row, the doc's theta and its own
    uniforms, not on which CTA of the doc's cluster or which warp takes it,
    and the doc's S/(S+Q) sum is taken in token order.
    The rows' p* spans ~1e8 inside every search block (counts of a million
    beside topics that are heavy elsewhere), where the lanes' sums round
    in different directions and the prefixes must still not decrease."""
    K, V, n_sweeps = 256, 2, 4
    rng = np.random.default_rng(5)
    phi = np.zeros((V, K), np.int32)
    heavy = rng.random(K) < 0.5
    phi[0, heavy] = rng.integers(1, 1_000_000, int(heavy.sum()))
    phi[1, ~heavy] = 1_000_000
    lens = np.array([64, 37, 5])
    words = rng.integers(0, V, (3, 64))
    z0 = rng.integers(0, K, (3, 64)).astype(np.int32)
    uni = rng.random((3, n_sweeps, 64, 2), dtype=np.float32)
    hyper = np.array([50.0 / K, 0.01], np.float32)
    kw = dict(num_words_total=V, burn_in=2, samples=2, ell_capacity=64)
    outs = []
    for B, L, slots in ((3, 64, [0, 1, 2]), (33, 256, [20, 3, 32])):
        w = rng.integers(0, V, (B, L))
        m = np.zeros((B, L), np.int32)
        zz = rng.integers(0, K, (B, L)).astype(np.int32)
        uu = rng.random((B, n_sweeps, L, 2), dtype=np.float32)
        for d, b in enumerate(slots):
            w[b, :64], zz[b, :64], uu[b, :, :64] = words[d], z0[d], uni[d]
            m[b] = 0
            m[b, :lens[d]] = 1
        args = [torch.from_numpy(a).to(dev) for a in (
            phi[w], phi.sum(0).astype(np.int32), hyper, uu, m, zz)]
        k = kernel.fold_in_docs(*args, **kw)
        torch.cuda.synchronize()
        outs.append([o[slots].cpu() for o in k])
    (t1, sp1, q1, z1), (t2, sp2, q2, z2) = outs
    assert torch.equal(t1, t2) and torch.equal(sp1, sp2)
    assert torch.equal(z1, z2[:, :64])
    assert torch.equal(q1, q2)   # summed in token order, whatever the shape
    assert 0 < int(sp1.sum()) < int(lens.sum()) * 2   # both sides drawn


def test_ops_dispatch_launches_on_cuda(dev):
    args, kw = case(96, dev, seed=1)
    before = kernel.fold_in_docs.launches
    out = ops.fold_in_sweeps_drawn(args[0], args[1], args[4] != 0, args[5],
                                   args[3].transpose(0, 1), args[2][0],
                                   args[2][1], **kw)
    assert kernel.fold_in_docs.launches == before + 1
    ops.fold_in_sweeps_drawn(args[0], args[1], args[4] != 0, args[5],
                             args[3].transpose(0, 1), args[2][0], args[2][1],
                             impl="ref", **kw)
    assert kernel.fold_in_docs.launches == before + 1
    assert out[0].device.type == "cuda"


def test_wrapper_rejects_bad_inputs(dev):
    args, kw = case(96, dev, seed=2)
    bad = list(args)
    bad[0] = args[0].to(torch.int64)
    with pytest.raises(ValueError, match="dtype"):
        kernel.fold_in_docs(*bad, **kw)
    bad = list(args)
    bad[3] = args[3].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.fold_in_docs(*bad, **kw)
    with pytest.raises(ValueError, match="ell_capacity"):
        kernel.fold_in_docs(*args, **{**kw, "ell_capacity": 0})


def test_engine_serves_through_kernel(dev):
    from repro_torch.serve import (EngineConfig, HotSwapModel, InferConfig,
                                   LDAServeEngine, snapshot_from_numpy)

    V, K = 64, 8
    phi = np.zeros((V, K), np.int32)
    for k in range(K):
        phi[k * 8:(k + 1) * 8, k] = 200
    snap = snapshot_from_numpy(phi, phi.sum(0), 0.1, 0.01, V, device=dev)
    eng = LDAServeEngine(HotSwapModel(snap), EngineConfig(
        max_batch=4, max_delay_ms=20.0, length_buckets=(32,),
        infer=InferConfig(burn_in=3, samples=2)))
    before = kernel.fold_in_docs.launches
    try:
        out = eng.infer_many([np.arange(k * 8, k * 8 + 8, dtype=np.int32)
                              for k in (0, 1, 2)])
    finally:
        eng.stop()
    assert [int(r["theta"].argmax()) for r in out] == [0, 1, 2]
    assert kernel.fold_in_docs.launches > before


# ---------------------------------------------------------------------------
# V-sharded serving: K3 on the lead device (psum) and on each shard's doc
# slice (all2all)
# ---------------------------------------------------------------------------
def sharded_case(dev, K=1024, V=500, seed=4):
    from repro_torch.serve import snapshot_from_numpy

    rng = np.random.default_rng(seed)
    phi = ((rng.random((V, K)) < 0.05)
           * rng.integers(1, 5000, (V, K))).astype(np.int32)
    return snapshot_from_numpy(phi, phi.sum(0), 50.0 / K, 0.01, V,
                               device=dev), rng


def assert_sharded_equals_dense(snap, devices, rng):
    """psum and all2all through K3 equal the dense fold-in bit for bit in
    theta, top_topics, sparse_frac and mean_s_over_sq; K3 launched once
    (psum) and once a shard (all2all)."""
    from repro_torch.serve import InferConfig, shard_snapshot
    from repro_torch.serve.infer import fold_in_config, pack_docs

    cfg = InferConfig(burn_in=3, samples=2)
    for B in (1, 6, 32):
        for L in (60, 256):
            lens = rng.integers(1, L + 1, B)
            lens[B // 2] = L
            tokens, mask = pack_docs(
                [rng.integers(0, snap.num_words, n) for n in lens], L)
            gen = torch.Generator(device=snap.device).manual_seed(B + L)
            randoms = ops.draw_fold_in_randoms(gen, B, L, snap.num_topics,
                                               5, snap.device)
            want = fold_in_config(snap, tokens, mask, randoms, cfg)
            for comm in ("psum", "all2all"):
                sh = shard_snapshot(snap, len(devices), devices=devices,
                                    comm=comm)
                before = kernel.fold_in_docs.launches
                got = fold_in_config(sh, tokens, mask, randoms, cfg)
                torch.cuda.synchronize()
                assert kernel.fold_in_docs.launches - before == (
                    1 if comm == "psum" else len(devices))
                for f in ("theta", "top_topics", "sparse_frac",
                          "mean_s_over_sq"):
                    assert torch.equal(getattr(got, f).cpu(),
                                       getattr(want, f).cpu()), (B, L, comm,
                                                                 f)


def test_sharded_fold_in_equals_dense_on_one_card(dev):
    snap, rng = sharded_case(dev)
    assert_sharded_equals_dense(snap, (dev,) * 4, rng)


def test_sharded_fold_in_equals_dense_across_cards(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    snap, rng = sharded_case(dev, seed=5)
    assert_sharded_equals_dense(
        snap, tuple(torch.device("cuda", i % n) for i in range(4)), rng)


@pytest.mark.parametrize("comm", ["psum", "all2all"])
def test_sharded_engine_makes_no_host_sync(dev, comm):
    """The engine on a sharded snapshot under sanitize: every batch's
    launches run under the sync guard (a host sync there fails the batch),
    one H2D copy a batch, K3 launched."""
    from repro_torch.serve import (EngineConfig, HotSwapModel, InferConfig,
                                   LDAServeEngine, shard_snapshot)

    snap, rng = sharded_case(dev, K=256, seed=6)
    n = torch.cuda.device_count()
    sh = shard_snapshot(snap, 4, comm=comm, devices=tuple(
        torch.device("cuda", i % n) for i in range(4)))
    eng = LDAServeEngine(HotSwapModel(sh), EngineConfig(
        max_batch=8, max_delay_ms=5.0, length_buckets=(32, 64),
        infer=InferConfig(burn_in=3, samples=2), sanitize=True))
    before = kernel.fold_in_docs.launches
    try:
        out = eng.infer_many([rng.integers(0, snap.num_words, n)
                              for n in rng.integers(1, 64, 20)])
        s = eng.stats()
    finally:
        eng.stop()
    assert len(out) == 20 and s["errors"] == 0
    assert s["h2d_transfers"] == s["batches"] and s["comm_bytes_moved"] > 0
    assert kernel.fold_in_docs.launches > before
    assert torch.cuda.get_sync_debug_mode() == 0


# ---------------------------------------------------------------------------
# training kernels: K1 (lda_sample), K2 (phi_delta), K4 (phi_update)
# ---------------------------------------------------------------------------
def sweep_case(K, dev, n=48, t=64, V=40, D=30, seed=0, z_dtype=torch.int16,
               ell_dtype=torch.int32, docs="random", P=None, full_rows=False):
    """Word tiles over a random corpus slice, a random phi and the ELL of a
    random theta (zero counts last, as theta_to_ell gives).

    ``docs="random"``: each slot a random document (runs of about one
    slot); ``"runs"``: the slots in runs of one document of 1 to 2t + 9
    slots (whole tiles, and runs that cross a tile boundary), as a word's
    doc-sorted tokens are.  ``full_rows``: a third of the documents use
    every topic, so their rows have no zero (live = P).  ``P`` defaults to
    min(K, 64)."""
    from repro_torch.core import updates

    rng = np.random.default_rng(seed)
    tile_word = np.sort(rng.integers(0, V, n)).astype(np.int32)
    if docs == "random":
        token_doc = rng.integers(0, D, (n, t))
    else:
        lengths = rng.choice([1, 2, 3, 5, 17, t, 2 * t + 9], size=n * t)
        flat = np.repeat(np.arange(n * t) % D, lengths)[:n * t]
        token_doc = flat.reshape(n, t)
    token_doc = token_doc.astype(np.int32)
    lens = rng.integers(0, t + 1, n)
    lens[:n // 4] = t                                 # some full tiles
    mask = np.arange(t)[None] < lens[:, None]
    z = rng.integers(0, K, (n, t))
    phi = rng.integers(0, 50, (V, K)).astype(np.int32)
    theta = ((rng.random((D, K)) < 0.05) * rng.integers(1, 9, (D, K)))
    theta[np.arange(D), rng.integers(0, K, D)] += 1
    if full_rows:
        theta[::3] = rng.integers(1, 9, (len(theta[::3]), K))
    P = min(K, 64) if P is None else P
    cnt, tpc = updates.ell_topk(torch.from_numpy(theta.astype(np.int32)), P,
                                ell_dtype)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    args = (T(tile_word), T(token_doc), T(mask), T(z).to(z_dtype), T(phi),
            T(phi.sum(0).astype(np.int32)), cnt.to(dev), tpc.to(dev),
            T(rng.random((n, t, 2), dtype=np.float32)))
    return args, dict(alpha=50.0 / K, beta=0.01, num_words_total=V)


def check_sweep(args, kw, K):
    """K1 against its plain version on the same inputs: draws agree up to
    float-order boundary flips (fault F2), at most 1% of real tokens (0 at
    K <= 256); padding slots keep z_old and report 0; S/(S+Q), which does
    not depend on the draw, agrees to 1e-5 on every real slot."""
    from repro_torch.kernels.lda_sample import kernel as k1, ops as k1_ops
    from repro_torch.kernels.lda_sample import ref as k1_ref

    before = k1.lda_sample_tiles.launches
    z, sp, ssq = k1_ops.launch_kernel(args, **kw)
    assert k1.lda_sample_tiles.launches == before + 1
    zr, spr, ssqr = k1_ref.lda_sample_tiles_ref(*args, **kw)
    torch.cuda.synchronize()
    mask = args[2]
    flips = int(((z != zr) & mask).sum())
    assert flips <= 0.01 * int(mask.sum()), flips
    assert z.dtype == args[3].dtype
    assert torch.equal(z[~mask], args[3][~mask])
    assert not bool(sp[~mask].any()) and float(ssq[~mask].abs().sum()) == 0
    assert bool(((z >= 0) & (z < K)).all())
    torch.testing.assert_close(ssq[mask], ssqr[mask], rtol=1e-5, atol=1e-6)
    if K <= 256:
        assert flips == 0 and torch.equal(sp, spr)


@pytest.mark.parametrize("K", [96, 256, 1024])
def test_lda_sample_kernel_matches_plain_version(dev, K):
    args, kw = sweep_case(K, dev, seed=K)
    check_sweep(args, kw, K)


# (docs, ELL dtype, z dtype, P, rows with no zero): P = 60 and 300 (int16)
# and P = 62 (int32) are not multiples of the 16-byte vector and take the
# element-wise row copy; rows longer than one warp-wide vector load (256
# int16 or 128 int32 entries) take several (P is capped at K)
SWEEP_CASES = [
    ("runs", torch.int16, torch.int16, 512, True),
    ("runs", torch.int16, torch.int32, 300, True),
    ("random", torch.int32, torch.int16, 300, True),
    ("random", torch.int16, torch.int16, 64, False),
    ("random", torch.int16, torch.int32, 64, True),
    ("random", torch.int32, torch.int32, 62, False),
    ("runs", torch.int16, torch.int16, 64, False),
    ("runs", torch.int16, torch.int32, 64, True),
    ("runs", torch.int32, torch.int16, 64, True),
    ("runs", torch.int32, torch.int32, 64, False),
    ("runs", torch.int16, torch.int16, 60, True),
    ("runs", torch.int32, torch.int16, 62, False),
]


@pytest.mark.parametrize("K", [256, 1024])
@pytest.mark.parametrize("docs,ell_dtype,z_dtype,P,full_rows", SWEEP_CASES)
def test_lda_sample_kernel_runs_and_ell_types(dev, K, docs, ell_dtype,
                                              z_dtype, P, full_rows):
    """Runs of one document up to a whole tile and across tile boundaries,
    runs of one slot, rows with no zero count, a width that is not a
    multiple of the vector, and each of int16 / int32 ELL and z; 45 tiles,
    so the kernel's last group of tiles is a short one (the sorted tile
    words repeat, so groups keep p* across tiles)."""
    args, kw = sweep_case(K, dev, n=45, seed=K + P, z_dtype=z_dtype,
                          ell_dtype=ell_dtype, docs=docs, P=min(P, K),
                          full_rows=full_rows)
    if full_rows:
        assert int((args[6] > 0).all(1).sum()) > 0
    check_sweep(args, kw, K)


def test_lda_sample_draw_does_not_depend_on_run_length(dev):
    """The same tokens (doc, u1, u2) drawn in runs of a whole tile and in
    runs of one slot get the same bits: long runs search the prefixes by
    bisection, runs of one or two count them warp-wide, which agree only
    if the prefixes never decrease.  The word's p* mixes topics with a
    million counts and topics with none that are heavy elsewhere (p* spans
    ~1e8) inside every search block, where the in-block scan's lanes
    would round in different directions."""
    from repro_torch.core import updates
    from repro_torch.kernels.lda_sample import ops as k1_ops

    K, n, t, D, P = 1024, 48, 64, 48, 64
    rng = np.random.default_rng(7)
    phi = np.zeros((2, K), np.int32)
    heavy = rng.random(K) < 0.5
    phi[0, heavy] = rng.integers(1, 1_000_000, int(heavy.sum()))
    phi[1, ~heavy] = 1_000_000
    theta = (rng.random((D, K)) < 0.05) * rng.integers(1, 9, (D, K))
    theta[np.arange(D), rng.integers(0, K, D)] += 1
    cnt, tpc = updates.ell_topk(torch.from_numpy(theta.astype(np.int32)), P,
                                torch.int16)
    docs_a = np.repeat(np.arange(n) % D, t)           # tile i: all doc i
    uni_a = rng.random((n * t, 2), dtype=np.float32)
    perm = (np.arange(n * t) % n) * t + np.arange(n * t) // n
    docs_b, uni_b = docs_a[perm], uni_a[perm]         # neighbours differ
    assert (docs_b[1:] != docs_b[:-1]).all()
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    kw = dict(alpha=50.0 / K, beta=0.01, num_words_total=2)
    outs = []
    for docs, uni in ((docs_a, uni_a), (docs_b, uni_b)):
        args = (T(np.zeros(n, np.int32)),
                T(docs.reshape(n, t).astype(np.int32)),
                T(np.ones((n, t), bool)),
                T(rng.integers(0, K, (n, t)).astype(np.int16)), T(phi),
                T(phi.sum(0).astype(np.int32)), cnt.to(dev), tpc.to(dev),
                T(uni.reshape(n, t, 2)))
        check_sweep(args, kw, K)
        outs.append([o.reshape(-1).cpu()
                     for o in k1_ops.launch_kernel(args, **kw)])
    sparse = outs[0][1][perm]
    assert 0 < int(sparse.sum()) < n * t              # both sides drawn
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a[perm], b)


def minus_ones(*shape, dtype, device):
    """A stand-in for torch.empty: memory last filled with -1."""
    return torch.full(shape[0] if len(shape) == 1 else shape, -1,
                      dtype=dtype, device=device)


@pytest.mark.parametrize("z_dtype", [torch.int16, torch.int32])
def test_phi_kernels_exact(dev, z_dtype, monkeypatch):
    from repro_torch.kernels.phi_update import kernel as k24, ops, ref

    K, V = 256, 40
    args, _ = sweep_case(K, dev, V=V, seed=5, z_dtype=z_dtype)
    tw, mask, z_old = args[0], args[2], args[3]
    z_new = torch.randint(0, K, z_old.shape, device=dev).to(z_dtype)
    first = torch.ones_like(tw, dtype=torch.bool)
    before = (k24.phi_delta_tiles.launches, k24.phi_update_tiles.launches)
    seg = ops.segment_table(tw, first, k24.segment_tiles())
    d = ops.phi_delta(tw, first, z_old, z_new, mask, num_words=V + 3,
                      num_topics=K, segments=seg)
    full = ops.phi_update(tw, first, z_new, mask, num_words=V + 3,
                          num_topics=K)
    assert (k24.phi_delta_tiles.launches,
            k24.phi_update_tiles.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(d, ref.phi_delta_tiles_ref(tw, first, z_new, z_old,
                                                  mask, V + 3, K))
    assert torch.equal(full, ref.phi_update_tiles_ref(tw, first, z_new, mask,
                                                      V + 3, K))
    old = ops.phi_update(tw, first, z_old, mask, num_words=V + 3,
                         num_topics=K)
    assert torch.equal(old + d, full)
    assert int(full[V:].abs().sum()) == 0         # rows no tile visits
    # K4 on the kept tables, into memory last filled with -1
    rows = ops.rows_to_zero(seg, V + 3)
    monkeypatch.setattr(torch, "empty", minus_ones)
    again = ops.phi_update(tw, first, z_new, mask, num_words=V + 3,
                           num_topics=K, segments=seg, zero_rows=rows)
    monkeypatch.undo()
    assert torch.equal(again, full)


def segment_case(t, K, z_dtype, dev, seed=0):
    """A tiling that has word 0 over 600 consecutive tiles (more than three
    segments), words 1-15 a tile each, word 3 again after word 15 (its
    tiles not contiguous), word 20 over two tiles and five padding tiles
    that alias it with tile_first False and an all-false mask.  z_new
    moves half the tokens, most of them to three hot topics (equal bins
    in a warp); some tiles are partly padded."""
    rng = np.random.default_rng(seed)
    tw = np.r_[np.zeros(600), np.arange(1, 16), [3, 3], [20] * 7].astype(
        np.int32)
    n = len(tw)
    tf = np.r_[True, tw[1:] != tw[:-1]]
    tf[-5:] = False
    mask = rng.random((n, t)) < 0.9
    mask[-5:] = False
    z_old = rng.integers(0, K, (n, t))
    hot = rng.integers(0, 3, (n, t)) * (K // 3)
    z_new = np.where(rng.random((n, t)) < 0.5,
                     np.where(rng.random((n, t)) < 0.8, hot,
                              rng.integers(0, K, (n, t))), z_old)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (T(tw), T(tf), T(z_old).to(z_dtype), T(z_new).to(z_dtype),
            T(mask))


@pytest.mark.parametrize("z_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("t,K", [(64, 1024), (12, 96), (16, 90)])
def test_phi_delta_segments_exact(dev, z_dtype, t, K):
    """K2 on a segment table equals its plain version exactly: a word over
    several segments (atomics), single-tile words (plain stores), a word
    whose tiles are not contiguous and padding tiles that add nothing;
    t = 64 and 16 read z and the mask as vectors, t = 12 slot by slot;
    K = 90 flushes bin by bin, not by 32-byte sectors."""
    from repro_torch.kernels.phi_update import kernel as k24, ops, ref

    tw, tf, z_old, z_new, mask = segment_case(t, K, z_dtype, dev)
    V = 24                                        # rows 21-23: no tile
    seg = ops.segment_table(tw, tf, k24.segment_tiles())
    assert k24.segment_tiles() == 128
    words = seg[:, 2].tolist()
    assert words.count(0) == 5 and words.count(3) == 2
    before = k24.phi_delta_tiles.launches
    d = ops.phi_delta(tw, tf, z_old, z_new, mask, num_words=V, num_topics=K,
                      segments=seg)
    assert k24.phi_delta_tiles.launches == before + 1
    r = ref.phi_delta_tiles_ref(tw, tf, z_new, z_old, mask, V, K)
    torch.cuda.synchronize()
    assert torch.equal(d, r)
    assert int(r[0].abs().sum()) > 0 and int(d[21:].abs().sum()) == 0
    # a table built without tile_first cuts at word changes alone
    seg = ops.segment_table(tw, None, k24.segment_tiles())
    assert torch.equal(ops.phi_delta(tw, None, z_old, z_new, mask,
                                     num_words=V, num_topics=K,
                                     segments=seg), r)
    # on the card the table is required: it is built once per tiling
    with pytest.raises(ValueError, match="segment table"):
        ops.phi_delta(tw, tf, z_old, z_new, mask, num_words=V, num_topics=K)


@pytest.mark.parametrize("z_dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("t,K", [(64, 1024), (12, 96), (16, 90)])
def test_phi_update_segments_exact(dev, z_dtype, t, K, monkeypatch):
    """K4 on the segment table and its rows to zero equals its plain
    version exactly, also into memory last filled with -1 (a row it
    neither writes whole nor zeroes would show): a word over several
    segments and a non-contiguous word (zeroed, then added into), single-
    tile words (rows written whole), padding tiles, rows 21-23 that no
    tile visits; t = 64 and 16 read z and the mask as vectors, t = 12
    slot by slot; K = 90 writes rows bin by bin, not by 32-byte sectors.
    K4(z_old) + K2 == K4(z_new)."""
    from repro_torch.kernels.phi_update import kernel as k24, ops, ref

    tw, tf, z_old, z_new, mask = segment_case(t, K, z_dtype, dev)
    V = 24
    seg = ops.segment_table(tw, tf, k24.segment_tiles())
    rows = ops.rows_to_zero(seg, V)
    assert rows.tolist() == [0, 3, 16, 17, 18, 19, 21, 22, 23]
    r = ref.phi_update_tiles_ref(tw, tf, z_new, mask, V, K)
    before = k24.phi_update_tiles.launches
    u = ops.phi_update(tw, tf, z_new, mask, num_words=V, num_topics=K,
                       segments=seg, zero_rows=rows)
    assert k24.phi_update_tiles.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(u, r)
    assert int(r[0].sum()) > 0 and int(u[21:].abs().sum()) == 0
    monkeypatch.setattr(torch, "empty", minus_ones)
    filled = k24.phi_update_tiles(seg, rows, z_new, mask, V, K)
    old = k24.phi_update_tiles(seg, rows, z_old, mask, V, K)
    d = k24.phi_delta_tiles(seg, z_new, z_old, mask, V, K)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.equal(filled, r)
    assert torch.equal(old + d, u)
    # without the tables, ops builds them (one host sync each)
    assert torch.equal(ops.phi_update(tw, None, z_new, mask, num_words=V,
                                      num_topics=K), r)


def test_training_wrappers_reject_bad_inputs(dev):
    from repro_torch.kernels.lda_sample import kernel as k1, ops as k1_ops
    from repro_torch.kernels.phi_update import kernel as k24
    from repro_torch.kernels.phi_update import ops as phi_ops

    args, kw = sweep_case(96, dev, seed=3)
    kw = dict(kw, ell_live=k1_ops.live_lengths(args[6]))
    bad = list(args)
    bad[7] = args[7].to(torch.int16)             # int32 counts, int16 topics
    with pytest.raises(ValueError, match="dtype"):
        k1.lda_sample_tiles(*bad, **kw)
    bad = list(args)
    bad[6], bad[7] = args[6].to(torch.int64), args[7].to(torch.int64)
    with pytest.raises(ValueError, match="dtype"):
        k1.lda_sample_tiles(*bad, **kw)
    with pytest.raises(ValueError, match="ell_live"):
        k1.lda_sample_tiles(*args, **dict(kw, ell_live=kw["ell_live"][1:]))
    bad = list(args)
    bad[4] = args[4].to(torch.int64)
    with pytest.raises(ValueError, match="dtype"):
        k1.lda_sample_tiles(*bad, **kw)
    bad = list(args)
    bad[8] = args[8].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        k1.lda_sample_tiles(*bad, **kw)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k1.lda_sample_tiles(*(a.cpu() for a in args), **kw)
    tw, mask, z = args[0], args[2], args[3]
    seg = phi_ops.segment_table(tw, None, k24.segment_tiles())
    rows = phi_ops.rows_to_zero(seg, 40)
    with pytest.raises(ValueError, match="dtype"):
        k24.phi_update_tiles(seg, rows, z.to(torch.int64), mask, 40, 96)
    with pytest.raises(ValueError, match="zero_rows"):
        k24.phi_update_tiles(seg, rows.to(torch.int64), z, mask, 40, 96)
    with pytest.raises(ValueError, match="more than num_words"):
        k24.phi_update_tiles(seg, rows, z, mask, int(rows.shape[0]) - 1, 96)
    with pytest.raises(ValueError, match="segments"):
        k24.phi_update_tiles(seg[:, :3].contiguous(), rows, z, mask, 40, 96)
    with pytest.raises(ValueError, match="contiguous"):
        k24.phi_delta_tiles(seg, z.t().contiguous().t(), z, mask, 40, 96)
    with pytest.raises(ValueError, match="segments"):
        k24.phi_delta_tiles(seg.to(torch.int64), z, z, mask, 40, 96)
    with pytest.raises(ValueError, match="segments"):
        k24.phi_delta_tiles(seg[:, :3].contiguous(), z, z, mask, 40, 96)
    with pytest.raises(ValueError, match="CUDA kernel"):
        k24.phi_update_tiles(seg.cpu(), rows.cpu(), z.cpu(), mask.cpu(), 40,
                             96)


def test_fit_on_cuda_launches_training_kernels(dev):
    """fit on cuda:0: K1 and K2 launch once per iteration (plus the warm-up
    iteration), the ELL kernel at least as often, the sweep runs under the
    sync guard, and the counts stay exact."""
    from repro_torch.core import trainer, updates
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.data.synthetic import lda_corpus
    from repro_torch.kernels.ell_select import kernel as ell
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.phi_update import kernel as k24
    from repro_torch.kernels.phi_update import ops as phi_ops
    from repro_torch.train import fit

    corpus = lda_corpus(num_docs=60, num_words=120, num_topics=8,
                        avg_doc_len=40, seed=2)
    cfg = trainer.LDAConfig(num_topics=16, tile_tokens=32)
    k1.lda_sample_tiles.launches = k24.phi_delta_tiles.launches = 0
    ell.ell_select.launches = 0
    res = fit(corpus, cfg, 3, device=dev, sanitize=True)
    assert k1.lda_sample_tiles.launches == 4
    assert k24.phi_delta_tiles.launches == 4
    assert ell.ell_select.launches >= 4      # the ELL of every iteration
    st = res.state
    assert st.z.device.type == "cuda" and st.z.dtype == torch.int16
    shard = tile_corpus(corpus, 1, 32)[0].to(dev)
    assert torch.equal(st.phi_vk, phi_ops.phi_update(
        shard.tile_word, shard.tile_first, st.z, shard.token_mask,
        num_words=corpus.num_words, num_topics=16))
    assert torch.equal(st.phi_sum, updates.phi_totals(st.phi_vk))
    assert int(st.phi_vk.sum()) == corpus.num_tokens
    assert len(res.ll_per_token) == 3 and res.compile_sec > 0


@pytest.mark.parametrize("M", [1, 3])
def test_lda_iteration_on_cuda_matches_plain(dev, M):
    """One iteration, WorkSchedule1 and 2 (M = 3 pads the tile count),
    from the same state and uniforms: through K1/K2 on the card and the
    plain versions on the CPU.  Draws may flip on a float boundary (F2,
    at most 1% here); the card's counts stay exact either way."""
    from repro_torch.core import trainer
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.data.synthetic import lda_corpus
    from repro_torch.kernels.phi_update import ops as phi_ops

    corpus = lda_corpus(num_docs=60, num_words=120, num_topics=8,
                        avg_doc_len=40, seed=4)
    cfg = trainer.resolve_config(trainer.LDAConfig(
        num_topics=64, tile_tokens=32, micro_chunks=M), corpus)
    shard = tile_corpus(corpus, 1, 32)[0]
    n, t = shard.token_doc.shape
    assert M == 1 or n % M
    s0 = trainer.init_state(cfg, shard)
    u = torch.rand((n + (-n % M), t, 2),
                   generator=torch.Generator().manual_seed(M))
    a, sa = trainer.lda_iteration(cfg, shard, s0, uniforms=u)
    sd = shard.to(dev)
    s0d = trainer.LDAState(z=s0.z.to(dev), phi_vk=s0.phi_vk.to(dev),
                           phi_sum=s0.phi_sum.to(dev), iteration=0)
    b, sb = trainer.lda_iteration(cfg, sd, s0d, uniforms=u.to(dev))
    torch.cuda.synchronize()
    mask = shard.token_mask
    flips = int(((a.z != b.z.cpu()) & mask).sum())
    assert flips <= 0.01 * int(mask.sum()), flips
    if flips == 0:
        assert torch.equal(a.phi_vk, b.phi_vk.cpu())
    assert torch.equal(b.phi_vk, phi_ops.phi_update(
        sd.tile_word, sd.tile_first, b.z, sd.token_mask,
        num_words=corpus.num_words, num_topics=64))
    assert torch.equal(b.phi_sum, b.phi_vk.sum(0, dtype=torch.int32))
    assert abs(float(sa.sparse_frac) - float(sb.sparse_frac)) < 0.01


# ---------------------------------------------------------------------------
# the ELL of theta (kernels/ell_select) against its plain version
# ---------------------------------------------------------------------------
def ell_theta(D, K, seed):
    """(D, K) int32 counts: 30% of the topics at counts 1-4 (many ties);
    row 0 all zero; row 1 dense (every topic non-zero: it overflows unless
    P = K); row 2 counts from 100 up to the int16 limit (above 255 and
    beyond the kernel's 128-bin histogram); row 3 counts about that
    histogram's edge (126-129) and 255 / 256."""
    rng = np.random.default_rng(seed)
    theta = (rng.random((D, K)) < 0.3) * rng.integers(1, 5, (D, K))
    theta[0] = 0
    theta[1] = rng.integers(1, 4, K)
    theta[2] = (rng.random(K) < 0.2) * rng.integers(100, 32768, K)
    theta[3] = (rng.random(K) < 0.3) * rng.choice(
        [126, 127, 128, 129, 255, 256], K)
    return theta.astype(np.int32)


ELL_CASES = [  # (K, P, ELL dtype, a 3-d (lead) theta)
    (1024, 512, torch.int16, False), (1024, 256, torch.int32, False),
    (1024, 1024, torch.int16, False), (1024, 8, torch.int16, True),
    (90, 60, torch.int16, False), (100, 100, torch.int32, True),
    (2050, 700, torch.int32, False), (3000, 2500, torch.int16, False),
    (6000, 6000, torch.int32, False)]


@pytest.mark.parametrize("K,P,dtype,lead", ELL_CASES)
def test_ell_select_matches_plain_version(dev, K, P, dtype, lead):
    """``theta_to_ell`` and ``ell_topk`` on the card (one launch each)
    against the plain stable sort, bit for bit: counts, topics with their
    zero-count padding, and the overflow flag.  K = 90 takes the kernel's
    4-byte loads (K % 4 != 0), K = 100 a row that is no multiple of 32,
    K = 2050, 3000 and 6000 rows longer than the kernel's 1024-topic tile,
    P = 6000 in int32 too many entries to stage in shared memory; the rows
    are no multiple of the kernel's rows a block."""
    from repro_torch.core import updates
    from repro_torch.kernels.ell_select import kernel as ell, ref as ell_ref

    rpb = ell.rows_per_block(K, P, dtype)
    D = 10 * rpb + 2
    assert rpb > 2 and D % rpb
    theta = torch.from_numpy(ell_theta(D, K, seed=K + P))
    if lead:
        theta = theta.view(2, D // 2, K)
    want = ell_ref.theta_to_ell_ref(theta, P, dtype)
    before = ell.ell_select.launches
    got = updates.theta_to_ell(theta.to(dev), P, dtype)
    got_topk = updates.ell_topk(theta.to(dev), P, dtype)
    torch.cuda.synchronize()
    assert ell.ell_select.launches == before + 2
    for g, w in zip(got + got_topk, want + want[:2]):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    flat = want[2].reshape(-1)
    assert not flat[0] and bool(flat[1]) == (P < K)


def test_ell_select_at_nytimes_shape(dev):
    """NYTimes' shape, 299,752 x 1024 at P = 512 in int16, on the theta of
    random topics over Poisson(332) documents (the trainer's first step):
    one launch, synchronised, bit for bit the plain version on the card."""
    from repro_torch.kernels.ell_select import kernel as ell, ref as ell_ref

    D, K, P = 299_752, 1024, 512
    g = torch.Generator(device=dev).manual_seed(0)
    lengths = torch.poisson(torch.full((D,), 332.0, device=dev),
                            generator=g).to(torch.int64)
    doc = torch.repeat_interleave(torch.arange(D, device=dev), lengths)
    z = torch.randint(0, K, doc.shape, device=dev, generator=g)
    theta = torch.zeros(D * K, dtype=torch.int32, device=dev)
    theta.index_add_(0, doc * K + z, torch.ones_like(z, dtype=torch.int32))
    theta = theta.view(D, K)
    del doc, z
    got = ell.ell_select(theta, P, torch.int16)
    torch.cuda.synchronize()
    want = ell_ref.theta_to_ell_ref(theta, P, torch.int16)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    assert not bool(got[2].any())       # no document has 512 topics


# ---------------------------------------------------------------------------
# training over a process group: one NCCL rank on the card
# ---------------------------------------------------------------------------
MESH_CASES = [  # (mode, compressed_sync, micro_chunks, sync_overlap)
    ("1d", False, 1, False), ("1d", True, 1, False), ("1d", False, 2, True),
    ("1d", True, 2, True), ("2d", False, 1, False), ("2d", True, 1, False)]


def test_chunk_segment_tables_give_the_whole_delta(dev):
    """K2 on each micro-chunk's tiles with its own segment table (the
    per-chunk delta of sync_overlap; M = 3 pads the tile count) adds up to
    K2 on every tile."""
    from repro_torch.core import trainer
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.data.synthetic import lda_corpus
    from repro_torch.kernels.phi_update import ops as phi_ops

    corpus = lda_corpus(num_docs=60, num_words=120, num_topics=8,
                        avg_doc_len=40, seed=4)
    shard = tile_corpus(corpus, 1, 32)[0].to(dev)
    n, t = shard.token_doc.shape
    M = 3
    assert n % M
    gen = torch.Generator(device=dev).manual_seed(0)
    z0 = torch.randint(0, 64, (n, t), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int16)
    z1 = torch.randint(0, 64, (n, t), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int16)
    whole = phi_ops.phi_delta(shard.tile_word, shard.tile_first, z0, z1,
                              shard.token_mask, num_words=120, num_topics=64,
                              segments=phi_ops.shard_segments(shard))
    tw, _, tm, za = trainer._pad_tiles((shard.tile_word, shard.token_doc,
                                        shard.token_mask, z0), -n % M)
    zb = trainer._pad_tiles((z1,), -n % M)[0]
    nc = tw.shape[0] // M
    tables = phi_ops.shard_chunk_segments(shard, M)
    assert phi_ops.shard_chunk_segments(shard, M) is tables   # kept
    parts = [phi_ops.phi_delta(tw[m * nc:(m + 1) * nc], None,
                               za[m * nc:(m + 1) * nc],
                               zb[m * nc:(m + 1) * nc],
                               tm[m * nc:(m + 1) * nc], num_words=120,
                               num_topics=64, segments=tables[m])
             for m in range(M)]
    assert torch.equal(sum(parts), whole)


def _nccl_rank(rank, out_path):
    """One NCCL rank: the byte wire against an int32 all-reduce, whether
    NCCL takes int16, and one mesh step against lda_iteration."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import sync, trainer
    from repro_torch.data.synthetic import lda_corpus
    from repro_torch.distributed.partition import DistributedLDA

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    delta = torch.zeros((7, 5), dtype=torch.int32, device=dev)
    delta[1, 2], delta[3, 0], delta[0, 4] = 40000, -35000, 123
    heavy = torch.tensor([1, 3, 3, 0], device=dev)
    exact = delta.clone()
    dist.all_reduce(exact)
    wrapped = sync.compressed_sync_phi(delta.clone(), dist.group.WORLD)
    fixed = sync.compressed_sync_phi(delta.clone(), dist.group.WORLD, heavy)
    out["wire_exact"] = torch.equal(fixed, exact) and torch.equal(
        exact, delta)
    out["wire_wraps"] = int(wrapped[1, 2]) == 40000 - (1 << 16)
    try:
        dist.all_reduce(torch.ones(4, dtype=torch.int16, device=dev))
        torch.cuda.synchronize()
        out["nccl_int16"] = "accepted"
    except (RuntimeError, TypeError, ValueError) as e:
        out["nccl_int16"] = f"refused: {type(e).__name__}"

    corpus = lda_corpus(num_docs=60, num_words=120, num_topics=8,
                        avg_doc_len=40, seed=4)
    meshes = {"1d": init_device_mesh("cuda", (1,), mesh_dim_names=("data",)),
              "2d": init_device_mesh("cuda", (1, 1),
                                     mesh_dim_names=("data", "model"))}
    for mode, comp, M, overlap in MESH_CASES:
        cfg = trainer.LDAConfig(num_topics=64, tile_tokens=32,
                                micro_chunks=M, compressed_sync=comp,
                                sync_overlap=overlap)
        dl = DistributedLDA(cfg, meshes[mode], corpus, mode=mode,
                            doc_axes=("data",),
                            word_axes=("model",) if mode == "2d" else ())
        s0 = dl.init()
        n, t = s0.z.shape
        u = torch.rand((n + (-n % M), t, 2), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(M))
        a, _ = dl.step(s0, u)
        b, _ = trainer.lda_iteration(dl.cfg, dl.shard, s0, uniforms=u)
        torch.cuda.synchronize()
        out[f"{mode}-{comp}-{M}-{overlap}"] = (
            torch.equal(a.z, b.z) and torch.equal(a.phi_vk, b.phi_vk)
            and torch.equal(a.phi_sum, b.phi_sum))
    # fit over the mesh with every sweep sync-guarded: the collectives and
    # the byte wire make the host wait on the device nowhere
    from repro_torch.train import fit

    for M, overlap in ((1, False), (2, True)):
        cfg = trainer.LDAConfig(num_topics=64, tile_tokens=32,
                                micro_chunks=M, compressed_sync=True,
                                sync_overlap=overlap)
        try:
            res = fit(corpus, cfg, 2, meshes["1d"], sanitize=True)
            out[f"sanitize-{M}"] = (int(res.state.phi_vk.sum())
                                    == corpus.num_tokens)
        except RuntimeError as e:
            out[f"sanitize-{M}"] = f"{type(e).__name__}: {e}"
    torch.save(out, out_path)


@pytest.fixture(scope="module")
def nccl_results(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs only there")
    from repro_torch.distributed import launch

    root = tmp_path_factory.mktemp("nccl")
    launch.spawn(_nccl_rank, 1, args=(str(root / "out.pt"),),
                 device_type="cuda", store_dir=str(root))
    return torch.load(root / "out.pt")


def test_nccl_byte_wire_matches_int32_all_reduce(nccl_results):
    print("NCCL and int16:", nccl_results["nccl_int16"])
    assert nccl_results["wire_wraps"] and nccl_results["wire_exact"]


@pytest.mark.parametrize("mode,comp,M,overlap", MESH_CASES)
def test_nccl_mesh_step_matches_lda_iteration(nccl_results, mode, comp, M,
                                              overlap):
    assert nccl_results[f"{mode}-{comp}-{M}-{overlap}"]


@pytest.mark.parametrize("M", [1, 2])
def test_nccl_fit_makes_no_host_sync(nccl_results, M):
    """fit(mesh=...) under sanitize: a host-device sync inside a sweep,
    the syncs and (M = 2) the overlapped per-chunk syncs included, raises."""
    assert nccl_results[f"sanitize-{M}"] is True


# -- the kernel contracts' mirrors against the built libraries ---------------

def test_launch_contract_mirrors_match_the_built_kernels(dev):
    """``kernels/*/contract.py`` mirror what the launches ask the built
    libraries: K1's shared-memory layout over every contract case, its
    tiles a CTA, and K2's / K4's segment length."""
    from repro_torch.core.sampler import pick_search_block
    from repro_torch.kernels.lda_sample import contract as c1
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.phi_update import contract as c24
    from repro_torch.kernels.phi_update import kernel as k24

    for name, n, t, K, P, eb in c1.cases():
        assert k1.smem_bytes(t, K, P, eb) == c1.smem_bytes(
            t, K, P, pick_search_block(K), eb), name
    assert k1.tiles_per_cta() == c1.TILES_PER_CTA
    assert k24.segment_tiles() == c24.SEGMENT_TILES


def test_fold_in_launches_at_every_contract_case(dev):
    """K3 picks one of the contract's candidate shapes at every serving
    bucket, doc slice and test shape, and launches there (one sweep, the
    result checked against the plain version's theta sums)."""
    from repro_torch.kernels.fold_in import contract

    for name, B, L, K, P in contract.cases():
        assert kernel.launch_shape(B, L, K, P) in \
            contract.candidate_shapes(L), name
        args, kw = case(K, dev, B=B, L=L, V=64, burn_in=0, samples=1,
                        seed=B + L, empty_last=False, P=P)
        k = kernel.fold_in_docs(*args, **kw)
        r = ref.fold_in_docs_ref(*args, **kw)
        torch.cuda.synchronize()
        assert k[0].sum() == r[0].sum(), name


LM_ARCHS = ("recurrentgemma-2b", "qwen3-4b", "gemma2-27b", "qwen1.5-110b",
            "gemma3-27b", "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
            "mamba2-130m", "whisper-large-v3", "internvl2-2b")


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_smoke_arch_on_cuda_matches_cpu(dev, name):
    """chip_smoke's phase 19 for one architecture: float32 (TF32 off)
    prefill and decode (a window-8 ring wrapping) on cuda:0 against the CPU
    from the same weights and state, and, but for MoE, decode == prefill on
    the card; 1e-4 of the logits' scale."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    row = chip_smoke.lm_arch_vs_cpu(name, dev)
    assert row["finite"] and row["position"] == 12
    for k in ("prefill_rel_err", "decode_rel_err",
              "decode_vs_prefill_rel_err"):
        assert row.get(k, 0.0) <= 1e-4, (k, row)
    assert ("decode_vs_prefill_rel_err" in row) == ("moe" not in name)


def test_lm_serve_launcher_on_cuda(dev):
    """No --device means cuda:0."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", "qwen3-4b", "--gen", "2"])
    assert out["device"] == "cuda:0" and out["finite"]
    assert out["position"] == 3


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_train_step_on_cuda_matches_cpu(dev, name):
    """chip_smoke's phase 22 for one architecture: two float32 (TF32 off)
    train steps on cuda:0 against the CPU from the same weights on the same
    batch (loss 1e-5 and grad norm 1e-4 relative, every tensor of the state
    within 2 lr_t + 1e-6 summed over the steps), and two bf16 steps on the
    card, finite, the second loss below the first + 0.05."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    row = chip_smoke.lm_train_vs_cpu(name, dev)
    assert row["finite"] and row["steps_equal"] and row["state_within_bound"]
    assert row["loss_rel_err"] <= 1e-5 and row["grad_norm_rel_err"] <= 1e-4
    assert row["bf16_losses"][1] < row["bf16_losses"][0] + 0.05


def test_prefetch_loader_lands_on_cuda(dev):
    """No device means cuda:0: the batches arrive there in order, equal to
    the host's."""
    from repro_torch.data.loader import PrefetchLoader, lm_batches

    make = lm_batches(1000, 2, 64, seed=2)
    ld = PrefetchLoader(make)
    try:
        got = [next(ld) for _ in range(4)]
    finally:
        ld.close()
    assert ld.device == torch.device("cuda:0")
    for i, b in enumerate(got):
        for k, v in make(i).items():
            assert b[k].device == torch.device("cuda:0")
            np.testing.assert_array_equal(b[k].cpu().numpy(), v)


def test_lm_train_launcher_on_cuda(dev, capsys):
    """--workload lm without --device trains on cuda:0."""
    from repro_torch.launch import train

    assert train.main(["--workload", "lm", "--arch", "qwen3-4b", "--iters",
                       "10"]) == 0
    out = capsys.readouterr().out
    assert "step 10: loss" in out and "on cuda:0" in out


def _lm_mesh_rank(rank, out_path):
    """One NCCL rank on a (1, 1) ("data", "model") mesh: chip_smoke's
    phase-25 check of every smoke arch, the MoE archs' expert-parallel
    path among them (two mesh train steps against two one-device steps on
    the card)."""
    import pathlib
    import sys

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.archs import ARCHS

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    rows = [chip_smoke.mesh_arch_vs_card(n, mesh, dev) for n in sorted(ARCHS)]
    torch.save(rows, out_path)


def test_lm_mesh_step_on_one_nccl_rank(dev, tmp_path):
    """The LM zoo's mesh train step through NCCL collectives' code path on
    one rank: within the one-device step's bounds (loss 1e-5, grad norm
    1e-4 relative, state 2 lr_t + 1e-6), step exact."""
    from repro_torch.distributed import launch

    out = tmp_path / "rows.pt"
    launch.spawn(_lm_mesh_rank, 1, args=(str(out),), device_type="cuda",
                 store_dir=str(tmp_path))
    rows = torch.load(out)
    assert len(rows) == 10
    for r in rows:
        assert r["finite"] and r["steps_equal"] and r["state_within_bound"]
        assert r["loss_rel_err"] <= 1e-5 and r["grad_norm_rel_err"] <= 1e-4


def _lm_serve_rank(rank, name, shape, out_path):
    """One NCCL rank of a ("data", "model") mesh of ``shape``: ``name``'s
    smoke config in float32 (TF32 off), weights, a stand-in state of 20
    tokens in 32 slots (the window-8 rings wrap) and 4 decode tokens
    drawn on the CPU from a seed; rank 0 also runs the one-device decode
    and prefill on the card; every rank runs this rank's shards through
    the mesh steps and the logits are gathered.  Rank 0 saves both."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.archs import smoke
    from repro_torch.launch.specs import make_policy
    from repro_torch.models import convert, parallel, zoo
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import decode_layout
    from repro_torch.models.common import P, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(smoke(name), dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    params = tree_map(lambda a: a.to(dev), tf.init_params(cfg, g))
    state = tree_map(lambda a: a.to(dev), zoo.init_decode_state(
        cfg, 2, 32, prefill_len=20, generator=g, dtype=torch.float32))
    tokens = torch.randint(0, cfg.vocab_size, (2, 4), generator=g).to(dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=g).to(dev)
    out = {}
    if rank == 0:
        st = tree_map(lambda a: a.clone(), state)
        step = zoo.make_decode_step(cfg)
        out["one"] = [step(params, st, tokens[:, i:i + 1])[0].cpu()
                      for i in range(4)]
        out["one_prefill"] = zoo.make_prefill_step(cfg)(
            params, {"tokens": prompt}).cpu()
    pol = make_policy(mesh, 2, "decode")
    rank_ = torch.distributed.get_rank()
    local = convert.shard_params(params, tf.param_specs(cfg, pol), mesh,
                                 rank_)
    st = convert.shard_decode_state(cfg, state, zoo.serving_state_specs(
        cfg, pol), mesh, rank_)
    rows = parallel.dp_rows({"t": tokens, "p": prompt}, pol.ctx)
    step = zoo.make_decode_step(cfg, policy=pol)
    spec = P(pol.batch(), None, pol.tp)
    out["mesh"] = []
    for i in range(4):
        logits, st = step(local, st, rows["t"][:, i:i + 1])
        out["mesh"].append(parallel.gather_full(logits, spec, pol.ctx).cpu())
    pp = make_policy(mesh, 2, "prefill")
    pre = zoo.make_prefill_step(cfg, policy=pp)(
        convert.shard_params(params, tf.param_specs(cfg, pp), mesh, rank_),
        {"tokens": rows["p"]})
    out["mesh_prefill"] = parallel.gather_full(
        pre, P(pp.batch(), None, pp.tp), pp.ctx).cpu()
    out["slot_axes"] = decode_layout(cfg, pol)[0]
    if rank == 0:
        torch.save(out, out_path)


def _serve_on_mesh(tmp_path, name, shape):
    from repro_torch.distributed import launch

    out = tmp_path / "serve.pt"
    launch.spawn(_lm_serve_rank, shape[0] * shape[1],
                 args=(name, shape, str(out)), device_type="cuda",
                 store_dir=str(tmp_path))
    return torch.load(out)


def test_lm_serve_on_one_nccl_rank_is_bit_equal(dev, tmp_path):
    """qwen3-4b's smoke config decoded and prefilled over a one-rank (1, 1)
    mesh: every step's logits and the prefill's equal the one-device
    steps' bit for bit (an axis of size one runs no collective)."""
    res = _serve_on_mesh(tmp_path, "qwen3-4b", (1, 1))
    for a, b in zip(res["one"], res["mesh"]):
        assert torch.equal(a, b)
    assert torch.equal(res["one_prefill"], res["mesh_prefill"])


def test_lm_serve_slot_sharded_on_two_cards(dev, tmp_path):
    """recurrentgemma-2b's smoke config (one KV head) over two NCCL ranks,
    a (1, 2) mesh: its caches' slots go over "model" (layout (b), the
    softmax combined across the cards); the logits within 1e-5 of the
    one-card steps' scale, float32."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the slot-sharded cache spans "
                    "both")
    res = _serve_on_mesh(tmp_path, "recurrentgemma-2b", (1, 2))
    assert res["slot_axes"] == ("model",)
    V = 128
    for a, b in zip(res["one"], res["mesh"]):
        err = float((a[..., :V] - b[..., :V]).abs().max()
                    / a[..., :V].abs().max())
        assert err <= 1e-5
    a, b = res["one_prefill"][..., :V], res["mesh_prefill"][..., :V]
    assert float((a - b).abs().max() / a.abs().max()) <= 1e-5
