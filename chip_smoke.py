#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py

Drives the port's ported paths at the full width of the NYTimes
configuration (V = 101,636, K = 1024, alpha = 50/K, beta = 0.01) and holds
every CUDA kernel of those paths against its plain PyTorch version on the
card.  Phases, one JSON line each:

1. the card (``nvidia-smi`` name and power limit, torch's device name);
2. the build of every kernel from ``src/repro_torch/kernels/*/csrc`` with
   nvcc, one process per source, all started together, timed;

Serving (a planted model made from a seed; engine buckets B <= 32,
L in {32, 64, 128, 256}; 8 burn-in + 4 sample sweeps):

3. fold-in kernel (K3) against plain version at each L bucket, P = min(L,
   K), on the 256 served documents in batches of B = 32 (the launch shape
   the engine gives each bucket, printed beside its result), rows gathered
   from the planted model, same z0 and uniforms;
4. K3 and plain-version times at each L bucket, B = 32 (``time_ms``: CUDA
   events around 20 launches run back to back after 3 warm-up launches);
5. the serving main path: ``LDAServeEngine`` serves unseen documents drawn
   from the model (one cold burst), the same documents again in
   ``WARM_BURSTS`` warm bursts (each burst's p99 and docs/s, their median
   and spread: one cold burst's p99 spreads too widely to resolve a
   change), then hot-swaps a second planted model and serves more; K3's
   launch counter is read around it;
6. the same storm warm and traced: the host span breakdown;
16. V-sharded serving at the same width (run here, while the planted
    snapshots are live; numbered after the training phases it follows in
    the port's history): the planted model split into ``SHARDS`` word
    blocks, one a card when there are that many cards, else all on cuda:0
    (``placement``); one B = 32, L = 256 batch of the served docs through
    ``fold_in_sharded`` under psum and all2all against the dense
    ``fold_in`` on the same drawn (z0, uniforms), both through K3; each
    comm's device time (``time_ms``) and wall time a call (host routing
    plan + launches + synchronise) beside the dense call's; an engine per
    comm on the sharded snapshot (a cold and ``WARM_BURSTS`` warm bursts of
    the 256 docs, p99 and docs/s beside phase 5's), the all2all one then
    hot-swapped sharded -> dense -> sharded (the second planted model); a
    ``.sharded`` directory of the planted model written, read back and
    assembled, and read once more with one byte flipped.  K3's counter is
    read around the engines' runs and added to the kernels line.

Training (``configs/lda_nytimes.CONFIG`` on ``nytimes_like(1.0)``:
D = 299,752 docs, V = 101,636, ~99.5M tokens, Zipf 1.1):

7. host preparation: corpus, tiling, move to the card, K2's and K4's
   segment table and K4's list of rows to zero (built once per tiling);
   the ELL's element type (int16 where K and the longest document allow,
   C7);
8. the sweep kernel (K1) against its plain version: one sweep from the
   initial state and the same uniforms on the heaviest word's first 1024
   tiles and the last 1024 (tail) tiles, at full K and V, on the ELL the
   trainer builds (``trainer.theta_and_ell``);
9. the count kernels (K2 phi delta, K4 phi rebuild) against their plain
   versions at full V x K, after one full-width K1 sweep, K4 also into
   memory the allocator has just freed from a tensor of -1 (a row K4
   neither writes whole nor zeroes shows there);
10. K1, K2 and K4 times at full width (``time_ms``, 20 launches; the
    plain K1 3), each with its bound and, for K2 and K4, one
    ``index_add_`` as the library yardstick; K1 also with the bytes its
    design moves (``k1_design``: runs, mean run length, design bytes and
    the rate they were moved at);
11. the training main path: ``fit(corpus, CONFIG, 10)`` on cuda:0 with
    eval every iteration, then K4 rebuilds phi from the final z; the K1,
    K2 and K4 counters are read around both;
12. K1 against its plain version again, on the trained state (the same
    tiles as in 8);
13. where an iteration's time goes: each step of ``lda_iteration`` timed
    alone on the final state (``time_ms``, 5 calls), with K1's design
    bytes on that state;
14. ``torch.profiler`` over two steady ``lda_iteration`` calls on the final
    state: the device-busy share of the window and the ten kernels with the
    most device time (or ``device_time_visible: false`` when the trace
    holds no device time);

Training over a process group (one NCCL rank met through a ``file://``
store, a ("data",) ``DeviceMesh``; the group is destroyed at the end):

15. whether NCCL takes int16 (fault F4); one ``DistributedLDA.step`` on the
    phase-7 tiling against ``lda_iteration`` from phase 11's final state
    with the uniforms the single-device path draws there; that iteration's
    delta synced by the int32 all-reduce and by the int16 byte wire, each
    timed (``time_ms``), beside the bytes each wire sends per rank at
    G = 1 and G = 4; ``fit(corpus, CONFIG, 5, mesh)`` with
    ``compressed_sync`` off and on, each followed by K4 on its final z (the
    K1, K2 and K4 counters read around both and added to the kernels
    line), median tokens/s beside phase 11's; the 2d path on a (1, 1) mesh
    on ``nytimes_like(0.1)``, compressed, 3 iterations.

PubMed (``configs/lda_pubmed.CONFIG`` on ``lda_pubmed.scaled(PUBMED_SCALE)``
at full width, V = 141,043, K = 1024; the depth is cut to what one card
holds, see PERF.md):

17. host preparation (corpus, tiling, tables; seconds each, P and the ELL
    type); K1 against its plain version on the heaviest and tail tiles,
    K2 and K4 against theirs at full V x K; ``fit(corpus, CONFIG, 5)``
    with eval every iteration, then K4 on its final z, the K1, K2 and K4
    counters read around both; K1 against plain again on the trained state
    and each step of an iteration timed alone (with the ``theta_to_ell``
    share); the phase's peak device memory (``peak_bytes``, reset at its
    start);

The examples on the card:

18. ``examples/torch_quickstart.py`` and ``examples/torch_serve_lda.py``
    through their ``main`` at their default sizes on cuda:0, the four
    kernels' counters read around them.

Bounds (fault F2: the kernels' prefix sums are float32 adds in another
order than torch.cumsum's, so a draw on a float boundary may flip):

* K3, one sweep: draws differ on <= 1e-3 of real tokens; full run: the
  sparse-draw count and the argmax topic agree on >= 99% of documents, the
  mean per-document L1 distance of normalised theta is <= 0.02;
* K1, one sweep on the initial and on the trained state: draws differ on
  <= 1e-3 of real tokens, and the sparse share and the mean S/(S+Q) agree
  within 1e-3 absolute;
* K2 and K4: equal to their plain versions (integer counts, exact), K4
  also into memory last filled with -1, and phi_old + K2 == K4(z_new);
* serving: every theta sums to 1 (atol 1e-4), the planted major topic is
  recovered on >= 90% of documents in every burst, every answer after the
  swap carries the new model version, and K3 was launched;
* sharded serving: theta, top_topics, sparse_frac and mean_s_over_sq equal
  the dense fold-in's bit for bit under both comms; >= 90% recovery in
  every burst and after each swap, the version bumped by every swap; the
  engine's ``comm_bytes_moved`` equal to the sum of the bytes of the plans
  it made, one H2D copy a batch; K3 launched; the reloaded directory's phi
  equal to the model's, and the flipped byte refused
  (``SnapshotIntegrityError``);
* training: K1 and K2 launched once per iteration plus once for fit's
  warm-up iteration, the last LL/token above the first, phi == K4(z)
  exactly, phi_sum == phi.sum(0), phi.sum() == number of tokens, every z
  in [0, K);
* PubMed: as training (K1's flips <= 1e-3, K2 and K4 exact, K1 and K2
  launched once per iteration plus the warm-up, LL/token rising, phi ==
  K4(z), the sums), V = 141,043 and K = 1024;
* examples: both finish; the quickstart's LL/token rises through K1 and
  K2, the serving example launches K3 and swaps to version 3;
* over the group: the mesh step equal to ``lda_iteration`` (z, phi,
  phi_sum), the byte wire returning the delta exactly, both wires training
  the same state, phi == K4(z) after each full-width run, and in every
  mesh run K1 and K2 launched once per iteration plus the warm-up, the
  LL/token rising, phi_sum == phi.sum(0), phi.sum() == number of tokens.

Fails (non-zero exit, no result line) without a CUDA card, outside a
checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ONE_SWEEP_MISMATCH = 1e-3
DOC_AGREEMENT = 0.99
MEAN_THETA_L1 = 0.02
RECOVERY = 0.90
SUM_ATOL = 1e-4

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
INT32_OPS = FP32_FLOPS / 2     # Hopper SM: 64 INT32 lanes to 128 FP32 lanes

KERNELS = ("fold_in", "lda_sample", "phi_update")
TRAIN_FLIP_RATE = 1e-3
TRAIN_STAT_ATOL = 1e-3
CMP_TILES = 1024               # heaviest-word tiles and tail tiles each
TRAIN_SCALE = 1.0              # nytimes_like scale: the full NYTimes size
TRAIN_ITERS = 10
MESH_ITERS = 5                 # fit(mesh=...) at full width, each wire
MESH_2D_SCALE = 0.1            # the 2d (1 x 1) run's corpus
MESH_2D_ITERS = 3
PUBMED_SCALE = 0.75            # lda_pubmed.scaled: the depth one card holds
PUBMED_ITERS = 5

BATCH, BUCKETS, SWEEPS = 32, (32, 64, 128, 256), (8, 4)
SERVE_DOCS, SWAP_DOCS = 256, 32
WARM_BURSTS = 7                # the cold burst's docs again, engine warm
SHARDS = 4                     # phase 16's phi blocks
COMMS = ("psum", "all2all")


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0]


def burst(engine, docs, majors) -> dict:
    """One burst of ``docs`` through a warm engine: its p50 / p99 latency,
    docs/s over its wall time, and the share of planted topics
    recovered."""
    import numpy as np

    t0 = time.perf_counter()
    results = engine.infer_many(docs, timeout=300.0)
    wall = time.perf_counter() - t0
    lat = np.asarray([r["latency_ms"] for r in results])
    if not np.allclose([r["theta"].sum() for r in results], 1.0,
                       atol=SUM_ATOL):
        raise AssertionError("a served theta does not sum to 1")
    return dict(p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                docs_per_sec=len(docs) / wall,
                recovered=float(np.mean([int(r["theta"].argmax()) == m
                                         for r, m in zip(results, majors)])))


def gathered_batch(snap, docs, L, seed, n_sweeps):
    """Docs -> the fold-in kernel's inputs at one bucket, on the card."""
    import torch

    from repro_torch.kernels.fold_in import ops
    from repro_torch.serve.infer import pack_docs

    dev = snap.device
    tokens, mask = pack_docs(docs, L)
    tok = torch.from_numpy(tokens).to(dev).long()
    m = torch.from_numpy(mask).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    z0, uni = ops.draw_fold_in_randoms(gen, len(docs), L, snap.num_topics,
                                       n_sweeps, dev)
    return (snap.phi_vk[tok].contiguous(), snap.phi_sum, snap.hyper,
            uni.transpose(0, 1).contiguous(), m.to(torch.int32), z0)


def bytes_and_ops(args, n_sweeps, z_final):
    """The least work of one launch: each input read once and each output
    written once; float operations of the p* precompute (4 per real token
    and topic) and of the sparse sums and searches, counted with each
    doc's final number of live topics standing in for every sweep's."""
    phi_tok, phi_sum, hyper, uni, mask, z0 = args
    B, L, K = phi_tok.shape
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += B * K * 4 + B * 4 + B * 4 + B * L * 4          # outputs
    real = mask.sum(1)
    live = [len(set(z_final[b][mask[b] != 0].tolist())) for b in range(B)]
    ops = 4 * int(real.sum()) * K
    ops += sum(8 * int(real[b]) * live[b] for b in range(B)) * n_sweeps
    return nbytes, ops


def fold_in_vs_plain(snap, docs, L, V) -> dict:
    """K3 against its plain version at bucket L, on every batch of BATCH of
    ``docs`` (the engine's batches, so the kernel runs at the launch shape
    the serving path gives this bucket): the draws after one sweep from one
    start, and theta, the sparse share and the argmax topic after the full
    sweeps."""
    import torch

    from repro_torch.kernels.fold_in import kernel, ref

    K = snap.num_topics
    P = min(L, K)
    burn_in, samples = SWEEPS
    kw1 = dict(num_words_total=V, burn_in=0, samples=1, ell_capacity=P)
    kwf = dict(num_words_total=V, burn_in=burn_in, samples=samples,
               ell_capacity=P)
    flips = n_real = err = 0
    sp_eq, arg_eq, l1 = [], [], []
    ssq_rel, equal = 0.0, True
    for j, i in enumerate(range(0, len(docs), BATCH)):
        batch = docs[i:i + BATCH]
        one = gathered_batch(snap, batch, L, seed=11 + 2 * j, n_sweeps=1)
        k1 = kernel.fold_in_docs(*one, **kw1)
        r1 = ref.fold_in_docs_ref(*one, **kw1)
        real = one[4] != 0
        n_real += int(real.sum())
        flips += int(((k1[3] != r1[3]) & real).sum())
        full = gathered_batch(snap, batch, L, seed=12 + 2 * j,
                              n_sweeps=sum(SWEEPS))
        kf = kernel.fold_in_docs(*full, **kwf)
        rf = ref.fold_in_docs_ref(*full, **kwf)
        sp_eq.append(kf[1] == rf[1])
        arg_eq.append(kf[0].argmax(1) == rf[0].argmax(1))
        tk = kf[0].float() / kf[0].sum(1, keepdim=True).clamp(min=1)
        tr = rf[0].float() / rf[0].sum(1, keepdim=True).clamp(min=1)
        l1.append((tk - tr).abs().sum(1))
        err = max(err, int((kf[0] - rf[0]).abs().max()))
        ssq_rel = max(ssq_rel, float(((kf[2] - rf[2]).abs()
                                      / rf[2].abs().clamp(min=1e-30)).max()))
        equal = equal and bool(torch.equal(kf[0], rf[0]))
    return dict(B=BATCH, L=L, K=K, P=P, docs=len(docs),
                shape=kernel.launch_shape(BATCH, L, K, P),
                real_tokens=n_real, one_sweep_flips=flips,
                one_sweep_flip_rate=flips / n_real, theta_sum_equal=equal,
                sp_doc_agreement=float(torch.cat(sp_eq).float().mean()),
                argmax_doc_agreement=float(torch.cat(arg_eq).float().mean()),
                mean_theta_l1=float(torch.cat(l1).mean()),
                theta_sum_max_abs_err=err, ssq_max_rel_err=ssq_rel)


HOLD_CYCLES = 100_000_000      # ~57 ms of the card's clock: the host
#                                enqueues the timed calls meanwhile


def time_ms(fn, n=20, warm=3, hold=1):
    """Device time of one call of ``fn``: after ``warm`` calls, CUDA events
    around ``n`` calls run back to back, over n.  The stream is held by a
    spin kernel (``hold`` x ~57 ms) while the host enqueues them, so a
    kernel shorter than its Python launch path is timed on the card, not
    on the host (for a function that synchronises, the host's time stays
    in)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES * hold)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def slot_bytes(z) -> int:
    """K1's bytes per slot: token_doc, mask, z_old, the two uniforms read;
    z_new, the sparse flag and S/(S+Q) written."""
    return 4 + 1 + 2 * z.element_size() + 8 + 1 + 4


def run_starts(token_doc, mask):
    """(n, t) bool: the slots that start a run — a maximal stretch of a
    tile's real slots with one doc, whose tokens share S and the p1 prefix
    under delayed counts (K1 computes them once per run)."""
    first = mask.clone()
    first[:, 1:] &= ~(mask[:, :-1] & (token_doc[:, 1:] == token_doc[:, :-1]))
    return first


def search_steps(n):
    """Compares of a binary search for a count among n sorted prefixes."""
    import torch

    n = torch.as_tensor(n, dtype=torch.float64)
    return torch.ceil(torch.log2(n + 1))


def k1_bytes_and_ops(args, sparse, nb, bw):
    """The least work of one sweep (K1): each input read once, each output
    written once — of phi only the rows of the tiles' words, of the ELL only
    each present doc's live (non-zero) entries, counts and topics at the
    ELL's element size, and its live length; float operations: 4 per word
    and topic (p* and its prefix sums), 2 per live ELL entry once per run
    (S and the p1 prefix, shared by the run's tokens), and per real token
    2 for the side and a binary search's compares (over the live entries
    for a sparse draw, over nb block sums then bw in-block sums for a
    dense one)."""
    import torch

    (tile_word, token_doc, mask, z, phi, phi_sum, cnt, tpc, uni) = args
    n, t = z.shape
    K = phi.shape[1]
    live = (cnt > 0).sum(1)                                  # (D,)
    docs = torch.zeros_like(live, dtype=torch.bool)
    docs[token_doc[mask].long()] = True
    first = run_starts(token_doc, mask)
    run_live = live[token_doc[first].long()].to(torch.int64)
    tok_live = live[token_doc[mask].long()]
    sp = sparse[mask]
    words = int(torch.unique(tile_word).numel())
    nbytes = (n * 4 + n * t * slot_bytes(z) + words * K * 4 + K * 4
              + int(live[docs].sum()) * 2 * cnt.element_size()
              + int(docs.sum()) * 4)
    ops = (4 * K * words + 2 * int(run_live.sum()) + 2 * int(mask.sum())
           + int(search_steps(tok_live[sp]).sum())
           + int((~sp).sum()) * int(search_steps(nb) + search_steps(bw)))
    return nbytes, ops


def k1_design(args, ms, tiles_per_cta):
    """The bytes K1's design moves in one sweep, and the rate it moved them
    at in ``ms``: per run (``run_starts``) the doc's live ELL entries,
    counts and topics at the ELL's element size, and its live length; per
    slot what ``slot_bytes`` counts; per tile its word; a phi row (K int32)
    at each tile that starts a CTA's group of ``tiles_per_cta`` or changes
    the word within it.  Beside it the bytes of one warp per token reading
    its doc's row as int32 (8 B an entry) up to the 32-entry chunk that
    holds the row's first zero and a phi row per tile, the design this
    kernel replaced, by the same count."""
    import torch

    (tile_word, token_doc, mask, z, phi, phi_sum, cnt, tpc, uni) = args
    n, t = z.shape
    K, P = phi.shape[1], cnt.shape[1]
    live = (cnt > 0).sum(1).to(torch.int64)                  # (D,)
    first = run_starts(token_doc, mask)
    runs, real = int(first.sum()), int(mask.sum())
    run_live = int(live[token_doc[first].long()].sum())
    tok_live = live[token_doc[mask].long()]
    per_token = int(torch.clamp((tok_live // 32 + 1) * 32, max=P).sum())
    new_row = torch.ones_like(tile_word, dtype=torch.bool)
    new_row[1:] = tile_word[1:] != tile_word[:-1]
    new_row[::tiles_per_cta] = True
    phi_rows = int(new_row.sum())
    common = n * t * slot_bytes(z) + n * 4 + K * 4
    design = (run_live * 2 * cnt.element_size() + runs * 4 + common
              + phi_rows * K * 4)
    return dict(runs=runs, mean_run_tokens=real / max(runs, 1),
                mean_run_live=run_live / max(runs, 1),
                ell_dtype=str(cnt.dtype), phi_rows=phi_rows,
                design_bytes=design, design_gb_per_s=design / ms / 1e6,
                per_token_int32_bytes=per_token * 8 + common + n * K * 4)


def table_bytes(*tables) -> int:
    """The bytes of the tables a count kernel reads besides the tokens."""
    return sum(x.numel() * x.element_size() for x in tables)


def count_bytes_and_ops(n, t, z_bytes, V, K, real, delta: bool, tables):
    """K2 / K4: z (and z_old) and the mask read once, the segment table (and
    K4's list of rows to zero: ``tables`` bytes) read once, the (V, K)
    int32 output written once; one integer add per real token and z
    array."""
    nbytes = n * t * (z_bytes * (2 if delta else 1) + 1) + tables + V * K * 4
    return nbytes, real * (2 if delta else 1)


def bound(nbytes, ops, ops_rate):
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_rate * 1e3
    return dict(bytes=nbytes, ops=ops, bytes_ms=b_ms, ops_ms=o_ms,
                bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations")


def k1_vs_plain(full, kw, state: str) -> float:
    """One sweep of K1 and of its plain version from the same state and
    uniforms, on the heaviest word's first CMP_TILES tiles and the last
    CMP_TILES (tail) tiles; emits the comparison, raises past the bounds,
    and returns the largest S/(S+Q) error where the draws agree."""
    import torch

    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.kernels.lda_sample import ref as k1_ref

    n = full[0].shape[0]
    dev = full[0].device
    idx = (torch.arange(n, device=dev) if n <= 2 * CMP_TILES else
           torch.cat([torch.arange(CMP_TILES, device=dev),
                      torch.arange(n - CMP_TILES, n, device=dev)]))
    sl = tuple(a[idx].contiguous() if a.shape[0] == n else a for a in full)
    zk, spk, ssqk = k1_ops.launch_kernel(sl, **kw)
    zr, spr, ssqr = k1_ref.lda_sample_tiles_ref(*sl, **kw)
    torch.cuda.synchronize()
    m = sl[2]
    real = int(m.sum())
    flips = int(((zk != zr) & m).sum())
    same = (zk == zr) & m
    err = float((ssqk - ssqr)[same].abs().max())
    sp_diff = abs(float(spk[m].float().mean()) - float(spr[m].float().mean()))
    ssq_diff = abs(float(ssqk[m].mean()) - float(ssqr[m].mean()))
    emit("train_k1_vs_plain", state=state, tiles=int(idx.numel()),
         words=int(torch.unique(sl[0]).numel()), real_tokens=real,
         flips=flips, flip_rate=flips / real,
         sparse_share=float(spk[m].float().mean()),
         sparse_share_diff=sp_diff, mean_ssq=float(ssqk[m].mean()),
         mean_ssq_diff=ssq_diff, ssq_max_abs_err_where_equal=err)
    if flips / real > TRAIN_FLIP_RATE:
        raise AssertionError(f"K1 draws differ on {flips}/{real} tokens "
                             f"({state} state)")
    if sp_diff > TRAIN_STAT_ATOL or ssq_diff > TRAIN_STAT_ATOL:
        raise AssertionError(f"K1 sparse share / S-share differ by "
                             f"{sp_diff} / {ssq_diff} ({state} state)")
    return err


def profile_iterations(cfg, shard, state, iters: int) -> dict:
    """``torch.profiler`` (CPU and CUDA) over ``iters`` steady
    ``lda_iteration`` calls from ``state``, after one untraced warm-up.
    Returns the window's host wall time, the device-busy time (the union of
    the device events' intervals) and its share of the window, and the ten
    kernels with the most device time; ``device_time_visible`` is false
    when ``key_averages()`` holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import trainer

    trainer.lda_iteration(cfg, shard, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = state
        for _ in range(iters):
            st, _ = trainer.lda_iteration(cfg, shard, st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    visible = sum(e.self_device_time_total for e in prof.key_averages()) > 0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not (visible and dev):
        return dict(iterations=iters, window_ms=wall_ms,
                    device_time_visible=False)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                      # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in dev:
        ent = by_name.setdefault(e.name, [0, 0.0])
        ent[0] += 1
        ent[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    span_us = spans[-1][1] - spans[0][0]
    return dict(iterations=iters, window_ms=wall_ms,
                device_time_visible=True, device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e3 / wall_ms,
                device_span_ms=span_us / 1e3,
                busy_share_of_span=busy_us / span_us,
                top_kernels=[dict(name=k[:160], count=c, ms=us / 1e3)
                             for k, (c, us) in top])


def sync_bytes(V, K, G, wire: str) -> int:
    """Bytes a rank sends (and receives) to sync one (V, K) int32 delta
    over G ranks: a ring all-reduce moves 2 (G - 1) / G of the int32
    array; the byte wire (a reduce-scatter and an all-gather of the int16
    array) half that.  0 on one rank."""
    return int(2 * (G - 1) / G * V * K * (4 if wire == "int32" else 2))


def mesh_phases(card, corpus, shard, seg, rows, st, single_tps,
                counters) -> dict:
    """Phase 15: training over a one-rank NCCL group (a ``file://`` store)
    through ``fit(mesh=...)``; returns the K1 / K2 / K4 launches of its
    mesh runs.  ``shard``, ``seg``, ``rows`` are phase 7's tiling and
    tables, ``st`` phase 11's final state, ``single_tps`` its median
    tokens/s."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import lda_nytimes
    from repro_torch.core import sync, trainer, updates
    from repro_torch.data.synthetic import nytimes_like
    from repro_torch.distributed import partition
    from repro_torch.kernels.phi_update import ops as phi_ops
    from repro_torch.train import fit

    cfg = trainer.resolve_config(lda_nytimes.CONFIG, corpus)
    V, K = corpus.num_words, cfg.num_topics
    tw, tf, tm = shard.tile_word, shard.tile_first, shard.token_mask
    launched = {f.__name__: 0 for f in counters}

    def run(corp, c, iters, mesh, rebuild=None, **kw):
        """One mesh fit and, as phase 11 does, ``rebuild`` (K4 on its final
        z), the launches read around both; the counts and the LL
        checked."""
        for f in counters:
            f.launches = 0
        t0 = time.perf_counter()
        res = fit(corp, c, iters, mesh, eval_every=1, **kw)
        if rebuild is not None and not torch.equal(res.state.phi_vk,
                                                   rebuild(res.state.z)):
            raise AssertionError("phi != K4(z) after a mesh run")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {f.__name__: f.launches for f in counters}
        for k in launched:
            launched[k] += n[k]
        if n["lda_sample_tiles"] != iters + 1 or \
                n["phi_delta_tiles"] != iters + 1:
            raise AssertionError(f"mesh run: K1/K2 not launched once per "
                                 f"iteration (+1 warm-up): {n}")
        if not res.ll_per_token[-1] > res.ll_per_token[0]:
            raise AssertionError(f"mesh LL/token did not rise: "
                                 f"{res.ll_per_token}")
        s = res.state
        if not torch.equal(s.phi_sum, updates.phi_totals(s.phi_vk)) or \
                int(s.phi_vk.sum(dtype=torch.int64)) != corp.num_tokens:
            raise AssertionError("mesh run: phi_sum or phi.sum() is off")
        tps = res.tokens_per_sec
        return res, dict(iters=iters, compile_sec=res.compile_sec,
                         tokens_per_sec=tps,
                         median_tokens_per_sec=float(np.median(tps)),
                         ll_per_token=res.ll_per_token, launches=n,
                         wall_s=wall)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
            init_s = time.perf_counter() - t0
            try:             # fault F4: does NCCL take int16?
                x = torch.ones(4, dtype=torch.int16, device=shard.device)
                dist.all_reduce(x)
                torch.cuda.synchronize()
                int16 = "accepted"
            except (RuntimeError, TypeError, ValueError) as e:
                int16 = f"refused: {type(e).__name__}: {str(e)[:160]}"

            # one mesh step against lda_iteration, with the uniforms the
            # single-device path draws at phase 11's final state
            t0 = time.perf_counter()
            dl = partition.DistributedLDA(lda_nytimes.CONFIG, mesh, corpus,
                                          mode="1d", doc_axes=("data",),
                                          word_axes=())
            build_s = time.perf_counter() - t0
            same_tiling = all(torch.equal(getattr(dl.shard, f),
                                          getattr(shard, f))
                              for f in ("tile_word", "token_doc",
                                        "token_mask", "tile_first",
                                        "token_uid"))
            u = trainer.iteration_uniforms(cfg, st)
            a, _ = dl.step(st, u)
            b, _ = trainer.lda_iteration(cfg, shard, st, u)
            torch.cuda.synchronize()
            step_equal = (torch.equal(a.z, b.z)
                          and torch.equal(a.phi_vk, b.phi_vk)
                          and torch.equal(a.phi_sum, b.phi_sum))
            # one iteration's delta over the group: both wires, timed
            moved = int(((a.z != st.z) & tm).sum())
            delta = a.phi_vk - st.phi_vk
            heavy = torch.from_numpy(partition.heavy_word_rows(
                corpus, dl.plan)[0].astype(np.int64)).to(shard.device)
            wire_equal = torch.equal(
                sync.compressed_sync_phi(delta, dl.data_group, heavy), delta)
            d32 = delta.clone()
            sync_ms = dict(
                int32=time_ms(lambda: sync.sync_phi_delta(d32,
                                                          dl.data_group)),
                bytes=time_ms(lambda: sync.compressed_sync_phi(
                    delta, dl.data_group, heavy)))
            del dl, a, b, u, delta, d32
            emit("mesh_step", card=card, nccl_init_s=init_s,
                 nccl_int16=int16, partition_build_s=build_s,
                 same_tiling=same_tiling, step_equal=step_equal,
                 wire_equal=wire_equal, heavy_rows=int(heavy.numel()),
                 moved_tokens=moved, sync_ms=sync_ms,
                 sync_bytes_per_rank={w: sync_bytes(V, K, 1, w)
                                      for w in ("int32", "bytes")},
                 sync_bytes_per_rank_at_4={w: sync_bytes(V, K, 4, w)
                                           for w in ("int32", "bytes")})
            if not (same_tiling and step_equal and wire_equal):
                raise AssertionError("the mesh step differs from "
                                     "lda_iteration, or the byte wire from "
                                     "the delta")

            # fit(mesh=...) at full width, both wires
            def k4(z):
                return phi_ops.phi_update(tw, tf, z, tm, num_words=V,
                                          num_topics=K, segments=seg,
                                          zero_rows=rows)

            runs, first = {}, None
            for comp in (False, True):
                c = dataclasses.replace(lda_nytimes.CONFIG,
                                        compressed_sync=comp)
                res, runs["bytes" if comp else "int32"] = run(
                    corpus, c, MESH_ITERS, mesh, rebuild=k4)
                if runs["bytes" if comp else "int32"]["launches"][
                        "phi_update_tiles"] < 1:
                    raise AssertionError("K4 was not launched after a mesh "
                                         "run")
                z = res.state.z
                if first is None:
                    first = (z, res.state.phi_vk)
                elif not (torch.equal(first[0], z)
                          and torch.equal(first[1], res.state.phi_vk)):
                    raise AssertionError("the two wires trained different "
                                         "states")
                del res, z
            del first
            emit("mesh_train", card=card, runs=runs,
                 single_device_median_tokens_per_sec=single_tps,
                 mesh_over_single={k: r["median_tokens_per_sec"] / single_tps
                                   for k, r in runs.items()})

            # the 2d path on a 1 x 1 mesh, smaller corpus
            mesh2 = init_device_mesh("cuda", (1, 1),
                                     mesh_dim_names=("data", "model"))
            small = nytimes_like(MESH_2D_SCALE, seed=0)
            _, run2d = run(small, dataclasses.replace(
                lda_nytimes.CONFIG, compressed_sync=True), MESH_2D_ITERS,
                mesh2, mode="2d", doc_axes=("data",), word_axes=("model",))
            emit("mesh_train_2d", card=card, scale=MESH_2D_SCALE,
                 tokens=small.num_tokens, **run2d)
        finally:
            dist.destroy_process_group()
    return launched


def counts_vs_plain(phase, shard, seg, rows, state0, z1, V, K,
                    reuse: bool) -> tuple[int, int]:
    """K2 (z1 - state0.z) and K4 (z1) against their plain versions at full
    V x K, and state0.phi + K2 == K4(z1); with ``reuse``, K4 also into
    memory the allocator has just freed from a tensor of -1 (a row K4
    neither writes whole nor zeroes shows there).  Emits ``phase``, raises
    past exactness, returns (K2's, K4's max abs error)."""
    import torch

    from repro_torch.kernels.phi_update import kernel as k24
    from repro_torch.kernels.phi_update import ref as k24_ref

    tw, tf, tm = shard.tile_word, shard.tile_first, shard.token_mask
    dev = tm.device
    dk = k24.phi_delta_tiles(seg, z1, state0.z, tm, V, K)
    dr = k24_ref.phi_delta_tiles_ref(tw, tf, z1, state0.z, tm, V, K)
    ur = k24_ref.phi_update_tiles_ref(tw, tf, z1, tm, V, K)
    uk = k24.phi_update_tiles(seg, rows, z1, tm, V, K)
    torch.cuda.synchronize()
    k4_err = int((uk - ur).abs().max())
    update_equal = torch.equal(uk, ur)
    reused = extra = None
    if reuse:
        # K4 writes rows it does not zero: into memory the allocator has
        # just freed from a tensor of -1, a row it failed to own shows as -1s
        del uk
        torch.cuda.empty_cache()
        junk = torch.full((V, K), -1, dtype=torch.int32, device=dev)
        junk_ptr = junk.data_ptr()
        del junk
        uk = k24.phi_update_tiles(seg, rows, z1, tm, V, K)
        reused = uk.data_ptr() == junk_ptr
        torch.cuda.synchronize()
        k4_err = max(k4_err, int((uk - ur).abs().max()))
        extra = dict(update_equal_in_reused_memory=torch.equal(uk, ur),
                     reused_memory=reused)
    k2_err = int((dk - dr).abs().max())
    delta_equal, advance = torch.equal(dk, dr), torch.equal(
        state0.phi_vk + dk, uk)
    emit(phase, V=V, K=K, delta_equal=delta_equal, update_equal=update_equal,
         **(extra or {}), advance_exact=advance,
         moved_tokens=int(((z1 != state0.z) & tm).sum()),
         k2_max_abs_err=k2_err, k4_max_abs_err=k4_err)
    if not (delta_equal and update_equal and torch.equal(uk, ur)
            and advance):
        raise AssertionError("K2 / K4 differ from their plain versions")
    if reuse and not reused:
        raise AssertionError("K4's -1 check did not get the freed memory")
    return k2_err, k4_err


def trained_state_phases(card, cfg, shard, st, seg, kw, label: str,
                         phase: str):
    """On a trained state ``st``: K1 against its plain version
    (``k1_vs_plain``, state ``label``), then each step of ``lda_iteration``
    timed alone (``time_ms``, 5 calls) with K1's bound and design bytes on
    that state; emits ``phase``.  Returns (K1's largest S/(S+Q) error where
    the draws agree, the step times)."""
    import torch

    from repro_torch.core import trainer, updates
    from repro_torch.core.sampler import draw_sweep_uniforms, pick_search_block
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.kernels.phi_update import kernel as k24

    tw, tm = shard.tile_word, shard.token_mask
    n, t = tm.shape
    V, K = shard.num_words, cfg.num_topics
    nb, bw = K // pick_search_block(K), pick_search_block(K)
    # the two steps that build a (D, K) theta of their own are timed
    # before this one's theta exists (at PubMed's depth two do not fit)
    torch.cuda.empty_cache()
    ms = dict(
        theta_from_z=time_ms(lambda: updates.theta_from_z(
            st.z, shard.token_doc, tm, shard.num_docs_local, K), n=5, warm=1),
        log_likelihood=time_ms(lambda: trainer.log_likelihood(cfg, shard, st),
                               n=5, warm=1))
    theta, c, tp, _ = trainer.theta_and_ell(cfg, shard, st.z)
    P = c.shape[1]
    live = k1_ops.live_lengths(c)
    gen = trainer.iteration_generator(cfg, st.iteration, tm.device)
    u = draw_sweep_uniforms(gen, n, t)
    fin = (tw, shard.token_doc, tm, st.z, st.phi_vk, st.phi_sum, c, tp, u)
    err = k1_vs_plain(fin, kw, label)

    z2, sp2, _ = k1.lda_sample_tiles(*fin, ell_live=live, **kw)
    d2 = k24.phi_delta_tiles(seg, z2, st.z, tm, V, K)
    steps = dict(
        theta_to_ell=lambda: updates.theta_to_ell(theta, P, c.dtype),
        draw_uniforms=lambda: draw_sweep_uniforms(gen, n, t),
        live_lengths=lambda: k1_ops.live_lengths(c),
        k1_sweep=lambda: k1.lda_sample_tiles(*fin, ell_live=live, **kw),
        k2_phi_delta=lambda: k24.phi_delta_tiles(seg, z2, st.z, tm, V, K),
        phi_advance=lambda: updates.phi_totals(st.phi_vk + d2))
    ms.update({k: time_ms(f, n=5, warm=1) for k, f in steps.items()})
    it_ms = sum(v for k, v in ms.items() if k != "log_likelihood")
    emit(phase, card=card, iteration=st.iteration, ms=ms, iteration_ms=it_ms,
         shares={k: v / it_ms for k, v in ms.items()
                 if k != "log_likelihood"},
         k1_final_bound=bound(*k1_bytes_and_ops(fin, sp2, nb, bw),
                              FP32_FLOPS),
         k1_design=k1_design(fin, ms["k1_sweep"], k1.tiles_per_cta()),
         sparse_share=float(sp2[tm].float().mean()))
    del z2, sp2, d2, fin, u, theta, c, tp, live
    torch.cuda.empty_cache()
    return err, ms


def pubmed_phase(card: str, scale: float, iters: int, counters,
                 device="cuda:0") -> tuple[dict, int, int, float]:
    """Phase 17: ``configs/lda_pubmed.CONFIG`` on ``lda_pubmed.scaled(scale)``
    at full width (V = 141,043, K = 1024): host preparation, K1, K2 and K4
    against their plain versions on this tiling, ``fit`` for ``iters``
    iterations (the launches read around it), phi == K4(z), the step
    breakdown on the final state, and the peak device memory of the phase.
    Returns (the launches of its main path, K2's and K4's max abs error,
    K1's S/(S+Q) error)."""
    import numpy as np
    import torch

    from repro_torch.configs import lda_pubmed
    from repro_torch.core import trainer, updates
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.core.sampler import draw_sweep_uniforms
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.kernels.phi_update import ops as phi_ops
    from repro_torch.train import fit

    dev = torch.device(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    corpus = lda_pubmed.scaled(scale, seed=0)
    t_corpus = time.perf_counter() - t0
    cfg = trainer.resolve_config(lda_pubmed.CONFIG, corpus)
    t0 = time.perf_counter()
    shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0]
    t_tile = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard = shard.to(dev)
    seg = phi_ops.shard_segments(shard)
    rows = phi_ops.shard_rows_to_zero(shard)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    n, t = shard.token_doc.shape
    V, K, P = corpus.num_words, cfg.num_topics, cfg.ell_capacity
    ell = updates.ell_dtype(K, shard.max_doc_length)
    emit("pubmed_prep", card=card, scale=scale, docs=corpus.num_docs, V=V,
         K=K, P=P, tokens=corpus.num_tokens, tiles=n, tile_tokens=t,
         max_doc_length=shard.max_doc_length, ell_dtype=str(ell),
         corpus_s=t_corpus, tiling_s=t_tile, to_device_s=t_dev,
         k2_segments=int(seg.shape[0]), k4_rows_to_zero=int(rows.shape[0]))
    if V != lda_pubmed.FULL["num_words"] or K != lda_pubmed.NUM_TOPICS:
        raise AssertionError(f"PubMed is not at full width: V={V}, K={K}")

    # K1, K2 and K4 against their plain versions on this tiling
    state0 = trainer.init_state(cfg, shard)
    _, ell_c, ell_t, _ = trainer.theta_and_ell(cfg, shard, state0.z)
    live0 = k1_ops.live_lengths(ell_c)
    uni = draw_sweep_uniforms(trainer.iteration_generator(cfg, 0, dev), n, t)
    full = (shard.tile_word, shard.token_doc, shard.token_mask, state0.z,
            state0.phi_vk, state0.phi_sum, ell_c, ell_t, uni)
    kw = dict(alpha=cfg.resolved_alpha(), beta=cfg.beta, num_words_total=V)
    k1_err = k1_vs_plain(full, kw, "pubmed-initial")
    z1 = k1.lda_sample_tiles(*full, ell_live=live0, **kw)[0]
    k2_err, k4_err = counts_vs_plain("pubmed_counts_vs_plain", shard, seg,
                                     rows, state0, z1, V, K, reuse=False)
    del state0, ell_c, ell_t, live0, uni, full, z1
    torch.cuda.empty_cache()

    # the main path: fit, then K4 rebuilds phi from the final z
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    res = fit(corpus, lda_pubmed.CONFIG, iters, device=dev, shard=shard,
              eval_every=1)
    st = res.state
    rebuilt = phi_ops.phi_update(shard.tile_word, shard.tile_first, st.z,
                                 shard.token_mask, num_words=V, num_topics=K,
                                 segments=seg, zero_rows=rows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    tps = res.tokens_per_sec
    emit("pubmed_train", card=card, scale=scale, iters=iters,
         compile_sec=res.compile_sec, tokens_per_sec=tps,
         median_tokens_per_sec=float(np.median(tps)),
         ll_per_token=res.ll_per_token,
         sparse_frac=[x[0] for x in res.stats],
         mean_s_over_sq=[x[2] for x in res.stats], launches=launches,
         wall_s=wall, peak_bytes=peak,
         total_memory=torch.cuda.get_device_properties(dev).total_memory)
    if launches["lda_sample_tiles"] != iters + 1 or \
            launches["phi_delta_tiles"] != iters + 1 or \
            launches["phi_update_tiles"] < 1:
        raise AssertionError(f"PubMed: K1/K2 not launched once per iteration"
                             f" (+1 warm-up) or K4 never: {launches}")
    if not res.ll_per_token[-1] > res.ll_per_token[0]:
        raise AssertionError(f"PubMed LL/token did not rise: "
                             f"{res.ll_per_token}")
    if not (torch.equal(st.phi_vk, rebuilt)
            and torch.equal(st.phi_sum, updates.phi_totals(st.phi_vk))
            and int(st.phi_vk.sum(dtype=torch.int64)) == corpus.num_tokens
            and bool(((st.z >= 0) & (st.z < K)).all())):
        raise AssertionError("PubMed: phi != K4(z), or its sums or z are "
                             "off")
    del rebuilt
    err, _ = trained_state_phases(card, cfg, shard, st, seg, kw,
                                  "pubmed-trained", "pubmed_breakdown")
    return launches, k2_err, k4_err, max(k1_err, err)


def examples_phase(card: str, counters) -> dict:
    """Phase 18: ``examples/torch_quickstart.py`` and
    ``examples/torch_serve_lda.py`` through their ``main`` on cuda:0 at
    their default sizes; returns the launches of the four kernels in
    them."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_quickstart
    import torch_serve_lda

    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    quick = torch_quickstart.main([])
    t_quick = time.perf_counter() - t0
    quick_launches = {f.__name__: f.launches for f in counters}
    t0 = time.perf_counter()
    served = torch_serve_lda.main([])
    t_serve = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    emit("examples", card=card, quickstart_s=t_quick,
         quickstart_ll=quick.ll_per_token,
         quickstart_launches=quick_launches, serve_s=t_serve,
         serve_version=served["version"],
         serve_swapped_version=int(served["swapped"]["model_version"]),
         serve_perplexity=float(served["perplexity"].perplexity),
         launches=launches)
    if quick_launches["lda_sample_tiles"] < 1 or \
            quick_launches["phi_delta_tiles"] < 1:
        raise AssertionError(f"the quickstart missed K1/K2: {quick_launches}")
    if launches["fold_in_docs"] < 1:
        raise AssertionError("the serving example never launched K3")
    if not quick.ll_per_token[-1] > quick.ll_per_token[0]:
        raise AssertionError("the quickstart's LL/token did not rise")
    if served["version"] != 3 or not np.isfinite(
            served["perplexity"].perplexity):
        raise AssertionError("the serving example did not swap to v3")
    return launches


def train_phases(card: str, scale: float, iters: int,
                 device="cuda:0") -> list[dict]:
    """Phases 7-14; returns the kernels-line rows of K1, K2 and K4."""
    import numpy as np
    import torch

    from repro_torch.configs import lda_nytimes
    from repro_torch.core import trainer, updates
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.core.sampler import draw_sweep_uniforms, pick_search_block
    from repro_torch.data.synthetic import nytimes_like
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.kernels.lda_sample import ref as k1_ref
    from repro_torch.kernels.phi_update import kernel as k24
    from repro_torch.kernels.phi_update import ops as phi_ops
    from repro_torch.kernels.phi_update import ref as k24_ref
    from repro_torch.train import fit

    dev = torch.device(device)

    # -- 7. host preparation -------------------------------------------------
    t0 = time.perf_counter()
    corpus = nytimes_like(scale, seed=0)
    t_corpus = time.perf_counter() - t0
    cfg = trainer.resolve_config(lda_nytimes.CONFIG, corpus)
    t0 = time.perf_counter()
    shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0]
    t_tile = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard = shard.to(dev)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg = phi_ops.shard_segments(shard)      # K2's and K4's table, once
    torch.cuda.synchronize()
    t_seg = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = phi_ops.shard_rows_to_zero(shard)  # K4's rows to zero, once
    torch.cuda.synchronize()
    t_rows = time.perf_counter() - t0
    n, t = shard.token_doc.shape
    V, K, P = corpus.num_words, cfg.num_topics, cfg.ell_capacity
    nb, bw = K // pick_search_block(K), pick_search_block(K)
    emit("train_prep", scale=scale, docs=corpus.num_docs, V=V, K=K, P=P,
         tiles=n, tile_tokens=t, real_tokens=shard.num_tokens,
         slots=n * t, max_doc_length=shard.max_doc_length,
         ell_dtype=str(updates.ell_dtype(K, shard.max_doc_length)),
         corpus_s=t_corpus, tiling_s=t_tile, to_device_s=t_h2d,
         k2_segments=int(seg.shape[0]),
         k2_sole_segments=int(seg[:, 3].sum()),
         k2_segment_tiles=k24.segment_tiles(), k2_table_s=t_seg,
         k4_rows_to_zero=int(rows.shape[0]), k4_rows_s=t_rows)

    # -- 8. K1 against its plain version on heavy + tail tiles ---------------
    state0 = trainer.init_state(cfg, shard)
    _, ell_c, ell_t, _ = trainer.theta_and_ell(cfg, shard, state0.z)
    live0 = k1_ops.live_lengths(ell_c)
    uni = draw_sweep_uniforms(trainer.iteration_generator(cfg, 0, dev), n, t)
    full = (shard.tile_word, shard.token_doc, shard.token_mask, state0.z,
            state0.phi_vk, state0.phi_sum, ell_c, ell_t, uni)
    kw = dict(alpha=cfg.resolved_alpha(), beta=cfg.beta, num_words_total=V)
    k1_err = k1_vs_plain(full, kw, "initial")

    # -- 9. K2 and K4 against their plain versions at full V x K -------------
    z1, sp1, _ = k1.lda_sample_tiles(*full, ell_live=live0, **kw)
    tw, tf, tm = shard.tile_word, shard.tile_first, shard.token_mask
    k2_err, k4_err = counts_vs_plain("train_counts_vs_plain", shard, seg,
                                     rows, state0, z1, V, K, reuse=True)

    # -- 10. times at full width ---------------------------------------------
    words = tw.long()[:, None].expand(n, t)[tm]
    new_flat = words * K + z1[tm].long()
    old_flat = words * K + state0.z[tm].long()
    ones = torch.ones_like(new_flat, dtype=torch.int32)
    idx2, val2 = torch.cat([new_flat, old_flat]), torch.cat([ones, -ones])
    out_flat = torch.empty(V * K, dtype=torch.int32, device=dev)

    def library(ix, val):
        out_flat.zero_()
        out_flat.index_add_(0, ix, val)

    timing = {}
    timing["k1"] = dict(
        ms=time_ms(lambda: k1.lda_sample_tiles(*full, ell_live=live0, **kw)),
        plain_ms=time_ms(lambda: k1_ref.lda_sample_tiles_ref(
            *full, tiles_per_step=512, **kw), n=3, warm=1),
        **bound(*k1_bytes_and_ops(full, sp1, nb, bw), FP32_FLOPS))
    real_tok = shard.num_tokens
    timing["k2"] = dict(
        ms=time_ms(lambda: k24.phi_delta_tiles(seg, z1, state0.z, tm, V, K)),
        plain_ms=time_ms(lambda: k24_ref.phi_delta_tiles_ref(
            tw, tf, z1, state0.z, tm, V, K)),
        library_ms=time_ms(lambda: library(idx2, val2)),
        **bound(*count_bytes_and_ops(n, t, z1.element_size(), V, K, real_tok,
                                     True, table_bytes(seg)), INT32_OPS))
    timing["k4"] = dict(
        ms=time_ms(lambda: k24.phi_update_tiles(seg, rows, z1, tm, V, K)),
        plain_ms=time_ms(lambda: k24_ref.phi_update_tiles_ref(
            tw, tf, z1, tm, V, K)),
        library_ms=time_ms(lambda: library(new_flat, ones)),
        **bound(*count_bytes_and_ops(n, t, z1.element_size(), V, K, real_tok,
                                     False, table_bytes(seg, rows)),
                INT32_OPS))
    group = k1.tiles_per_cta()
    emit("train_timing", card=card, state="initial", **timing,
         k1_design=k1_design(full, timing["k1"]["ms"], group))
    del words, new_flat, old_flat, ones, idx2, val2, z1, sp1, uni, full
    del state0, ell_c, ell_t, live0
    torch.cuda.empty_cache()

    # -- 11. the training main path ------------------------------------------
    counters = (k1.lda_sample_tiles, k24.phi_delta_tiles,
                k24.phi_update_tiles)
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    res = fit(corpus, lda_nytimes.CONFIG, iters, device=dev, shard=shard,
              eval_every=1)
    st = res.state
    rebuilt = phi_ops.phi_update(tw, tf, st.z, tm, num_words=V, num_topics=K,
                                 segments=seg, zero_rows=rows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    tps = res.tokens_per_sec
    emit("train", card=card, iters=iters, compile_sec=res.compile_sec,
         tokens_per_sec=tps, median_tokens_per_sec=float(np.median(tps)),
         ll_per_token=res.ll_per_token,
         sparse_frac=[s[0] for s in res.stats],
         ell_overflow=[s[1] for s in res.stats],
         mean_s_over_sq=[s[2] for s in res.stats], launches=launches,
         wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(dev))
    if launches["lda_sample_tiles"] != iters + 1 or \
            launches["phi_delta_tiles"] != iters + 1:
        raise AssertionError(f"K1/K2 not launched once per iteration (+1 "
                             f"warm-up): {launches}")
    if launches["phi_update_tiles"] < 1:
        raise AssertionError("K4 was not launched on the training path")
    if not res.ll_per_token[-1] > res.ll_per_token[0]:
        raise AssertionError(f"LL/token did not rise: {res.ll_per_token}")
    if not torch.equal(st.phi_vk, rebuilt):
        raise AssertionError("phi != K4(z) after training")
    if not torch.equal(st.phi_sum, updates.phi_totals(st.phi_vk)):
        raise AssertionError("phi_sum != phi.sum(0)")
    if int(st.phi_vk.sum(dtype=torch.int64)) != corpus.num_tokens:
        raise AssertionError("phi.sum() != number of tokens")
    if not bool(((st.z >= 0) & (st.z < K)).all()):
        raise AssertionError("a topic assignment is outside [0, K)")

    # -- 12-13. K1 against plain on the trained state; the step breakdown ----
    err, _ = trained_state_phases(card, cfg, shard, st, seg, kw, "trained",
                                  "train_breakdown")
    k1_err = max(k1_err, err)

    # -- 14. a profiler trace of two steady iterations -----------------------
    emit("train_profile", card=card, **profile_iterations(cfg, shard, st, 2))

    # -- 15. training over a process group -----------------------------------
    mesh_launches = mesh_phases(card, corpus, shard, seg, rows, st,
                                float(np.median(tps)), counters)
    for k, v in mesh_launches.items():
        launches[k] += v

    def row(name, src, replaces, key, err, launched):
        k = timing[key]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k.get("library_ms")}

    ks = "src/repro_torch/kernels/"
    return [
        row("lda_sample_tiles", ks + "lda_sample/csrc/lda_sample.cu",
            "src/repro/kernels/lda_sample/kernel.py:194", "k1", k1_err,
            launches["lda_sample_tiles"]),
        row("phi_delta_tiles", ks + "phi_update/csrc/phi_update.cu",
            "src/repro/kernels/phi_update/kernel.py:81", "k2", k2_err,
            launches["phi_delta_tiles"]),
        row("phi_update_tiles", ks + "phi_update/csrc/phi_update.cu",
            "src/repro/kernels/phi_update/kernel.py:112", "k4", k4_err,
            launches["phi_update_tiles"]),
    ]


def sharded_phase(card, snap, snap2, docs, majors, docs2, majors2,
                  dense_warm: dict, devices=None) -> int:
    """Phase 16 (module docstring): V-sharded serving of the planted model
    at full width.  Returns K3's launches on the sharded engines' runs.
    ``devices``: the blocks' devices (by default the placement rule of the
    docstring; a CPU rehearsal passes CPU entries)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels.fold_in import kernel, ops
    from repro_torch.launch import serve_lda
    from repro_torch.serve import (InferConfig, SnapshotIntegrityError,
                                   load_sharded_snapshot,
                                   save_sharded_snapshot, shard_snapshot)
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.infer import (_host_batch_from_buffer,
                                         fold_in_config, fold_in_request,
                                         pack_docs, pack_request_buffer,
                                         routing_plan)

    if devices is not None:
        placement = "given: " + ", ".join(map(str, devices))
    elif torch.cuda.device_count() >= SHARDS:
        devices = tuple(torch.device("cuda", i) for i in range(SHARDS))
        placement = f"one block a card on cuda:0..{SHARDS - 1}"
    else:
        devices = (torch.device("cuda", 0),) * SHARDS
        placement = f"{SHARDS} blocks on cuda:0"
    t0 = time.perf_counter()
    sh = shard_snapshot(snap, SHARDS, devices=devices)
    sh2 = shard_snapshot(snap2, SHARDS, devices=devices)
    shard_s = (time.perf_counter() - t0) / 2

    # -- the sharded fold-in against the dense one, the same randoms -------
    burn_in, samples = SWEEPS
    Lb, K = BUCKETS[-1], snap.num_topics
    cfgs = {c: InferConfig(burn_in=burn_in, samples=samples, comm=c)
            for c in COMMS}
    tokens, mask = pack_docs(docs[:BATCH], Lb)
    gen = torch.Generator(device=snap.device)
    gen.manual_seed(17)
    randoms = ops.draw_fold_in_randoms(gen, BATCH, Lb, K, sum(SWEEPS),
                                       snap.device)
    dense = fold_in_config(snap, tokens, mask, randoms, cfgs["psum"])
    fields = ("theta", "top_topics", "sparse_frac", "mean_s_over_sq")
    equal, ssq_diff = {}, {}
    for comm, cfg in cfgs.items():
        got = fold_in_config(sh, tokens, mask, randoms, cfg)
        equal[comm] = {f: bool(torch.equal(getattr(got, f),
                                           getattr(dense, f)))
                       for f in fields}
        ssq_diff[comm] = float(got.mean_s_over_sq - dense.mean_s_over_sq)

    # -- device time and wall time a call, the engine's call path ----------
    packed = pack_request_buffer(docs[:BATCH], BATCH, Lb, 23)
    buf = torch.from_numpy(packed).to(snap.device)
    plan = routing_plan(sh, *_host_batch_from_buffer(packed))

    def call(s, comm):
        cap = None
        if comm == "all2all":     # the engine plans on the host each batch
            cap = routing_plan(s, *_host_batch_from_buffer(packed)).capacity
        return fold_in_request(s, buf, cfgs[comm], seed=23, capacity=cap)

    def wall_ms(fn, n=20):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return float(np.median(out))

    # a 4x hold: all2all's host path (3-8 ms a call) would outrun the
    # default one over 20 calls and time the host instead of the card
    timing = {"dense": dict(ms=time_ms(lambda: call(snap, "psum"), hold=4),
                            wall_ms=wall_ms(lambda: call(snap, "psum")))}
    for comm in COMMS:
        timing[comm] = dict(ms=time_ms(lambda: call(sh, comm), hold=4),
                            wall_ms=wall_ms(lambda: call(sh, comm)))
    emit("serve_sharded_fold_in", card=card, placement=placement,
         shards=SHARDS, devices=[str(d) for d in devices], B=BATCH, L=Lb,
         shard_s=shard_s, equal=equal, mean_s_over_sq_diff=ssq_diff,
         timing=timing, capacity=plan.capacity,
         routed_tokens=plan.routed_tokens, a2a_bytes=plan.a2a_bytes,
         psum_bytes=plan.psum_bytes)
    for comm, eq in equal.items():
        if not all(eq.values()):
            raise AssertionError(f"sharded fold-in ({comm}) differs from the "
                                 f"dense one: {eq}")

    # -- the main path: an engine per comm, then swaps across layouts ------
    planned = []     # the bytes of every plan the engines make
    real_plan, real_psum = engine_mod.routing_plan, engine_mod.psum_gather_bytes

    def plan_and_record(*a):
        p = real_plan(*a)
        planned.append(p.a2a_bytes)
        return p

    def psum_and_record(*a):
        planned.append(real_psum(*a))
        return planned[-1]

    engine_mod.routing_plan = plan_and_record
    engine_mod.psum_gather_bytes = psum_and_record
    kernel.fold_in_docs.launches = 0
    rows = {}
    try:
        for comm in COMMS:
            del planned[:]
            args = serve_lda.build_argparser().parse_args(
                ["--snapshot", "unused.npz", "--no-trace", "--comm", comm])
            model, engine = serve_lda.make_engine(args, sh)
            swaps = {}
            try:
                cold = burst(engine, docs, majors)
                warm = [burst(engine, docs, majors)
                        for _ in range(WARM_BURSTS)]
                if comm == "all2all":          # sharded -> dense -> sharded
                    for name, new in (("dense", snap2), ("sharded", sh2)):
                        v = model.publish(new)
                        res = engine.infer_many(docs2, timeout=300.0)
                        swaps[name] = dict(
                            version=v,
                            versions_ok=all(r["model_version"] == v
                                            for r in res),
                            recovered=float(np.mean(
                                [int(r["theta"].argmax()) == m
                                 for r, m in zip(res, majors2)])))
                stats = engine.stats()
            finally:
                engine.stop()
            p99s = [w["p99_ms"] for w in warm]
            rates = [w["docs_per_sec"] for w in warm]
            rows[comm] = dict(
                cold=cold, warm_p99_ms_median=float(np.median(p99s)),
                warm_p99_ms_min=min(p99s), warm_p99_ms_max=max(p99s),
                warm_docs_per_sec_median=float(np.median(rates)),
                warm_docs_per_sec_min=min(rates),
                warm_docs_per_sec_max=max(rates),
                recovered_min=min([cold["recovered"]]
                                  + [w["recovered"] for w in warm]),
                batches=stats["batches"],
                h2d_transfers=stats["h2d_transfers"],
                comm_bytes_moved=stats["comm_bytes_moved"],
                planned_bytes=float(sum(planned)), plans=len(planned),
                swaps=swaps)
    finally:
        engine_mod.routing_plan = real_plan
        engine_mod.psum_gather_bytes = real_psum
    launches = kernel.fold_in_docs.launches
    emit("serve_sharded", card=card, placement=placement, docs=len(docs),
         engines=rows, kernel_launches=launches,
         dense_warm_p99_ms_median=dense_warm["p99_ms_median"],
         dense_warm_docs_per_sec_median=dense_warm["docs_per_sec_median"])
    for comm, r in rows.items():
        if r["recovered_min"] < RECOVERY:
            raise AssertionError(f"{comm}: a sharded burst recovered "
                                 f"{r['recovered_min']} of planted topics")
        if r["comm_bytes_moved"] != r["planned_bytes"] or r["plans"] < 1:
            raise AssertionError(f"{comm}: comm_bytes_moved "
                                 f"{r['comm_bytes_moved']} != the plans' "
                                 f"{r['planned_bytes']}")
        if r["h2d_transfers"] != r["batches"]:
            raise AssertionError(f"{comm}: {r['h2d_transfers']} H2D copies "
                                 f"for {r['batches']} batches")
    versions = [s["version"] for s in rows["all2all"]["swaps"].values()]
    if versions != [2, 3] or not all(
            s["versions_ok"] and s["recovered"] >= RECOVERY
            for s in rows["all2all"]["swaps"].values()):
        raise AssertionError(f"hot-swaps: {rows['all2all']['swaps']}")
    if launches < 1:
        raise AssertionError("the sharded engines never launched K3")

    # -- the .sharded directory of the planted model ----------------------
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        path = save_sharded_snapshot(os.path.join(tmp, "planted.sharded"), sh)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_sharded_snapshot(path, devices=devices)
        read_s = time.perf_counter() - t0
        same = bool(torch.equal(back.assemble().phi_vk, snap.phi_vk)
                    and torch.equal(back.phi_sum, snap.phi_sum))
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        del back
        shard = os.path.join(path, "shard_0002.npz")
        raw = bytearray(open(shard, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(shard, "wb").write(bytes(raw))
        try:
            load_sharded_snapshot(path, devices=devices)
            refused = False
        except SnapshotIntegrityError:
            refused = True
    emit("serve_sharded_disk", card=card, write_s=write_s, read_s=read_s,
         bytes_on_disk=size, phi_equal=same, corrupt_refused=refused)
    if not (same and refused):
        raise AssertionError("the .sharded round trip failed")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs import lda_nytimes
    from repro_torch.kernels import _build
    from repro_torch.kernels.fold_in import kernel, ref
    from repro_torch.launch import serve_lda

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=card, torch_name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- 2. build every kernel from the checkout's sources -----------------
    t0 = time.perf_counter()
    logs = _build.build_all(KERNELS)
    emit("build", seconds=time.perf_counter() - t0, ptxas={
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in logs.items()})

    # -- planted NYTimes-width model on the card ----------------------------
    V = lda_nytimes.FULL["num_words"]
    K = lda_nytimes.NUM_TOPICS
    avg_len = lda_nytimes.FULL["avg_doc_len"]
    t0 = time.perf_counter()
    snap = serve_lda.planted_snapshot(V, K, seed=0)
    _, home = serve_lda.planted_model(V, K, seed=0)
    docs, majors = serve_lda.planted_docs(home, K, SERVE_DOCS, avg_len,
                                          seed=1)
    emit("model", V=V, K=K, phi_bytes=snap.phi_vk.numel() * 4,
         seconds=time.perf_counter() - t0)

    # -- 3. kernel against plain version at every bucket, full width -------
    max_abs_err = 0
    for Lb in BUCKETS:
        cmp = fold_in_vs_plain(snap, docs, Lb, V)
        emit("kernel_vs_plain", **cmp)
        max_abs_err = max(max_abs_err, cmp["theta_sum_max_abs_err"])
        where = f"at L = {Lb}, launch shape {cmp['shape']}"
        if cmp["one_sweep_flip_rate"] > ONE_SWEEP_MISMATCH:
            raise AssertionError(
                f"one-sweep draws differ on {cmp['one_sweep_flips']}/"
                f"{cmp['real_tokens']} {where}")
        sp_agree, arg_agree = (cmp["sp_doc_agreement"],
                               cmp["argmax_doc_agreement"])
        if sp_agree < DOC_AGREEMENT or arg_agree < DOC_AGREEMENT:
            raise AssertionError(
                f"doc agreement sp={sp_agree} argmax={arg_agree} {where}")
        if cmp["mean_theta_l1"] > MEAN_THETA_L1:
            raise AssertionError(f"mean theta L1 {cmp['mean_theta_l1']} > "
                                 f"{MEAN_THETA_L1} {where}")

    # -- 4. times at each L bucket, B = 32 ----------------------------------
    burn_in, samples = SWEEPS
    rows = []
    for Lb in BUCKETS:
        args = gathered_batch(snap, docs[:BATCH], Lb, seed=13,
                              n_sweeps=sum(SWEEPS))
        kwb = dict(num_words_total=V, burn_in=burn_in, samples=samples,
                   ell_capacity=min(Lb, K))
        z_final = kernel.fold_in_docs(*args, **kwb)[3].cpu()
        k_ms = time_ms(lambda: kernel.fold_in_docs(*args, **kwb))
        p_ms = time_ms(lambda: ref.fold_in_docs_ref(*args, **kwb))
        nbytes, ops = bytes_and_ops([a.cpu() for a in args], sum(SWEEPS),
                                    z_final)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
        rows.append(dict(B=BATCH, L=Lb, P=min(Lb, K), ms=k_ms, plain_ms=p_ms,
                         shape=kernel.launch_shape(BATCH, Lb, K,
                                                   min(Lb, K)),
                         bytes=nbytes, ops=ops, bytes_ms=b_ms, ops_ms=o_ms,
                         bound_ms=max(b_ms, o_ms),
                         bound_by="bytes" if b_ms >= o_ms else "operations"))
    emit("timing", card=card, buckets=rows)

    # -- 5. the main path: engine on the planted snapshot, then a hot-swap --
    args = serve_lda.build_argparser().parse_args(
        ["--snapshot", "unused.npz", "--no-trace"])
    model, engine = serve_lda.make_engine(args, snap)
    kernel.fold_in_docs.launches = 0
    t0 = time.perf_counter()
    try:
        results = engine.infer_many(docs, timeout=300.0)
        stats = engine.stats()
        warm = [burst(engine, docs, majors) for _ in range(WARM_BURSTS)]
        snap2 = serve_lda.planted_snapshot(V, K, seed=1)
        _, home2 = serve_lda.planted_model(V, K, seed=1)
        docs2, majors2 = serve_lda.planted_docs(home2, K, SWAP_DOCS, avg_len,
                                                seed=2)
        version = model.publish(snap2)
        results2 = engine.infer_many(docs2, timeout=300.0)
    finally:
        engine.stop()
    launches = kernel.fold_in_docs.launches
    wall = time.perf_counter() - t0
    theta = np.stack([r["theta"] for r in results + results2])
    recovered = float(np.mean([int(r["theta"].argmax()) == m
                               for r, m in zip(results, majors)]))
    recovered2 = float(np.mean([int(r["theta"].argmax()) == m
                                for r, m in zip(results2, majors2)]))
    lat = np.asarray([r["latency_ms"] for r in results])
    emit("serve", card=card, docs=len(results), batches=stats["batches"],
         mean_batch=stats["mean_batch"],
         truncated=int(sum(r["truncated"] for r in results)),
         p50_ms=float(np.percentile(lat, 50)),
         p90_ms=float(np.percentile(lat, 90)),
         p99_ms=float(np.percentile(lat, 99)),
         docs_per_sec=stats["docs_per_sec"], recovered=recovered,
         swap_version=version, swap_docs=len(results2),
         swap_recovered=recovered2, kernel_launches=launches,
         h2d_transfers=stats["h2d_transfers"], wall_s=wall)
    if not np.allclose(theta.sum(1), 1.0, atol=SUM_ATOL):
        raise AssertionError("a served theta does not sum to 1")
    if recovered < RECOVERY or recovered2 < RECOVERY:
        raise AssertionError(f"planted topic recovered on {recovered} / "
                             f"{recovered2} of docs")
    if any(r["model_version"] != version for r in results2):
        raise AssertionError("an answer after the swap has an old version")
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")
    p99s = [w["p99_ms"] for w in warm]
    rates = [w["docs_per_sec"] for w in warm]
    emit("serve_warm", card=card, docs=len(docs), bursts=warm,
         p99_ms_median=float(np.median(p99s)), p99_ms_min=min(p99s),
         p99_ms_max=max(p99s), docs_per_sec_median=float(np.median(rates)),
         docs_per_sec_min=min(rates), docs_per_sec_max=max(rates))
    if min(w["recovered"] for w in warm) < RECOVERY:
        raise AssertionError("a warm burst recovered too few planted topics")

    # -- 6. where the time goes: the same storm, warm and traced ------------
    args = serve_lda.build_argparser().parse_args(["--snapshot", "unused.npz"])
    model, engine = serve_lda.make_engine(args, snap2)
    try:
        engine.infer_many(docs2[:BATCH], timeout=300.0)      # warm
        engine.obs.tracer.clear()
        t0 = time.perf_counter()
        engine.infer_many(docs, timeout=300.0)
        traced_wall = time.perf_counter() - t0
    finally:
        engine.stop()
    spans = {}
    for ev in engine.obs.tracer.to_chrome()["traceEvents"]:
        if ev.get("ph") == "X":
            n, tot = spans.get(ev["name"], (0, 0.0))
            spans[ev["name"]] = (n + 1, tot + ev["dur"] / 1e3)
    emit("serve_traced", card=card, docs=len(docs), wall_s=traced_wall,
         spans={k: dict(count=n, total_ms=tot, mean_ms=tot / n)
                for k, (n, tot) in sorted(spans.items())})

    # -- 16. V-sharded serving at full width --------------------------------
    launches += sharded_phase(
        card, snap, snap2, docs, majors, docs2, majors2,
        dict(p99_ms_median=float(np.median(p99s)),
             docs_per_sec_median=float(np.median(rates))))

    main_row = rows[-1]
    k3_row = {
        "name": "fold_in_docs", "route": "cuda",
        "source": "src/repro_torch/kernels/fold_in/csrc/fold_in.cu",
        "replaces": "src/repro/kernels/fold_in/kernel.py:184",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}
    del snap, snap2, model, engine, args
    torch.cuda.empty_cache()

    train_rows = train_phases(card, TRAIN_SCALE, TRAIN_ITERS)
    torch.cuda.empty_cache()

    # -- 17. PubMed at full width ------------------------------------------
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.phi_update import kernel as k24
    train_counters = (k1.lda_sample_tiles, k24.phi_delta_tiles,
                      k24.phi_update_tiles)
    pm_launches, k2_err, k4_err, k1_err = pubmed_phase(
        card, PUBMED_SCALE, PUBMED_ITERS, train_counters)
    torch.cuda.empty_cache()

    # -- 18. the examples on the card ---------------------------------------
    ex_launches = examples_phase(card, (kernel.fold_in_docs,)
                                 + train_counters)
    k3_row["launches"] += ex_launches["fold_in_docs"]
    errs = dict(lda_sample_tiles=k1_err, phi_delta_tiles=k2_err,
                phi_update_tiles=k4_err)
    for row in train_rows:
        row["launches"] += pm_launches[row["name"]] + ex_launches[row["name"]]
        row["max_abs_err"] = max(row["max_abs_err"], errs[row["name"]])
    print(json.dumps({"kernels": [k3_row] + train_rows}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
