#!/usr/bin/env python3
"""Where the port's hand-written kernels spend their time: build variants of
the training sweep kernel K1 (``lda_sample.cu``), the phi-delta kernel K2
and the phi-rebuild kernel K4 (``phi_update.cu``) and the fold-in kernel K3
(``fold_in.cu``), timed on chip_smoke's two cells, one card.

    python3 kernel_probe.py
    python3 kernel_probe.py --smoke-of DIR   # DIR's chip_smoke.py, timed
                                             # with this checkout's time_ms
    python3 kernel_probe.py --serve-of DIR   # cold + warm serving bursts
                                             # through DIR's engine
    python3 kernel_probe.py --serve-sharded N   # V-sharded serving, N phi
                                                # blocks, one a card (else
                                                # round-robin over cards)
    python3 kernel_probe.py --pubmed-memory S1,S2,...   # peak device
                                                # memory of a PubMed-shaped
                                                # iteration at each scale

Each source is built several ways with ``-D``, one ``nvcc`` each, all
started together:

* K1: ``shipped``; ``one_tile_per_cta`` (``LDA_SAMPLE_TILES_PER_CTA=1``: p*
  and its search sums rebuilt for every tile); ``no_ell_loads``
  (``LDA_SAMPLE_PROBE=1``: no ELL row read, each run's scan and draws go
  over a row already in shared memory); ``no_runs`` (``LDA_SAMPLE_PROBE=2``:
  only the per-tile work);
* K2 and K4 (one source): ``shipped``; ``no_flush``
  (``PHI_UPDATE_PROBE=1``: the histograms are built but nothing is written
  to the (V, K) output besides its zeroing: K2's memset, K4's listed
  rows); ``no_hist`` (``PHI_UPDATE_PROBE=2``: the tokens are read, nothing
  is counted or written); for K4 also ``zero_only``
  (``PHI_UPDATE_PROBE=3``: the zeroing launch of the listed rows alone);
* K3: ``shipped``; ``no_draws`` (``FOLD_IN_PROBE=2``: the sweeps count
  theta, select the ELL and recount, but draw no token);
  ``no_pass_no_draws`` (``FOLD_IN_PROBE=3``: besides, no per-doc pass over
  the gathered rows for Q and the block sums).  Without draws z never
  moves, so the two no-draw builds do the same sweeps and differ by the
  per-doc pass alone (skipping the pass with draws on would change the
  draws).

Timed with ``chip_smoke.time_ms`` (20 launches back to back) on the same
inputs as chip_smoke: K3 at each serving bucket (B = 32, planted
NYTimes-width model), K1, K2 and K4 on the training cell's initial state
and on its state after 10 iterations.  One JSON line per kernel and state
gives the times and their differences.  The probe builds compute wrong
results; only their times are used.  Exits non-zero, with no result line,
without a card.
"""
from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

K1_VARIANTS = {
    "shipped": (),
    "one_tile_per_cta": ("LDA_SAMPLE_TILES_PER_CTA=1",),
    "no_ell_loads": ("LDA_SAMPLE_PROBE=1",),
    "no_runs": ("LDA_SAMPLE_PROBE=2",),
}
K2_VARIANTS = {
    "shipped": (),
    "no_flush": ("PHI_UPDATE_PROBE=1",),
    "no_hist": ("PHI_UPDATE_PROBE=2",),
}
K4_VARIANTS = dict(K2_VARIANTS, zero_only=("PHI_UPDATE_PROBE=3",))
K3_VARIANTS = {
    "shipped": (),
    "no_draws": ("FOLD_IN_PROBE=2",),
    "no_pass_no_draws": ("FOLD_IN_PROBE=3",),
}
BUILDS = ([("lda_sample", d) for d in K1_VARIANTS.values()]
          + [("phi_update", d) for d in K4_VARIANTS.values()]
          + [("fold_in", d) for d in K3_VARIANTS.values()])


def k1_report(card, state, args, kw, live):
    from repro_torch.kernels.lda_sample import kernel as k1

    ms = {name: cs.time_ms(lambda d=d: k1.sweep_variant(
        d, *args, ell_live=live, **kw)) for name, d in K1_VARIANTS.items()}
    cs.emit("k1_probe", card=card, state=state, ms=ms,
            ell_loads_ms=ms["shipped"] - ms["no_ell_loads"],
            run_work_without_loads_ms=ms["no_ell_loads"] - ms["no_runs"],
            tile_work_ms=ms["no_runs"],
            pstar_reuse_saves_ms=ms["one_tile_per_cta"] - ms["shipped"],
            k1_design=cs.k1_design(args, ms["shipped"], k1.tiles_per_cta()))


def k2_report(card, state, shard, z_new, z_old, V, K):
    import torch

    from repro_torch.kernels.phi_update import kernel as k24
    from repro_torch.kernels.phi_update import ops as phi_ops

    tm = shard.token_mask
    seg = phi_ops.shard_segments(shard)
    ms = {name: cs.time_ms(lambda d=d: k24.delta_variant(
        d, seg, z_new, z_old, tm, V, K)) for name, d in K2_VARIANTS.items()}
    n, t = z_new.shape
    out = torch.empty((V, K), dtype=torch.int32, device=z_new.device)
    memset_ms = cs.time_ms(out.zero_)
    cs.emit("k2_probe", card=card, state=state, ms=ms, memset_ms=memset_ms,
            moved_tokens=int(((z_new != z_old) & tm).sum()),
            flush_ms=ms["shipped"] - ms["no_flush"],
            hist_ms=ms["no_flush"] - ms["no_hist"],
            read_and_launch_ms=ms["no_hist"],
            bound=cs.bound(*cs.count_bytes_and_ops(
                n, t, z_new.element_size(), V, K, shard.num_tokens, True,
                cs.table_bytes(seg)), cs.INT32_OPS))


def k4_report(card, state, shard, z, V, K):
    import torch

    from repro_torch.kernels.phi_update import kernel as k24
    from repro_torch.kernels.phi_update import ops as phi_ops

    tm = shard.token_mask
    seg = phi_ops.shard_segments(shard)
    rows = phi_ops.shard_rows_to_zero(shard)
    ms = {name: cs.time_ms(lambda d=d: k24.update_variant(
        d, seg, rows, z, tm, V, K)) for name, d in K4_VARIANTS.items()}
    n, t = z.shape
    out = torch.empty((V, K), dtype=torch.int32, device=z.device)
    cs.emit("k4_probe", card=card, state=state, ms=ms,
            memset_ms=cs.time_ms(out.zero_), zeroed_rows=int(rows.shape[0]),
            flush_ms=ms["shipped"] - ms["no_flush"],
            hist_ms=ms["no_flush"] - ms["no_hist"],
            read_zero_and_launch_ms=ms["no_hist"],
            zero_launch_ms=ms["zero_only"],
            bound=cs.bound(*cs.count_bytes_and_ops(
                n, t, z.element_size(), V, K, shard.num_tokens, False,
                cs.table_bytes(seg, rows)), cs.INT32_OPS))


def k3_report(card):
    from repro_torch.configs import lda_nytimes
    from repro_torch.kernels.fold_in import kernel
    from repro_torch.launch import serve_lda

    V, K = lda_nytimes.FULL["num_words"], lda_nytimes.NUM_TOPICS
    snap = serve_lda.planted_snapshot(V, K, seed=0)
    _, home = serve_lda.planted_model(V, K, seed=0)
    docs, _ = serve_lda.planted_docs(home, K, cs.BATCH,
                                     lda_nytimes.FULL["avg_doc_len"], seed=1)
    burn_in, samples = cs.SWEEPS
    for L in cs.BUCKETS:
        args = cs.gathered_batch(snap, docs, L, seed=13,
                                 n_sweeps=sum(cs.SWEEPS))
        kw = dict(num_words_total=V, burn_in=burn_in, samples=samples,
                  ell_capacity=min(L, K))
        ms = {name: cs.time_ms(lambda d=d: kernel.fold_in_variant(
            d, *args, **kw)) for name, d in K3_VARIANTS.items()}
        C, warps = kernel.launch_shape(cs.BATCH, L, K, min(L, K))
        cs.emit("k3_probe", card=card, B=cs.BATCH, L=L, ctas_per_doc=C,
                warps_per_cta=warps, ms=ms,
                draws_ms=ms["shipped"] - ms["no_draws"],
                doc_pass_ms=ms["no_draws"] - ms["no_pass_no_draws"],
                sweeps_without_draws_ms=ms["no_pass_no_draws"])


def smoke_of(checkout) -> int:
    """Run another checkout's ``chip_smoke.py`` (the parent commit's, say)
    with this checkout's ``time_ms``, so that both trees' kernels are timed
    one way in one call.  Its own ``src`` goes first on the import path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "other_chip_smoke", Path(checkout).resolve() / "chip_smoke.py")
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    other.time_ms = cs.time_ms
    return other.main()


def serve_of(checkout) -> int:
    """One cold and ``chip_smoke.WARM_BURSTS`` warm bursts of chip_smoke's
    256 planted NYTimes-width documents through another checkout's serving
    engine (its own ``src`` first on the import path), each burst's p99
    and docs/s measured as chip_smoke measures this checkout's."""
    sys.path.insert(0, str(Path(checkout).resolve() / "src"))
    import numpy as np

    from repro_torch.configs import lda_nytimes
    from repro_torch.kernels import _build
    from repro_torch.launch import serve_lda

    _build.load("fold_in")      # built before the cold burst, as there
    V, K = lda_nytimes.FULL["num_words"], lda_nytimes.NUM_TOPICS
    snap = serve_lda.planted_snapshot(V, K, seed=0)
    _, home = serve_lda.planted_model(V, K, seed=0)
    docs, majors = serve_lda.planted_docs(
        home, K, cs.SERVE_DOCS, lda_nytimes.FULL["avg_doc_len"], seed=1)
    args = serve_lda.build_argparser().parse_args(
        ["--snapshot", "unused.npz", "--no-trace"])
    _, engine = serve_lda.make_engine(args, snap)
    try:
        cold = cs.burst(engine, docs, majors)
        warm = [cs.burst(engine, docs, majors)
                for _ in range(cs.WARM_BURSTS)]
    finally:
        engine.stop()
    p99s = [w["p99_ms"] for w in warm]
    rates = [w["docs_per_sec"] for w in warm]
    cs.emit("serve_bursts", checkout=str(checkout), card=cs.card_line(),
            cold=cold, warm=warm, p99_ms_median=float(np.median(p99s)),
            p99_ms_min=min(p99s), p99_ms_max=max(p99s),
            docs_per_sec_median=float(np.median(rates)),
            docs_per_sec_min=min(rates), docs_per_sec_max=max(rates))
    return 0


def crossed_bytes(sh, comm: str, B: int, L: int, capacity: int,
                  n_sweeps: int) -> int:
    """Bytes one batch's copies move between two different cards, from the
    copies ``serve/infer.py`` makes: psum sends the (B, L) int64 ids to each
    other card and brings back its (B, L, K) int32 partial; all2all sends
    each other card its doc slice's ids, mask, z0 and uniforms, every
    (requester, owner) pair on two cards a (C,) int32 bucket out and its
    (C, K) int32 rows back, and each slice's kept per-doc partials home.
    (The engine's ``comm_bytes_moved`` counts the reference's measure: a
    ring all-reduce for psum.)"""
    from repro_torch.distributed.partition import (doc_slice_bounds,
                                                   doc_slice_owner)

    K, lead, devs = sh.num_topics, sh.device, sh.devices
    if comm == "psum":
        return sum(B * L * 8 + B * L * K * 4 for d in devs if d != lead)
    _, Bs = doc_slice_bounds(B, len(devs))
    own, _ = doc_slice_owner(B, len(devs))
    total = 0
    for s, d in enumerate(devs):
        if d != lead:
            total += Bs * L * (8 + 1 + 4 + n_sweeps * 8)
            total += int((own == s).sum()) * (K * 4 + 8)
        total += sum(capacity * 4 + capacity * K * 4
                     for o in devs if o != d)
    return total


def device_work(fn, n=5) -> dict:
    """Kernels (and copies) a call of ``fn`` runs on the cards, their
    summed device time and the host's CUDA API calls, a call, from
    ``torch.profiler`` over ``n`` calls after one untraced call: beside
    ``time_ms`` it tells device work from gaps (many short kernels, or a
    call that waits on the device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    api: dict[str, int] = {}     # the host's CUDA runtime / driver calls
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("cu"):
            api[e.name] = api.get(e.name, 0) + 1
    return dict(kernels_per_call=len(dev) / n,
                kernel_ms_per_call=sum(e.time_range.elapsed_us()
                                       for e in dev) / n / 1e3,
                api_calls_per_call={k: c / n for k, c in sorted(
                    api.items(), key=lambda kv: -kv[1])})


def serve_sharded(n: int) -> int:
    """V-sharded serving of chip_smoke's planted NYTimes-width model in
    ``n`` phi blocks, one a card (round-robin over the cards when there
    are fewer): for the dense path on one card and for each comm, the
    device time of one B = 32, L = 256 batch (``time_ms``), the kernels it
    runs and their summed time (``device_work``), its wall time a call,
    the bytes it moves between cards, and an engine's cold and
    ``WARM_BURSTS`` warm bursts of the 256 docs (p99, docs/s,
    ``comm_bytes_moved``); then the parts on cuda:0 alone: psum's row
    assembly, one all2all slice's routed rows, and K3 on that slice beside
    K3 on the whole batch."""
    import numpy as np
    import torch

    from repro_torch.configs import lda_nytimes
    from repro_torch.kernels import _build
    from repro_torch.launch import serve_lda
    from repro_torch.distributed.partition import doc_slice_bounds
    from repro_torch.kernels.fold_in import kernel, ops
    from repro_torch.serve import InferConfig, shard_snapshot
    from repro_torch.serve import infer
    from repro_torch.serve.infer import (_host_batch_from_buffer,
                                         fold_in_request,
                                         pack_request_buffer, routing_plan)

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    card = cs.card_line()
    _build.load("fold_in")
    V, K = lda_nytimes.FULL["num_words"], lda_nytimes.NUM_TOPICS
    snap = serve_lda.planted_snapshot(V, K, seed=0)
    _, home = serve_lda.planted_model(V, K, seed=0)
    docs, majors = serve_lda.planted_docs(
        home, K, cs.SERVE_DOCS, lda_nytimes.FULL["avg_doc_len"], seed=1)
    sh = shard_snapshot(snap, n, devices=tuple(
        torch.device("cuda", i % cards) for i in range(n)))
    burn_in, samples = cs.SWEEPS
    B, L = cs.BATCH, cs.BUCKETS[-1]
    packed = pack_request_buffer(docs[:B], B, L, 23)
    buf = torch.from_numpy(packed).to(snap.device)
    plan = routing_plan(sh, *_host_batch_from_buffer(packed))
    rows = {}
    for comm, model in (("dense", snap), ("psum", sh), ("all2all", sh)):
        cfg = InferConfig(burn_in=burn_in, samples=samples,
                          comm="psum" if comm == "dense" else comm)

        def call():
            cap = None
            if comm == "all2all":
                cap = routing_plan(sh, *_host_batch_from_buffer(
                    packed)).capacity
            return fold_in_request(model, buf, cfg, seed=23, capacity=cap)

        walls = []
        for _ in range(20):
            t = time.perf_counter()
            call()
            for d in range(cards):
                torch.cuda.synchronize(d)
            walls.append((time.perf_counter() - t) * 1e3)
        args = serve_lda.build_argparser().parse_args(
            ["--snapshot", "unused.npz", "--no-trace", "--comm", cfg.comm])
        _, engine = serve_lda.make_engine(args, model)
        try:
            cold = cs.burst(engine, docs, majors)
            warm = [cs.burst(engine, docs, majors)
                    for _ in range(cs.WARM_BURSTS)]
            stats = engine.stats()
        finally:
            engine.stop()
        rows[comm] = dict(
            ms=cs.time_ms(call, hold=4), wall_ms=float(np.median(walls)),
            **device_work(call),
            crossed_bytes=(0 if comm == "dense" else crossed_bytes(
                sh, comm, B, L, plan.capacity, sum(cs.SWEEPS))),
            cold=cold,
            p99_ms_median=float(np.median([w["p99_ms"] for w in warm])),
            docs_per_sec_median=float(np.median(
                [w["docs_per_sec"] for w in warm])),
            recovered_min=min(w["recovered"] for w in [cold] + warm),
            batches=stats["batches"],
            comm_bytes_moved=stats["comm_bytes_moved"])
    # the parts, on cuda:0: psum's rows; slice 0's routed rows and its K3
    tokens, mask = infer._unpack_request_buffer(buf)
    tokens = tokens.long()
    _, Bs = doc_slice_bounds(B, n)
    rep0 = sh.replicas[0]
    gen = torch.Generator(device=snap.device)
    gen.manual_seed(5)
    z0, uni = ops.draw_fold_in_randoms(gen, B, L, K, sum(cs.SWEEPS),
                                       snap.device)
    kw = dict(num_words_total=V, burn_in=burn_in, samples=samples,
              ell_capacity=min(L, K))

    def k3_args(rows, b):
        return (rows, snap.phi_sum, snap.hyper,
                uni[:, :b].transpose(0, 1).contiguous(),
                mask[:b].to(torch.int32).contiguous(), z0[:b].contiguous())

    routed = infer._rows_routed(sh, rep0, tokens[:Bs], mask[:Bs],
                                plan.capacity)
    whole = snap.phi_vk[tokens]
    parts = dict(
        psum_rows_ms=cs.time_ms(lambda: infer._rows_psum(sh, tokens)),
        dense_gather_ms=cs.time_ms(lambda: snap.phi_vk[tokens]),
        slice_routed_rows_ms=cs.time_ms(lambda: infer._rows_routed(
            sh, rep0, tokens[:Bs], mask[:Bs], plan.capacity)),
        slice_k3_ms=cs.time_ms(lambda: kernel.fold_in_variant(
            (), *k3_args(routed, Bs), **kw)),
        slice_shape=kernel.launch_shape(Bs, L, K, min(L, K)),
        batch_k3_ms=cs.time_ms(lambda: kernel.fold_in_variant(
            (), *k3_args(whole, B), **kw)),
        batch_shape=kernel.launch_shape(B, L, K, min(L, K)))
    cs.emit("serve_sharded_cards", card=card, cards=cards, shards=n,
            devices=[str(d) for d in sh.devices], B=B, L=L, Bs=Bs,
            capacity=plan.capacity, routed_tokens=plan.routed_tokens,
            plan_a2a_bytes=plan.a2a_bytes, plan_psum_bytes=plan.psum_bytes,
            rows=rows, parts_on_cuda0=parts)
    print(card, flush=True)
    return 0


def pubmed_memory(scales) -> int:
    """Per PubMed-shaped scale: host seconds to build and tile, then the
    peak device memory (``max_memory_allocated``, reset before each step)
    of theta from z, theta -> ELL, one ``lda_iteration`` and one likelihood
    eval, each from the initial state, ``fit`` for two iterations with an
    eval after each, and the host's peak resident memory."""
    import resource

    import torch

    from repro_torch.configs import lda_pubmed
    from repro_torch.core import trainer, updates
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.kernels.phi_update import ops as phi_ops
    from repro_torch.train import fit

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    card = cs.card_line()
    dev = torch.device("cuda:0")
    total = torch.cuda.get_device_properties(dev).total_memory
    for s in scales:
        t0 = time.perf_counter()
        corpus = lda_pubmed.scaled(s, seed=0)
        t_corpus = time.perf_counter() - t0
        cfg = trainer.resolve_config(lda_pubmed.CONFIG, corpus)
        t0 = time.perf_counter()
        shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0]
        t_tile = time.perf_counter() - t0
        shard = shard.to(dev)
        phi_ops.shard_segments(shard)
        phi_ops.shard_rows_to_zero(shard)
        st = trainer.init_state(cfg, shard)
        torch.cuda.synchronize()
        K, D = cfg.num_topics, shard.num_docs_local
        P = cfg.ell_capacity
        dt = updates.ell_dtype(K, shard.max_doc_length)
        peaks = {"resident": torch.cuda.memory_allocated(dev)}

        def peak(name, fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated(dev)
            peaks[name + "_s"] = time.perf_counter() - t0
            return out

        theta = peak("theta_from_z", lambda: updates.theta_from_z(
            st.z, shard.token_doc, shard.token_mask, D, K))
        ell = peak("theta_to_ell",
                   lambda: updates.theta_to_ell(theta, P, dt))
        del ell, theta
        peak("lda_iteration", lambda: trainer.lda_iteration(cfg, shard, st))
        peak("lda_iteration_again",
             lambda: trainer.lda_iteration(cfg, shard, st))
        peak("log_likelihood",
             lambda: trainer.log_likelihood(cfg, shard, st))
        peak("fit_2_iterations", lambda: fit(
            corpus, lda_pubmed.CONFIG, 2, device=dev, shard=shard,
            eval_every=1))
        cs.emit("pubmed_memory", card=card, scale=s, docs=corpus.num_docs,
                V=corpus.num_words, tokens=corpus.num_tokens, P=P,
                ell_dtype=str(dt), max_doc_length=shard.max_doc_length,
                tiles=int(shard.token_doc.shape[0]), corpus_s=t_corpus,
                tiling_s=t_tile, total_memory=total, peaks=peaks,
                host_peak_rss_kb=resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss)
        del st, shard, corpus
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--pubmed-memory":
        return pubmed_memory([float(x) for x in sys.argv[2].split(",")])
    if len(sys.argv) == 3 and sys.argv[1] == "--smoke-of":
        return smoke_of(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-of":
        return serve_of(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-sharded":
        return serve_sharded(int(sys.argv[2]))
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch.configs import lda_nytimes
    from repro_torch.core import trainer
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.core.sampler import draw_sweep_uniforms
    from repro_torch.data.synthetic import nytimes_like
    from repro_torch.kernels import _build
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.train import fit

    card = cs.card_line()
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(BUILDS)) as pool:
        logs = list(pool.map(lambda b: _build.build(*b)[1], BUILDS))
    cs.emit("probe_build", seconds=time.perf_counter() - t0, ptxas={
        f"{name}{list(d)}": [ln.strip() for ln in log.splitlines()
                             if "registers" in ln]
        for (name, d), log in zip(BUILDS, logs)})

    k3_report(card)
    torch.cuda.empty_cache()

    corpus = nytimes_like(cs.TRAIN_SCALE, seed=0)
    cfg = trainer.resolve_config(lda_nytimes.CONFIG, corpus)
    shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0].to(dev)
    n, t = shard.token_doc.shape
    V, K = corpus.num_words, cfg.num_topics
    kw = dict(alpha=cfg.resolved_alpha(), beta=cfg.beta, num_words_total=V)

    def sweep_inputs(state, iteration):
        _, c, tp, _ = trainer.theta_and_ell(cfg, shard, state.z)
        u = draw_sweep_uniforms(trainer.iteration_generator(cfg, iteration,
                                                            dev), n, t)
        args = (shard.tile_word, shard.token_doc, shard.token_mask, state.z,
                state.phi_vk, state.phi_sum, c, tp, u)
        return args, k1_ops.live_lengths(c)

    for state_name in ("initial", "trained"):
        if state_name == "initial":
            st = trainer.init_state(cfg, shard)
            args, live = sweep_inputs(st, 0)
        else:
            st = fit(corpus, lda_nytimes.CONFIG, cs.TRAIN_ITERS, device=dev,
                     shard=shard, eval_every=cs.TRAIN_ITERS).state
            args, live = sweep_inputs(st, st.iteration)
        k1_report(card, state_name, args, kw, live)
        z_new = k1.lda_sample_tiles(*args, ell_live=live, **kw)[0]
        k2_report(card, state_name, shard, z_new, st.z, V, K)
        k4_report(card, state_name, shard, z_new, V, K)
        del args, live, z_new, st
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
