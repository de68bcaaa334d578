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
    python3 kernel_probe.py --lm-mesh-four      # phases 23 and 25 on four
                                                # cards, then a planted
                                                # fault against phase 25's
                                                # four-card loss gate
    python3 kernel_probe.py --lm-moe-four       # the expert-parallel MoE
                                                # on four cards: one layer
                                                # against one card's, a
                                                # planted fault, then
                                                # training at 16 layers
    python3 kernel_probe.py --lm-serve-four     # phase 26: serving over
                                                # a (1, 1) mesh, then on
                                                # four cards qwen3-4b's
                                                # decode and prefill on
                                                # (1, 4) and gemma2-27b's
                                                # long_500k on (2, 2), each
                                                # gated against one card
    python3 kernel_probe.py --ell               # the ELL kernel against
                                                # its plain version at
                                                # NYTimes' and PubMed's
                                                # shapes, on random, prior
                                                # and few-topic thetas:
                                                # bit for bit, and each
                                                # one's time
    python3 kernel_probe.py --lm-ssd-four       # phase 27, then the SSD
                                                # over four cards: the
                                                # N-sharded state layout
                                                # gated against one card
                                                # (float32) with a planted
                                                # fault, mamba2-130m on
                                                # (1, 4), the stand-in in
                                                # bf16 against one card

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

import json
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


ELL_SHAPES = (  # (cell, documents, K, mean length, P) as the benchmark's
    ("nytimes", 299_752, 1024, 332, 512),
    ("pubmed", 2_050_000, 1024, 90, 256))
# (name, Dirichlet alpha of a document's topic mixture; None: topics drawn
# uniformly, as the trainer's first step has them).  The configs' prior,
# alpha = 50 / K, spreads a document over ~100 topics; alpha / 50 gathers
# it on ~6, as training does, so that NYTimes' documents hold counts of
# 128 and more (the kernel's path for counts past its histogram).
ELL_TRAFFIC = (("random", None), ("prior", 50 / 1024),
               ("few_topics", 1 / 1024))
ELL_DOC_BLOCK = 1 << 18        # documents drawn at a time


def ell_theta(D: int, K: int, mean: float, alpha, seed: int, dev):
    """(D, K) int32 counts of Poisson(mean) documents whose tokens take
    topics uniformly (``alpha`` None) or from a Dirichlet(alpha) mixture of
    their own."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = torch.poisson(torch.full((D,), float(mean), device=dev),
                            generator=g).to(torch.int64)
    theta = torch.zeros((D, K), dtype=torch.int32, device=dev)
    if alpha is None:
        doc = torch.repeat_interleave(torch.arange(D, device=dev), lengths)
        z = torch.randint(0, K, doc.shape, device=dev, generator=g)
        theta.view(-1).index_add_(0, doc * K + z,
                                  torch.ones_like(z, dtype=torch.int32))
        return theta
    L = int(lengths.max())
    for d in range(0, D, ELL_DOC_BLOCK):
        m = min(ELL_DOC_BLOCK, D - d)
        mix = torch._standard_gamma(
            torch.full((m, K), alpha, device=dev), generator=g)
        cdf = mix.cumsum(1)
        cdf /= cdf[:, -1:]
        u = torch.rand((m, L), device=dev, generator=g)
        z = torch.searchsorted(cdf, u, right=True).clamp_(max=K - 1)
        live = torch.arange(L, device=dev) < lengths[d:d + m, None]
        theta[d:d + m].scatter_add_(1, z, live.to(torch.int32))
        del mix, cdf, u, z, live
    return theta


def ell_probe() -> int:
    """The ELL kernel (``kernels/ell_select``) at NYTimes' and PubMed's
    shapes, int16, on three thetas each (``ELL_TRAFFIC``): bit for bit
    against the plain version on the card, the kernel's and the plain
    version's device times (``chip_smoke.time_ms``), and the kernel's bound
    by bytes (theta read once, the ELL and its flag written once)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ell_select import kernel as ell
    from repro_torch.kernels.ell_select import ref as ell_ref

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    card = cs.card_line()
    dev = torch.device("cuda:0")
    _, log = _build.build("ell_select")
    cs.emit("ell_build", ptxas=[ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln])
    ok = True
    for cell, D, K, mean, P in ELL_SHAPES:
        for traffic, alpha in ELL_TRAFFIC:
            theta = ell_theta(D, K, mean, alpha, D, dev)
            got = ell.ell_select(theta, P, torch.int16)
            want = ell_ref.theta_to_ell_ref(theta, P, torch.int16)
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            ok = ok and equal
            del got, want
            kernel_ms = cs.time_ms(
                lambda: ell.ell_select(theta, P, torch.int16))
            plain_ms = cs.time_ms(
                lambda: ell_ref.theta_to_ell_ref(theta, P, torch.int16),
                n=5, warm=1)
            peak = theta.amax(1)
            cs.emit("ell", card=card, cell=cell, traffic=traffic,
                    alpha=alpha, docs=D, K=K, P=P, equal=equal,
                    max_nnz=int((theta > 0).sum(1).max()),
                    max_count=int(peak.max()),
                    docs_over_127=int((peak > 127).sum()),
                    kernel_ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=cs.ell_bytes(theta, P, torch.int16)
                    / cs.HBM_BYTES_PER_S * 1e3,
                    rows_per_block=ell.rows_per_block(K, P, torch.int16))
            del theta, peak
            torch.cuda.empty_cache()
    return 0 if ok else 1


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


def _dropped_reduce_rank(rank: int, layout: str, batch: int,
                         out_dir: str, moe_layers: int = 0) -> None:
    """``chip_smoke._lm_mesh_rank`` with a planted fault: in the forward of
    every step, the tp reduction of the first MLP's row-parallel output
    is skipped (its reduce-scatter along S under sequence parallelism:
    each rank keeps its block of its own partial sum; its all-reduce
    without), so each rank carries its own partial sum on (the backward's
    recomputation of that layer reduces as it should)."""
    from repro_torch.models import parallel, zoo

    seq_leave, loss_fn, dropped = parallel.seq_leave, zoo.loss_fn, [False]

    def faulty_leave(y, ctx, *, seq, split):
        if not dropped[0] and split and \
                sys._getframe(1).f_code.co_name == "mlp":
            dropped[0] = True
            return (parallel._Scatter.apply(y, parallel.SEQ_DIM, ctx)
                    if seq and ctx.tp_size > 1 else y)
        return seq_leave(y, ctx, seq=seq, split=split)

    def faulty_loss(*args, **kw):
        dropped[0] = False
        return loss_fn(*args, **kw)

    parallel.seq_leave, zoo.loss_fn = faulty_leave, faulty_loss
    cs._lm_mesh_rank(rank, layout, batch, out_dir, moe_layers)


def _replicated_residual_rank(rank: int, layout: str, batch: int,
                              out_dir: str, moe_layers: int = 0) -> None:
    """``chip_smoke._lm_mesh_rank`` with the policy's sequence parallelism
    off (the residual replicated over tp between layers): the same-call
    baseline of the sequence-sharded runs."""
    import dataclasses

    from repro_torch.launch import specs

    make = specs.make_policy

    def replicated(*args, **kw):
        return dataclasses.replace(make(*args, **kw), sp=False)

    specs.make_policy = replicated
    cs._lm_mesh_rank(rank, layout, batch, out_dir, moe_layers)


def lm_mesh_four_probe() -> int:
    """Phase 23, then phase 25, which on four cards runs ``lm_mesh_four``
    and its gate on the (1, 4) mesh's B = 1 losses (the residual
    sequence-sharded over tp); the same configurations with the residual
    replicated (``_replicated_residual_rank``), gated the same way; then
    (1, 4) at B = 1 once more with ``_dropped_reduce_rank``'s planted
    fault, which the gate must catch.  Exits 0 only when it does."""

    import torch

    if torch.cuda.device_count() < 4:
        print("kernel_probe --lm-mesh-four: needs four cards",
              file=sys.stderr)
        return 2
    card = cs.card_line()
    torch.empty(1, device="cuda:0")    # memory stats need the allocator
    losses = cs.qwen_train_phase(card)[:cs.MESH_LM_STEPS]
    rows = cs.lm_mesh_phase(card, losses)
    keys = ("layout", "mesh", "batch", "sp", "ms_per_step", "tokens_per_s",
            "mfu",
            "mfu_reference_count", "peak_bytes_per_card",
            "loss_rel_diff_vs_one_card")
    print(json.dumps({"phase": "lm_mesh_four_summary",
                      "rows": [{k: r.get(k) for k in keys} for r in rows]}),
          flush=True)
    base = cs.lm_mesh_four(card, losses, rank_fn=_replicated_residual_rank)
    print(json.dumps({"phase": "lm_mesh_four_replicated_summary",
                      "rows": [{k: r.get(k) for k in keys} for r in base]}),
          flush=True)
    try:
        cs.lm_mesh_four(card, losses, configs=(("production", 1),),
                        rank_fn=_dropped_reduce_rank)
    except AssertionError as exc:
        print(json.dumps({"phase": "planted_fault", "caught": True,
                          "bound": cs.MESH_FOUR_LOSS_REL,
                          "message": str(exc)}), flush=True)
        print(card, flush=True)
        return 0
    print(json.dumps({"phase": "planted_fault", "caught": False,
                      "bound": cs.MESH_FOUR_LOSS_REL}), flush=True)
    return 1


MOE_GATE_CF = 8.0      # no routing dropped on one card or on the mesh
MOE_GATE_REL = 1e-2    # (1, 4) against one card, of the output's scale


def moe_layer_gate(dev, out_dir: str, planted: bool, cfg) -> None:
    """One rank of the one-layer gate on a (1, 4) mesh: one MoE layer of
    ``cfg``, every rank drawing the same weights and (1, 4096, d_model)
    input from the seed on ``dev`` and keeping its quarter of the experts;
    rank 0 also runs ``moe_ffn_local`` on all of them and writes the
    largest difference over the output's scale.  ``planted``: the return
    all-to-all's block from peer 1 (the outputs of its experts) comes back
    zeroed."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import make_policy
    from repro_torch.models import moe, parallel

    mesh = make_production_mesh(4)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    full = moe.init_moe(cfg, g)
    x = torch.randn((1, cs.QWEN_TRAIN_S, cfg.d_model), generator=g,
                    device=dev).to(cfg.dtype)
    policy = make_policy(mesh, 1)
    coord, size = parallel.mesh_coords(mesh, dist.get_rank())
    p = parallel.shard_tree(full, moe.moe_specs(cfg, policy), coord, size)
    if planted:
        real = moe._from_owners

        def from_owners(ye, ctx):
            out = real(ye, ctx).clone()
            n = out.shape[0] // ctx.tp_size
            out[n:2 * n] = 0
            return out

        moe._from_owners = from_owners
    with torch.no_grad():
        y = moe.moe_ffn(p, cfg, x, policy=policy).float()
        if dist.get_rank() == 0:
            ref = moe.moe_ffn_local(full, cfg, x).float()
            scale = float(ref.abs().max())
            Path(out_dir, "gate.json").write_text(json.dumps(dict(
                rel_err=float((y - ref).abs().max()) / scale, scale=scale,
                shape=list(y.shape), planted=planted)))


def _moe_layer_rank(rank: int, out_dir: str, planted: bool) -> None:
    """``moe_layer_gate`` on card ``rank``: the MoE at full width, one
    layer, capacity factor MOE_GATE_CF (bf16)."""
    import dataclasses

    import torch

    cfg = dataclasses.replace(cs.moe_config(1), capacity_factor=MOE_GATE_CF)
    moe_layer_gate(torch.device("cuda", torch.cuda.current_device()),
                   out_dir, planted, cfg)


def lm_moe_four_probe() -> int:
    """The expert-parallel MoE on four cards: the one-layer gate
    (``_moe_layer_rank``) clean and with its planted fault, which the gate
    must catch; then ``lm_mesh_four`` on the MoE cut to
    ``MOE_LAYERS_FOUR`` layers.  Exits 0 only when the gate passes clean
    and catches the fault."""
    import tempfile

    import torch

    from repro_torch.distributed import launch

    if torch.cuda.device_count() < 4:
        print("kernel_probe --lm-moe-four: needs four cards", file=sys.stderr)
        return 2
    card = cs.card_line()
    gate = {}
    for planted in (False, True):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            launch.spawn(_moe_layer_rank, 4, args=(tmp, planted),
                         device_type="cuda", store_dir=tmp,
                         timeout_s=cs.MESH_COLLECTIVE_TIMEOUT_S)
            gate[planted] = json.loads(Path(tmp, "gate.json").read_text())
        gate[planted]["seconds"] = time.perf_counter() - t0
    passed = gate[False]["rel_err"] <= MOE_GATE_REL
    caught = gate[True]["rel_err"] > MOE_GATE_REL
    cs.emit("moe_ep_gate", card=card, bound=MOE_GATE_REL, clean=gate[False],
            planted=gate[True], passed=passed, caught=caught)
    rows = cs.lm_mesh_four(card, None, moe_layers=cs.MOE_LAYERS_FOUR)
    keys = ("layout", "mesh", "batch", "layers", "params", "ms_per_step",
            "tokens_per_s", "mfu", "peak_bytes_per_card",
            "reckoned_bytes_per_card", "dropped_share", "losses", "profile")
    print(json.dumps({"phase": "lm_moe_four_summary",
                      "rows": [{k: r.get(k) for k in keys} for r in rows]}),
          flush=True)
    print(card, flush=True)
    return 0 if passed and caught else 1


def lm_serve_four_probe() -> int:
    """Phase 26 alone (``chip_smoke.lm_serve_mesh_phase``): the (1, 1) mesh
    against one device, then ``lm_serve_four`` on four cards, with a
    summary line of every rank's numbers."""
    import torch

    if torch.cuda.device_count() < 4:
        print("kernel_probe --lm-serve-four: needs four cards",
              file=sys.stderr)
        return 2
    card = cs.card_line()
    torch.empty(1, device="cuda:0")    # memory stats need the allocator
    rows = cs.lm_serve_mesh_phase(card)
    keys = ("ms_per_step", "tokens_per_s", "bound_ms", "peak_bytes",
            "nccl_bytes_per_step", "act_share", "kv_cache_bytes",
            "weight_bytes", "init_s")
    summary = []
    for row in rows:
        for r in row["ranks"]:
            d = r["decode"]
            summary.append(dict(
                arch=r["arch"], mesh=r["mesh"], rank=r["rank"],
                gate=r["gate"], decode={k: d[k] for k in keys},
                busy_share=d["profile"].get("busy_share"),
                nccl_device_ms=d["profile"].get("nccl_device_ms"),
                prefill=None if "prefill" not in r else {
                    k: r["prefill"][k] for k in ("ms", "tokens_per_s",
                                                 "bound_ms", "peak_bytes",
                                                 "nccl_bytes")}))
    print(json.dumps({"phase": "lm_serve_four_summary", "rows": summary}),
          flush=True)
    print(card, flush=True)
    return 0


# The SSD's state layout on four cards: mamba2-130m's P = 64, N = 128 and
# chunk 64 at d_model = 800 (2 layers), so H = 25 does not divide over 4
# while H * P = 1,600 and N do
SSD_STAND_IN = dict(d_model=800, num_layers=2)
SSD_GATE_B, SSD_GATE_S, SSD_GATE_STEPS = 2, 512, 8
SSD_LOSS_REL, SSD_GRAD_REL, SSD_OUT_REL = 1e-5, 1e-4, 1e-5
SSD_STATE_ATOL = 1e-6
SSD_BF16_B = 8                 # the bf16 stand-in's batch, S = 4096
SSD_DECODE_B, SSD_DECODE_STEPS = 32, 64   # mamba2-130m's decode on (1, 4)


def ssd_stand_in(dtype):
    import dataclasses

    from repro_torch.configs.archs import ARCHS

    return dataclasses.replace(ARCHS[cs.MAMBA_ARCH], dtype=dtype,
                               **SSD_STAND_IN)


def _rel(got, want) -> float:
    """max |got - want| over max |want|, in float64 on the host."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def ssd_state_gate(dev, planted: bool, cfg=None) -> dict | None:
    """One rank of the SSD's state-layout gate on a (1, 4) mesh, float32
    with TF32 off: every rank draws the stand-in's weights, a batch of
    ``lm_batches`` and a stand-in decode state from the seed on ``dev``
    and keeps its shards; the mesh's ``loss_and_grads``, then (but for
    ``planted``) a prefill's logits, the first layer's mixer on this
    rank's block of a random input (its output and ``h_last``, the
    decode state's N shard), SSD_GATE_STEPS decode steps on the N-sharded
    state and one ``train_step``, each gathered.  Rank 0 runs each on the
    whole model and returns the differences (None on the other ranks).
    ``planted``: ``dt_bias`` read by each rank's share of the core without
    ``copy_in``, so its gradient stays that rank's share."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.loader import lm_batches
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import make_policy
    from repro_torch.models import convert, parallel, zoo
    from repro_torch.models import recurrent as rec
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import P
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or ssd_stand_in(torch.float32)
    mesh = make_production_mesh(4)
    lead = dist.get_rank() == 0
    B, S, V = SSD_GATE_B, SSD_GATE_S, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    whole = tf.init_params(cfg, gen)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             lm_batches(V, B, S, seed=cs.SEED)(0).items()}
    pol = make_policy(mesh, B)
    specs = tf.param_specs(cfg, pol)
    coord, size = parallel.mesh_coords(mesh, dist.get_rank())
    shard = lambda tree, sp: parallel.shard_tree(  # noqa: E731
        tree, sp, coord, size)
    local = shard(whole, specs)
    rows = parallel.dp_rows(batch, pol.ctx)
    plan = rec.ssd_plan(cfg, pol)
    out = dict(planted=planted, layout=plan.layout, chan=plan.chan)
    real = rec._ssd_local
    if planted:
        rec._ssd_local = lambda p, *a: real(p, *a)._replace(
            dt_bias=p.dt_bias)
    try:
        loss, grads = zoo.loss_and_grads(local, cfg, rows, policy=pol)
    finally:
        rec._ssd_local = real
    grads = convert.flatten(parallel.gather_tree(grads, specs, pol.ctx))
    if lead:
        ref_loss, ref_grads = zoo.loss_and_grads(whole, cfg, batch)
        errs = {k: _rel(grads[k], g)
                for k, g in convert.flatten(ref_grads).items()}
        out.update(loss=float(loss), ref_loss=float(ref_loss),
                   loss_rel_err=abs(float(loss) - float(ref_loss))
                   / abs(float(ref_loss)),
                   grad_rel_err=max(errs.values()),
                   dt_bias_grad_rel_err=max(
                       v for k, v in errs.items() if k.endswith("dt_bias")),
                   grad_rel_err_but_dt_bias=max(
                       v for k, v in errs.items()
                       if not k.endswith("dt_bias")))
    if planted:
        return out if lead else None
    # a prefill, and the first layer's mixer on this rank's block
    pre = make_policy(mesh, B, "prefill")
    params = shard(whole, tf.param_specs(cfg, pre))
    logits = parallel.gather_full(
        zoo.make_prefill_step(cfg, policy=pre)(
            params, parallel.dp_rows({"tokens": batch["tokens"]}, pre.ctx)),
        P(pre.batch(), None, pre.tp), pre.ctx)
    lay = pre.with_sequence(S)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    x_loc = parallel.dp_rows({"x": x}, pre.ctx)["x"]
    if lay.seq:
        x_loc = parallel.tp_slice(x_loc, 1, lay.ctx)
    with torch.no_grad():
        y, st = rec.ssd(tf.block(params.blocks[0], 0).mixer, cfg, x_loc,
                        policy=lay)
    if lay.seq:
        y = parallel.tp_gather(y, 1, lay.ctx)
    y = parallel.gather_full(y, P(lay.batch(), None, None), lay.ctx)
    h_shape = list(st.h.shape)
    h = parallel.gather_full(st.h, rec.ssd_state_spec(cfg, lay).h, lay.ctx)
    # decode on the N-sharded state
    dec = make_policy(mesh, B, "decode")
    d_specs = zoo.serving_state_specs(cfg, dec)
    params = shard(whole, tf.param_specs(cfg, dec))
    seed = lambda: torch.Generator(device=dev).manual_seed(  # noqa: E731
        cs.SEED + 1)
    state = zoo.init_decode_state(cfg, B, SSD_GATE_STEPS, generator=seed(),
                                  dtype=torch.float32, policy=dec)
    state_shape = list(state.layer_states[0].h.shape)
    toks = torch.randint(0, V, (B, SSD_GATE_STEPS), generator=gen,
                         device=dev)
    step = zoo.make_decode_step(cfg, policy=dec)
    dec_logits = []
    for i in range(SSD_GATE_STEPS):
        lg, state = step(params, state, parallel.dp_rows(
            {"t": toks[:, i:i + 1]}, dec.ctx)["t"])
        dec_logits.append(parallel.gather_full(
            lg, P(dec.batch(), None, dec.tp), dec.ctx))
    dec_state = convert.flatten(convert.gather_decode_state(
        state, d_specs, mesh))
    # one train step (the params updated in place: the mesh's first)
    tstate = zoo.TrainState(local, adamw.init(local))
    tstate, m = zoo.make_train_step(cfg, policy=pol)(tstate, rows)
    got = convert.flatten(convert.gather_train_state(tstate, specs, mesh))
    if not lead:
        return None
    with torch.no_grad():
        ry, rst = rec.ssd(tf.block(whole.blocks[0], 0).mixer, cfg, x)
    ref_pre = zoo.make_prefill_step(cfg)(whole, {"tokens": batch["tokens"]})
    rstate = zoo.init_decode_state(cfg, B, SSD_GATE_STEPS, generator=seed(),
                                   dtype=torch.float32)
    rstep = zoo.make_decode_step(cfg)
    ref_logits = []
    for i in range(SSD_GATE_STEPS):
        lg, rstate = rstep(whole, rstate, toks[:, i:i + 1])
        ref_logits.append(lg)
    ref_state = convert.flatten(rstate)
    rts, rm = zoo.make_train_step(cfg)(
        zoo.TrainState(whole, adamw.init(whole)), batch)
    bound = 2 * cs.lr_at(1) + SSD_STATE_ATOL
    want = convert.flatten(rts)
    out.update(
        prefill_rel_err=_rel(logits[..., :V], ref_pre[..., :V]),
        mixer_y_rel_err=_rel(y, ry), mixer_h_rel_err=_rel(h, rst.h),
        mixer_h_shape=h_shape, decode_h_shape=state_shape,
        whole_h_shape=list(rst.h.shape),
        decode_logits_rel_err=max(_rel(a[..., :V], b[..., :V]) for a, b in
                                  zip(dec_logits, ref_logits)),
        decode_state_rel_err=max(_rel(dec_state[k], v)
                                 for k, v in ref_state.items()
                                 if v.is_floating_point()),
        decode_position=int(dec_state["position"]),
        step_loss_rel_err=abs(float(m["loss"]) - float(rm["loss"]))
        / abs(float(rm["loss"])),
        step_grad_norm_rel_err=abs(float(m["grad_norm"])
                                   - float(rm["grad_norm"]))
        / float(rm["grad_norm"]),
        step_state_max_abs_err=max(float((got[k].double() - v.double())
                                         .abs().max().cpu())
                                   for k, v in want.items()),
        step_state_bound=bound)
    return out


def ssd_gate_passed(g: dict) -> bool:
    """The float32 bounds of the state-layout gate (its clean run)."""
    return (g["layout"] == "state" and g["loss_rel_err"] <= SSD_LOSS_REL
            and g["grad_rel_err"] <= SSD_GRAD_REL
            and max(g[k] for k in ("prefill_rel_err", "mixer_y_rel_err",
                                   "mixer_h_rel_err",
                                   "decode_logits_rel_err",
                                   "decode_state_rel_err")) <= SSD_OUT_REL
            and g["step_loss_rel_err"] <= SSD_LOSS_REL
            and g["step_grad_norm_rel_err"] <= SSD_GRAD_REL
            and g["step_state_max_abs_err"] <= g["step_state_bound"])


def _ssd_four_rank(rank: int, out_dir: str) -> None:
    """One of ``lm_ssd_four_probe``'s NCCL ranks on card ``rank``: the
    state-layout gate clean and planted (``ssd_state_gate``); mamba2-130m
    at full width on (1, 4), the heads layout: MESH_LM_STEPS train steps
    at B = MAMBA_TRAIN_B, S = 4096 (``qwen_mesh_steps``) in bf16, then in
    float32 (TF32 off), then SSD_DECODE_STEPS bf16 decode steps at B =
    SSD_DECODE_B (``serve_run``); the stand-in in bf16, MESH_LM_STEPS
    train steps at B = SSD_BF16_B.  Rank 0 profiles the bf16 trainings'
    last steps.  Each part's row is written to ``out_dir`` as it ends."""
    import dataclasses

    import torch

    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import make_policy
    from repro_torch.models import recurrent as rec
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.empty(1, device=dev)         # memory stats need the allocator

    def write(name, row):
        if row is not None:
            row["device"] = torch.cuda.get_device_name(dev)
            Path(out_dir, f"{name}{rank}.json").write_text(json.dumps(row))

    for planted in (False, True):
        write(f"gate_{'planted' if planted else 'clean'}",
              ssd_state_gate(dev, planted))
    torch.cuda.empty_cache()
    mesh = make_production_mesh(4)
    mamba = ARCHS[cs.MAMBA_ARCH]
    write("heads", cs.qwen_mesh_steps(mesh, cs.MAMBA_TRAIN_B,
                                      cs.MESH_LM_STEPS, dev,
                                      profiled=rank == 0, cfg=mamba))
    write("heads_f32", cs.qwen_mesh_steps(
        mesh, cs.MAMBA_TRAIN_B, cs.MESH_LM_STEPS, dev,
        cfg=dataclasses.replace(mamba, dtype=torch.float32)))
    pol = make_policy(mesh, SSD_DECODE_B, "decode")
    params = tf.init_params(mamba, torch.Generator(device=dev).manual_seed(
        cs.SEED), policy=pol)
    row = cs.serve_run(mamba, params, mesh, SSD_DECODE_B, 2,
                       SSD_DECODE_STEPS, dev)
    # serve_run's bound counts KV caches; this model holds SSD states,
    # its rank's heads of them read and written each step
    H, Pd, N = rec.ssd_dims(mamba)
    h_bytes = (mamba.num_layers * SSD_DECODE_B * H * Pd * N * 4
               // pol.ctx.tp_size)
    row.update(layout=rec.ssd_layout(mamba, pol), ssd_state_bytes=h_bytes,
               bound_ms=(row["weight_bytes"] + 2 * h_bytes)
               / cs.HBM_BYTES_PER_S * 1e3)
    write("decode", row)
    del params
    torch.cuda.empty_cache()
    write("bf16", cs.qwen_mesh_steps(mesh, SSD_BF16_B, cs.MESH_LM_STEPS, dev,
                                     profiled=rank == 0,
                                     cfg=ssd_stand_in(torch.bfloat16)))


def lm_ssd_four_probe() -> int:
    """Phase 27 on cuda:0 (mamba2-130m at full width on one card), the
    same model's first MESH_LM_STEPS steps in float32 (TF32 off) and the
    bf16 stand-in's one-card steps, then one spawn of 4 NCCL ranks
    (``_ssd_four_rank``).  Gates: the state layout within its float32
    bounds of one card and its planted fault beyond them (the ``dt_bias``
    gradient); mamba2-130m's float32 (1, 4) first loss (the same weights
    and batch) within MESH_FOUR_LOSS_REL of one card's.  The later steps'
    losses are reported, not gated: at this model's full width a float32
    trajectory moves by more than the bound under any other summation
    order, which the control shows (one card's float32 steps with each
    gradient summed over two micro-batches, against one); and bf16's
    rounding alone moves its loss by more (one card's bf16 first loss
    against its float32 one, reported).  Exits 0 only when every gate
    holds."""
    import dataclasses
    import math
    import tempfile

    import torch

    from repro_torch.configs.archs import ARCHS
    from repro_torch.distributed import launch

    if torch.cuda.device_count() < 4:
        print("kernel_probe --lm-ssd-four: needs four cards",
              file=sys.stderr)
        return 2
    card = cs.card_line()
    dev = torch.device("cuda:0")
    torch.empty(1, device=dev)         # memory stats need the allocator
    one = cs.mamba_phase(card)[:cs.MESH_LM_STEPS]
    mamba32 = dataclasses.replace(ARCHS[cs.MAMBA_ARCH], dtype=torch.float32)
    one32, control = (cs.lm_train_timed(
        mamba32, cs.MAMBA_TRAIN_B, cs.QWEN_TRAIN_S, 1, cs.MESH_LM_STEPS - 1,
        dev, micro_batches=u) for u in (1, 2))
    base = cs.lm_train_timed(ssd_stand_in(torch.bfloat16), SSD_BF16_B,
                             cs.QWEN_TRAIN_S, 1, cs.MESH_LM_STEPS - 1, dev)
    torch.cuda.empty_cache()           # cuda:0 is rank 0's in the spawn
    t0 = time.perf_counter()
    error = None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            launch.spawn(_ssd_four_rank, 4, args=(tmp,), device_type="cuda",
                         store_dir=tmp,
                         timeout_s=cs.MESH_COLLECTIVE_TIMEOUT_S)
        except Exception as exc:  # noqa: BLE001 (reported, then exit 1)
            error = f"{type(exc).__name__}: {exc}"[-3000:]
        rows = {name: [json.loads(Path(tmp, f"{name}{r}.json").read_text())
                       for r in range(4)
                       if Path(tmp, f"{name}{r}.json").exists()]
                for name in ("gate_clean", "gate_planted", "heads",
                             "heads_f32", "decode", "bf16")}
    seconds = time.perf_counter() - t0
    if error or not all(rows.values()):
        cs.emit("lm_ssd_four_failed", card=card, error=error,
                rows=rows, seconds=seconds)
        return 1
    clean, planted = rows["gate_clean"][0], rows["gate_planted"][0]
    passed = ssd_gate_passed(clean)
    caught = planted["dt_bias_grad_rel_err"] > SSD_GRAD_REL
    cs.emit("ssd_state_gate", card=card, clean=clean, planted=planted,
            bounds=dict(loss=SSD_LOSS_REL, grad=SSD_GRAD_REL,
                        out=SSD_OUT_REL), passed=passed, caught=caught)
    diff = lambda a, b: [abs(x - y) / abs(y)  # noqa: E731
                         for x, y in zip(a, b)]
    heads, h32 = rows["heads"], rows["heads_f32"][0]
    lead = dict(heads[0])
    lead.update(layout="heads",
                peak_bytes_per_card=[r["peak_bytes"] for r in heads],
                ms_per_step_per_rank=[r["ms_per_step"] for r in heads],
                loss_rel_diff_vs_one_card=diff(lead["losses"], one),
                one_card_losses=one,
                one_card_bf16_vs_f32_first_loss=abs(
                    one[0] - one32["losses"][0]) / one32["losses"][0],
                f32=dict(losses=h32["losses"], ms_per_step=h32["ms_per_step"],
                         peak_bytes=h32["peak_bytes"],
                         one_card_losses=one32["losses"],
                         one_card_ms_per_step=one32["ms_per_step"],
                         one_card_peak_bytes=one32["peak_bytes"],
                         loss_rel_diff_vs_one_card=diff(h32["losses"],
                                                        one32["losses"]),
                         control_losses=control["losses"],
                         control_rel_diff_vs_one_card=diff(
                             control["losses"], one32["losses"])))
    cs.emit("ssd_heads_four", card=card, **lead)
    dec = rows["decode"]
    cs.emit("ssd_decode_four", card=card, **dict(
        dec[0], peak_bytes_per_card=[r["peak_bytes"] for r in dec],
        ms_per_step_per_rank=[r["ms_per_step"] for r in dec]))
    bf = rows["bf16"]
    cs.emit("ssd_state_bf16_four", card=card, four=dict(
        bf[0], peak_bytes_per_card=[r["peak_bytes"] for r in bf],
        ms_per_step_per_rank=[r["ms_per_step"] for r in bf]), one_card=base,
        speedup=base["ms_per_step"] / bf[0]["ms_per_step"],
        seconds=seconds)
    finite = all(math.isfinite(x) for r in heads + bf + [h32]
                 for x in r["losses"] + r["grad_norms"])
    f32_diff = lead["f32"]["loss_rel_diff_vs_one_card"][0]
    ok = (passed and caught and finite and all(r["finite"] for r in dec)
          and f32_diff <= cs.MESH_FOUR_LOSS_REL)
    print(json.dumps({"phase": "lm_ssd_four_summary", "gate_passed": passed,
                      "fault_caught": caught, "finite": finite,
                      "heads_f32_first_loss_rel_diff": f32_diff,
                      "heads_bf16_loss_rel_diff": lead[
                          "loss_rel_diff_vs_one_card"],
                      "one_card_bf16_vs_f32_first_loss": lead[
                          "one_card_bf16_vs_f32_first_loss"], "ok": ok}),
          flush=True)
    print(card, flush=True)
    return 0 if ok else 1


def main() -> int:
    import torch

    if len(sys.argv) == 2 and sys.argv[1] == "--lm-ssd-four":
        return lm_ssd_four_probe()
    if len(sys.argv) == 2 and sys.argv[1] == "--ell":
        return ell_probe()

    if len(sys.argv) == 2 and sys.argv[1] == "--lm-serve-four":
        return lm_serve_four_probe()
    if len(sys.argv) == 2 and sys.argv[1] == "--lm-mesh-four":
        return lm_mesh_four_probe()
    if len(sys.argv) == 2 and sys.argv[1] == "--lm-moe-four":
        return lm_moe_four_probe()
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
