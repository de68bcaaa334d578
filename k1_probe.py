#!/usr/bin/env python3
"""Where the training sweep kernel K1 spends its time: build variants of
``src/repro_torch/kernels/lda_sample/csrc/lda_sample.cu`` timed on
chip_smoke's training cell (NYTimes size, K = 1024, int16 ELL), one card.

    python3 k1_probe.py

The source is built four ways, one ``nvcc`` each, all started together:

* ``shipped``: as the trainer launches it;
* ``one_tile_per_cta`` (``LDA_SAMPLE_TILES_PER_CTA=1``): p* and its search
  sums rebuilt for every tile instead of kept while a CTA's word repeats;
* ``no_ell_loads`` (``LDA_SAMPLE_PROBE=1``): no ELL row is read; each run's
  scan and draws go over a row already in shared memory with the run's own
  live length, so only the row loads are left out;
* ``no_runs`` (``LDA_SAMPLE_PROBE=2``): only the per-tile work — staging the
  slots, finding the runs, p* and its search sums.

Each is timed (CUDA events, median of 20 after 3 warm-up launches) on the
initial state and on the state after 10 training iterations, with the same
inputs.  One JSON line per state gives the times and their differences:
the row loads (shipped - no_ell_loads), the per-run scan and draws without
them (no_ell_loads - no_runs), the per-tile work (no_runs) and what keeping
p* saves (one_tile_per_cta - shipped), beside K1's design bytes
(``chip_smoke.k1_design``).  The probe builds draw wrongly; only their
times are used.  Exits non-zero, with no result line, without a card.
"""
from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

VARIANTS = {
    "shipped": (),
    "one_tile_per_cta": ("LDA_SAMPLE_TILES_PER_CTA=1",),
    "no_ell_loads": ("LDA_SAMPLE_PROBE=1",),
    "no_runs": ("LDA_SAMPLE_PROBE=2",),
}


def time_variants(args, kw, live) -> dict:
    from repro_torch.kernels.lda_sample import kernel as k1

    return {name: cs.time_ms(lambda d=d: k1.sweep_variant(
        d, *args, ell_live=live, **kw)) for name, d in VARIANTS.items()}


def report(card, state, ms, args):
    from repro_torch.kernels.lda_sample import kernel as k1

    cs.emit("k1_probe", card=card, state=state, ms=ms,
            ell_loads_ms=ms["shipped"] - ms["no_ell_loads"],
            run_work_without_loads_ms=ms["no_ell_loads"] - ms["no_runs"],
            tile_work_ms=ms["no_runs"],
            pstar_reuse_saves_ms=ms["one_tile_per_cta"] - ms["shipped"],
            k1_design=cs.k1_design(args, ms["shipped"], k1.tiles_per_cta()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_probe: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch.configs import lda_nytimes
    from repro_torch.core import trainer
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.core.sampler import draw_sweep_uniforms
    from repro_torch.data.synthetic import nytimes_like
    from repro_torch.kernels import _build
    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.train import fit

    card = cs.card_line()
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        logs = list(pool.map(lambda d: _build.build("lda_sample", d)[1],
                             VARIANTS.values()))
    cs.emit("k1_probe_build", seconds=time.perf_counter() - t0, ptxas={
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in zip(VARIANTS, logs)})

    corpus = nytimes_like(cs.TRAIN_SCALE, seed=0)
    cfg = trainer.resolve_config(lda_nytimes.CONFIG, corpus)
    shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0].to(dev)
    n, t = shard.token_doc.shape
    kw = dict(alpha=cfg.resolved_alpha(), beta=cfg.beta,
              num_words_total=corpus.num_words)

    def sweep_inputs(state, iteration):
        _, c, tp, _ = trainer.theta_and_ell(cfg, shard, state.z)
        u = draw_sweep_uniforms(trainer.iteration_generator(cfg, iteration,
                                                            dev), n, t)
        args = (shard.tile_word, shard.token_doc, shard.token_mask, state.z,
                state.phi_vk, state.phi_sum, c, tp, u)
        return args, k1_ops.live_lengths(c)

    args, live = sweep_inputs(trainer.init_state(cfg, shard), 0)
    report(card, "initial", time_variants(args, kw, live), args)
    del args, live
    st = fit(corpus, lda_nytimes.CONFIG, cs.TRAIN_ITERS, device=dev,
             shard=shard, eval_every=cs.TRAIN_ITERS).state
    args, live = sweep_inputs(st, st.iteration)
    report(card, "trained", time_variants(args, kw, live), args)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
