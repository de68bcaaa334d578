"""The training driver: ``fit`` on one device or over a mesh, as
``repro.train.fit``.

* ``mesh=None`` trains on one device; a
  ``torch.distributed.device_mesh.DeviceMesh`` builds a ``DistributedLDA``
  partition (``mode``/``doc_axes``/``word_axes`` as in its constructor) and
  runs the same loop over its step, one process per rank.
* Telemetry through ``repro_torch.obs``: ``compile``/``sample``/``eval``
  host spans, the step's phase spans inside ``sample`` and ``eval``
  (``lda.step``, ``lda.theta``, ... and ``lda.ll``: ``core/trainer.py``'s
  module docstring) and, with ``metrics_out``, one JSONL row per iteration
  (rank 0's over a mesh) — all host side, so draws are the same with or
  without it.
* Warm-up timed apart as ``compile_sec``: the first iteration is run once
  from the starting state and thrown away (kernel build and load, allocator
  growth, the collectives' set-up), so every row of ``tokens_per_sec`` is a
  steady-state iteration.  Draws depend only on ``(cfg.seed, iteration)``
  (and the shard over a mesh), so the warm-up changes nothing.
* Each iteration's clock stops after this rank's device has finished it;
  tokens/s counts the whole corpus's tokens.
* Checkpoint/resume in the reference's format (canonical z keyed by the
  corpus fingerprint), elastic across rank counts and partition modes; over
  a mesh rank 0 writes.
* ``sanitize=True`` runs each sweep under
  ``torch.cuda.set_sync_debug_mode("error")``: a sweep that would make the
  host wait on the device fails (the counterpart of the reference's
  transfer guard).
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.analysis.runtime import sync_guard
from repro_torch.core import trainer
from repro_torch.core.corpus import Corpus, TiledCorpusShard, tile_corpus
from repro_torch.core.trainer import LDAConfig, LDAState, TrainResult
from repro_torch.device import resolve_device
from repro_torch.kernels.phi_update import ops as phi_ops


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(
    corpus: Corpus,
    cfg: LDAConfig,
    num_iterations: int,
    mesh=None,                     # DeviceMesh -> DistributedLDA path
    *,
    mode: str = "1d",              # mesh partition: "1d" (paper) | "2d"
    doc_axes=None,
    word_axes=("model",),
    device=None,                   # default cuda:0 (the mesh's device type
    #                                over a mesh); "cpu" runs plain PyTorch
    eval_every: int = 1,
    shard: TiledCorpusShard | None = None,   # one device: pre-tiled corpus
    callback: Callable[[int, LDAState, float], None] | None = None,
    obs=None,                      # repro_torch.obs.Observability
    metrics_out: str | None = None,  # per-iteration JSONL sink path
    sanitize: bool = False,        # sync-guard the sampling hot path
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,     # iterations between checkpoints (0 = off)
    resume: bool = True,           # resume from checkpoint_dir if compatible
    verbose: bool = False,         # print per-eval progress lines
) -> TrainResult:
    """Train LDA end to end, on one device or, with ``mesh``, as this rank
    of a ``DistributedLDA`` (every rank calls ``fit``).  Telemetry,
    checkpointing and the returned ``TrainResult`` are the same on both
    paths."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.obs import Observability

    obs = obs if obs is not None else Observability.noop()
    tracer = obs.tracer
    dev = resolve_device(device) if mesh is None else None
    mgr = fp = None
    if checkpoint_dir:
        mgr = ckpt.CheckpointManager(checkpoint_dir)
        fp = ckpt.corpus_fingerprint(corpus)
    latest = None
    if mgr is not None and resume:
        latest = mgr.latest()
        if not (latest and latest[2].get("fingerprint") == fp):
            latest = None
    loop = dict(eval_every=eval_every, callback=callback, obs=obs,
                metrics_out=metrics_out, sanitize=sanitize, mgr=mgr,
                checkpoint_every=checkpoint_every, verbose=verbose)
    if mesh is not None:
        return _fit_mesh(corpus, cfg, num_iterations, mesh, mode=mode,
                         doc_axes=doc_axes, word_axes=word_axes,
                         device=device, latest=latest, fp=fp, **loop)

    cfg = trainer.resolve_config(cfg, corpus)
    shard = (tile_corpus(corpus, 1, cfg.tile_tokens)[0] if shard is None
             else shard).to(dev)
    # K2's segment table: built here, with its one host sync, and kept on
    # the shard, so that no iteration (sync-guarded under sanitize) builds it
    phi_ops.shard_segments(shard)

    if latest is not None:
        it0, z, _ = latest
        z_tiled = ckpt.scatter_canonical_z(z, shard.token_uid)
        state = trainer.state_from_numpy(cfg, shard, z_tiled, it0)
        print(f"[resume] iteration {it0} (single device)")
    else:
        it0, state = 0, trainer.init_state(cfg, shard)

    def save_fn(it, st):
        z = ckpt.gather_canonical_z(st.z, shard.token_uid, corpus.num_tokens)
        mgr.save(it + 1, z, {"fingerprint": fp, "mode": "single",
                             "num_topics": cfg.num_topics})

    return _run_loop(
        cfg, lambda st: trainer.lda_iteration(cfg, shard, st, tracer=tracer),
        dev, shard.num_tokens, it0, num_iterations, state,
        ll_fn=lambda st: float(trainer.log_likelihood(
            cfg, shard, st, tracer=tracer)) / corpus.num_tokens,
        save_fn=save_fn if mgr is not None else None, **loop)


def _fit_mesh(corpus, cfg, num_iterations, mesh, *, mode, doc_axes,
              word_axes, device, latest, fp, **loop) -> TrainResult:
    from repro_torch.distributed.partition import DistributedLDA

    dl = DistributedLDA(cfg, mesh, corpus, mode=mode, doc_axes=doc_axes,
                        word_axes=word_axes, device=device,
                        tracer=loop["obs"].tracer)
    lead = dl.rank == 0
    if latest is not None:
        it0, z, _ = latest
        state = dl.restore(z, it0)
        if lead:
            print(f"[resume] iteration {it0} on {dl.num_shards} ranks "
                  f"({mode})")
    else:
        it0, state = 0, dl.init()
    mgr = loop["mgr"]
    return _run_loop(
        dl.cfg, dl.step, dl.device, corpus.num_tokens, it0, num_iterations,
        state, ll_fn=dl.log_likelihood,     # already per token
        save_fn=(lambda it, st: dl.save_checkpoint(mgr, st,
                                                   {"fingerprint": fp}))
        if mgr is not None else None, lead=lead, **loop)


def _run_loop(cfg, step, dev, num_tokens, it0, num_iterations, state, *,
              ll_fn, save_fn, mgr, eval_every, callback, obs, metrics_out,
              sanitize, checkpoint_every, verbose,
              lead=True) -> TrainResult:
    """The loop both paths share: ``step(state) -> (state, stats)`` on
    device ``dev``; ``lead`` (rank 0 over a mesh) prints and writes the
    metrics rows.  Every rank evaluates and checkpoints at the same
    iterations, as those are collectives."""
    from repro_torch.obs import NULL_SINK, JsonlSink

    tracer = obs.tracer
    sink = JsonlSink(metrics_out) if metrics_out and lead else NULL_SINK

    # warm-up: the first iteration once, thrown away
    t0 = time.perf_counter()
    with tracer.span("compile", sampler=cfg.sampler):
        if it0 < num_iterations:
            step(state)
            _synchronize(dev)
    compile_sec = time.perf_counter() - t0

    lls: list[float] = []
    tps: list[float] = []
    st: list[tuple[float, float, float]] = []
    try:
        for it in range(it0, num_iterations):
            t0 = time.perf_counter()
            with tracer.span("sample", iteration=it):
                with sync_guard(sanitize, dev):
                    state, stats = step(state)
                _synchronize(dev)
            dt = time.perf_counter() - t0
            tps.append(num_tokens / dt)
            st.append((float(stats.sparse_frac), float(stats.ell_overflow),
                       float(stats.mean_s_over_sq)))
            ll = None
            if (it + 1) % eval_every == 0 or it == num_iterations - 1:
                with tracer.span("eval", iteration=it):
                    ll = float(ll_fn(state))
                lls.append(ll)
                if verbose and lead:
                    print(f"iter {it + 1:5d}  {tps[-1] / 1e6:7.2f}M tok/s  "
                          f"LL/token {ll:.4f}  "
                          f"sparse {st[-1][0]:.2f}  "
                          f"S/(S+Q) {st[-1][2]:.2f}")
                if callback:
                    callback(it, state, ll)
            sink.write(dict(iteration=it, seconds=dt,
                            tokens=num_tokens, tokens_per_sec=tps[-1],
                            sparse_frac=st[-1][0], ell_overflow=st[-1][1],
                            mean_s_over_sq=st[-1][2], ll_per_token=ll))
            if (save_fn is not None and checkpoint_every
                    and (it + 1) % checkpoint_every == 0):
                save_fn(it, state)
    finally:
        sink.close()
    if mgr is not None:
        mgr.wait()
    return TrainResult(state=state, ll_per_token=lls, tokens_per_sec=tps,
                       stats=st, compile_sec=compile_sec, cfg=cfg)
