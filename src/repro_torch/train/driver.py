"""The training driver: ``fit`` on one device, as ``repro.train.fit``
without a mesh.

* Telemetry through ``repro_torch.obs``: per-iteration counters and latency
  histograms, ``compile``/``sample``/``eval`` host spans and, with
  ``metrics_out``, one JSONL row per iteration — all host side, so draws
  are the same with or without it.
* Warm-up timed apart as ``compile_sec``: the first iteration is run once
  from the starting state and thrown away (kernel build and load, allocator
  growth), so every row of ``tokens_per_sec`` is a steady-state iteration.
  Draws depend only on ``(cfg.seed, iteration)``, so the warm-up changes
  nothing.
* Each iteration's clock stops after the device has finished it.
* Checkpoint/resume in the reference's format (canonical z keyed by the
  corpus fingerprint).
* ``sanitize=True`` runs each sweep under
  ``torch.cuda.set_sync_debug_mode("error")``: a sweep that would make the
  host wait on the device fails (the counterpart of the reference's
  transfer guard).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from repro_torch.core import trainer
from repro_torch.core.corpus import Corpus, TiledCorpusShard, tile_corpus
from repro_torch.core.trainer import LDAConfig, LDAState, TrainResult
from repro_torch.device import resolve_device
from repro_torch.kernels.phi_update import ops as phi_ops


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def sync_guard(enabled: bool, device: torch.device):
    """Make any host-device synchronisation inside the block an error."""
    if not (enabled and device.type == "cuda"):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def fit(
    corpus: Corpus,
    cfg: LDAConfig,
    num_iterations: int,
    mesh=None,
    *,
    device=None,                   # default cuda:0; "cpu" runs plain PyTorch
    eval_every: int = 1,
    shard: TiledCorpusShard | None = None,   # pre-tiled corpus
    callback: Callable[[int, LDAState, float], None] | None = None,
    obs=None,                      # repro_torch.obs.Observability
    metrics_out: str | None = None,  # per-iteration JSONL sink path
    sanitize: bool = False,        # sync-guard the sampling hot path
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,     # iterations between checkpoints (0 = off)
    resume: bool = True,           # resume from checkpoint_dir if compatible
    verbose: bool = False,         # print per-eval progress lines
) -> TrainResult:
    """Train LDA on one device end to end.  ``mesh`` must be None: training
    over several cards comes with slice 3."""
    if mesh is not None:
        raise NotImplementedError(
            "fit(mesh=...) trains over several devices, which the port "
            "brings in slice 3 (multi-GPU); pass mesh=None")
    from repro_torch.distributed import checkpoint as ckpt

    dev = resolve_device(device)
    cfg = trainer.resolve_config(cfg, corpus)
    shard = (tile_corpus(corpus, 1, cfg.tile_tokens)[0] if shard is None
             else shard).to(dev)
    # K2's segment table: built here, with its one host sync, and kept on
    # the shard, so that no iteration (sync-guarded under sanitize) builds it
    phi_ops.shard_segments(shard)

    mgr = fp = None
    if checkpoint_dir:
        mgr = ckpt.CheckpointManager(checkpoint_dir)
        fp = ckpt.corpus_fingerprint(corpus)

    it0, state = 0, None
    if mgr is not None and resume:
        latest = mgr.latest()
        if latest and latest[2].get("fingerprint") == fp:
            it0, z, _ = latest
            z_tiled = ckpt.scatter_canonical_z(z, shard.token_uid)
            state = trainer.state_from_numpy(cfg, shard, z_tiled, it0)
            print(f"[resume] iteration {it0} (single device)")
    if state is None:
        state = trainer.init_state(cfg, shard)

    def save_fn(it, st):
        z = ckpt.gather_canonical_z(st.z, shard.token_uid, corpus.num_tokens)
        mgr.save(it + 1, z, {"fingerprint": fp, "mode": "single",
                             "num_topics": cfg.num_topics})

    return _run_loop(
        cfg, shard, it0, num_iterations, state,
        ll_fn=lambda st: float(trainer.log_likelihood(cfg, shard, st))
        / corpus.num_tokens,
        save_fn=save_fn if mgr is not None else None, mgr=mgr,
        eval_every=eval_every, callback=callback, obs=obs,
        metrics_out=metrics_out, sanitize=sanitize,
        checkpoint_every=checkpoint_every, verbose=verbose)


def _run_loop(cfg, shard, it0, num_iterations, state, *, ll_fn, save_fn, mgr,
              eval_every, callback, obs, metrics_out, sanitize,
              checkpoint_every, verbose) -> TrainResult:
    from repro_torch.obs import NULL_SINK, JsonlSink, Observability

    obs = obs if obs is not None else Observability.default(trace=False)
    reg, tracer = obs.registry, obs.tracer
    m_iters = reg.counter("repro_train_iterations_total", "sweeps completed")
    m_tokens = reg.counter("repro_train_tokens_sampled_total",
                           "tokens resampled (iterations * corpus tokens)")
    m_iter_ms = reg.histogram("repro_train_iteration_ms",
                              "wall time per training iteration")
    g_tps = reg.gauge("repro_train_tokens_per_sec", "last iteration's rate")
    g_ll = reg.gauge("repro_train_ll_per_token", "last evaluated joint LL")
    sink = JsonlSink(metrics_out) if metrics_out else NULL_SINK
    dev = shard.device
    num_tokens = shard.num_tokens

    # warm-up: the first iteration once, thrown away
    t0 = time.perf_counter()
    with tracer.span("compile", sampler=cfg.sampler):
        if it0 < num_iterations:
            trainer.lda_iteration(cfg, shard, state)
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
                    state, stats = trainer.lda_iteration(cfg, shard, state)
                _synchronize(dev)
            dt = time.perf_counter() - t0
            tps.append(num_tokens / dt)
            st.append((float(stats.sparse_frac), float(stats.ell_overflow),
                       float(stats.mean_s_over_sq)))
            m_iters.inc()
            m_tokens.inc(num_tokens)
            m_iter_ms.observe(dt * 1e3)
            g_tps.set(tps[-1])
            ll = None
            if (it + 1) % eval_every == 0 or it == num_iterations - 1:
                with tracer.span("eval", iteration=it):
                    ll = float(ll_fn(state))
                lls.append(ll)
                g_ll.set(ll)
                if verbose:
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
