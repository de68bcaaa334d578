"""LDA training iteration — WorkSchedule1/2 (paper §5.1) on one device, as
``repro.core.trainer`` without a mesh.

State layout:
  z        (n_tiles, tile_tokens) int16 — topic assignments (C7); the only
           mutable model state: theta and phi are counts derived from it.
  phi_vk   (V, K) int32 — topic-word counts, word-major.
  phi_sum  (K,) int32 — per-topic totals.

Per iteration (delayed-count semantics, the paper's):
  1. theta and its ELL slice rebuilt from z;
  2. every token resampled against the frozen iteration-start phi
     (WorkSchedule1: one sweep; WorkSchedule2: M micro-chunks with theta
     refreshed in between by ``theta_delta``);
  3. phi advanced incrementally: ``phi_old + phi_delta(z_old, z_new)``,
     exact in integer arithmetic.

Samplers (``LDAConfig.sampler``):
  * ``"sq"``    — the paper's sparsity-aware S/Q sampler.  On a CUDA device
                  this *is* the fused kernel (``kernels.lda_sample``, K1);
                  on the CPU its plain PyTorch version.  The phi delta goes
                  through ``kernels.phi_update`` (K2) the same way.
  * ``"dense"`` — the O(K) baseline (plain PyTorch everywhere).

Randomness is data.  ``lda_iteration`` takes the sweep's uniforms as a
tensor, or draws them from a generator seeded from ``(cfg.seed,
iteration)`` (``(cfg.seed, iteration, g)`` on rank g of a mesh), so a run
resumed from a checkpoint draws what the uninterrupted run drew.

Over a mesh (``repro_torch.distributed.partition.DistributedLDA``) the same
functions take process groups, as the reference takes mesh axes:
``data_group`` sums phi deltas and the likelihood's doc term over the
document shards, ``model_group`` sums theta partials, phi_sum and the word
term over the word shards (2d).  Without groups nothing changes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import dense_sampler, likelihood, sampler, sync, updates
from repro_torch.core.corpus import Corpus, TiledCorpusShard, ell_capacity
from repro_torch.kernels.lda_sample import ops as lda_ops
from repro_torch.kernels.phi_update import ops as phi_ops


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    num_topics: int = 1024
    alpha: float | None = None       # default 50/K (paper §2.1)
    beta: float = 0.01
    tile_tokens: int = 256           # tokens per word tile (C6)
    tiles_per_step: int = 64         # chunk of the plain sweep
    ell_capacity: int | None = None  # P; None = exact bound from corpus
    micro_chunks: int = 1            # M: 1 = WorkSchedule1, >1 = WorkSchedule2
    sampler: str = "sq"              # "sq" (paper; the kernel on CUDA)
    #                                  | "dense" (O(K) baseline)
    topic_dtype: Any = torch.int16   # C7
    compressed_sync: bool = False    # int16 delta sync as bytes (core/sync.py)
    sync_overlap: bool = False       # WS2 over a mesh: each micro-chunk's
    #                                  phi delta synced as soon as it exists
    #                                  (exact: the sum is linear over int).
    #                                  On one device the state is the same
    #                                  either way.
    seed: int = 0

    def __post_init__(self):
        if self.sampler == "pallas":
            raise ValueError(
                "sampler='pallas' names the JAX package's TPU kernel; in "
                "repro_torch use sampler='sq', which runs the fused CUDA "
                "kernel on a CUDA device")
        if self.sampler not in ("sq", "dense"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        # C7 only compresses what fits: z is stored as topic_dtype, so K - 1
        # must be representable or z wraps silently.
        try:
            max_topic = int(torch.iinfo(self.topic_dtype).max)
        except TypeError as e:
            raise ValueError(f"topic_dtype must be an integer dtype, got "
                             f"{self.topic_dtype!r}") from e
        if self.num_topics - 1 > max_topic:
            raise ValueError(
                f"num_topics={self.num_topics} does not fit "
                f"topic_dtype={self.topic_dtype} (max topic id {max_topic}); "
                "pass topic_dtype=torch.int32")

    def resolved_alpha(self) -> float:
        return 50.0 / self.num_topics if self.alpha is None else self.alpha


def resolve_config(cfg: LDAConfig, corpus: Corpus) -> LDAConfig:
    """Fill the defaults derived from the corpus (ell_capacity), once.
    Idempotent; the caller's config is untouched."""
    if cfg.ell_capacity is None:
        cfg = dataclasses.replace(
            cfg, ell_capacity=ell_capacity(corpus, cfg.num_topics))
    return cfg


class LDAState(NamedTuple):
    z: torch.Tensor        # (n, t) topic assignments
    phi_vk: torch.Tensor   # (V, K) int32
    phi_sum: torch.Tensor  # (K,) int32
    iteration: int


class IterStats(NamedTuple):
    sparse_frac: torch.Tensor     # 0-d
    ell_overflow: torch.Tensor    # docs exceeding ELL capacity (0 exact mode)
    mean_s_over_sq: torch.Tensor  # mean S/(S+Q) (sq sampler only)


def seeded_generator(entropy, device) -> torch.Generator:
    """A generator on ``device`` seeded from a list of integers."""
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def iteration_generator(cfg: LDAConfig, iteration: int, device,
                        rank: int | None = None) -> torch.Generator:
    """The generator of one iteration's draws, seeded from (seed,
    iteration), and on a mesh from (seed, iteration, shard index)."""
    entropy = [cfg.seed, int(iteration)]
    return seeded_generator(entropy if rank is None else entropy + [rank],
                            device)


def iteration_uniforms(cfg: LDAConfig, state: LDAState,
                       rank: int | None = None) -> torch.Tensor:
    """One iteration's sweep uniforms from ``iteration_generator``: one row
    per tile of the shard padded to a multiple of ``micro_chunks``."""
    n, t = state.z.shape
    n_all = n + (-n % cfg.micro_chunks)
    gen = iteration_generator(cfg, state.iteration, state.z.device, rank)
    if cfg.sampler == "sq":
        return sampler.draw_sweep_uniforms(gen, n_all, t)
    return dense_sampler.draw_dense_uniforms(gen, n_all, t)


def state_from_z(cfg: LDAConfig, shard: TiledCorpusShard, z: torch.Tensor,
                 iteration: int, data_group=None,
                 model_group=None) -> LDAState:
    """Rebuild the derived counts from assignments (init, restore,
    elastic restore onto another mesh)."""
    phi = sync.sync_phi(updates.phi_from_z(z, shard.tile_word,
                                           shard.token_mask, shard.num_words,
                                           cfg.num_topics), data_group)
    return LDAState(z=z, phi_vk=phi,
                    phi_sum=sync.global_phi_sum(phi, model_group),
                    iteration=int(iteration))


def init_state(cfg: LDAConfig, shard: TiledCorpusShard,
               generator: torch.Generator | None = None, data_group=None,
               model_group=None) -> LDAState:
    """Uniform random initial assignments (from ``cfg.seed`` unless a
    generator on the shard's device is given)."""
    gen = generator or seeded_generator([cfg.seed], shard.device)
    z0 = sampler.draw_initial_topics(gen, shard.token_doc.shape,
                                     cfg.num_topics, shard.device)
    return state_from_z(cfg, shard, z0.to(cfg.topic_dtype), 0, data_group,
                        model_group)


def state_from_numpy(cfg: LDAConfig, shard: TiledCorpusShard, z,
                     iteration: int, phi=None, phi_sum=None) -> LDAState:
    """A state held as numpy arrays (for example a JAX ``LDAState`` through
    ``np.asarray``) -> the port's state on the shard's device.  phi is
    rebuilt from z; a given phi or phi_sum must agree with it."""
    zt = torch.from_numpy(np.asarray(z).astype(np.int64)).to(
        shard.device).to(cfg.topic_dtype)
    state = state_from_z(cfg, shard, zt, iteration)
    for name, given, built in (("phi", phi, state.phi_vk),
                               ("phi_sum", phi_sum, state.phi_sum)):
        if given is not None and not np.array_equal(
                np.asarray(given), built.cpu().numpy()):
            raise ValueError(f"the given {name} differs from the counts of z")
    return state


def theta_and_ell(cfg: LDAConfig, shard: TiledCorpusShard, z,
                  model_group=None):
    """Step 1 of an iteration: theta from z (summed over the word shards in
    2d) and its ELL slice, in int16 when K and the longest document allow
    (C7, ``updates.ell_dtype``).  ``shard.max_doc_length`` is a document's
    whole length: in 2d the ELL holds the model-group sum, which reaches it.
    Returns (theta, counts, topics, overflowed)."""
    K = cfg.num_topics
    theta = sync.sync_theta(updates.theta_from_z(
        z, shard.token_doc, shard.token_mask, shard.num_docs_local, K),
        model_group)
    P = cfg.ell_capacity or min(K, shard.max_doc_length)
    counts, topics, overflow = updates.theta_to_ell(
        theta, min(P, K), updates.ell_dtype(K, shard.max_doc_length))
    return theta, counts, topics, overflow


def _pad_tiles(arrays, n_pad: int):
    """Append n_pad masked-out tiles of word 0 to (tile_word, token_doc,
    token_mask, z)."""
    if not n_pad:
        return arrays
    return tuple(torch.cat([a, torch.zeros((n_pad,) + a.shape[1:],
                                           dtype=a.dtype, device=a.device)])
                 for a in arrays)


def lda_iteration(cfg: LDAConfig, shard: TiledCorpusShard, state: LDAState,
                  uniforms: torch.Tensor | None = None, *, data_group=None,
                  model_group=None, heavy_rows: torch.Tensor | None = None
                  ) -> tuple[LDAState, IterStats]:
    """One full sweep over the shard's tokens, the phi advance and its sync.

    ``uniforms``: the sweep's randomness — for ``"sq"`` (n_pad, t, 2), for
    ``"dense"`` (n_pad, t), where n_pad is the tile count padded to a
    multiple of ``micro_chunks``; micro-chunk m reads rows
    [m n_pad/M, (m+1) n_pad/M).  Drawn by ``iteration_uniforms`` when not
    given.  ``data_group``, ``model_group``: the mesh's process groups (see
    the module docstring); ``heavy_rows``: the int32-sync rows of
    ``compressed_sync``.

    ``cfg.sync_overlap`` with M > 1 over a data group syncs each
    micro-chunk's phi delta as soon as it exists (``async_op``), so the
    collective runs while the next chunk samples (which reads only the
    frozen iteration-start phi), and waits before the phi add; the sum is
    linear over the integers, so the state is the serialized sync's bit
    for bit.  Launches work without synchronising the device."""
    K = cfg.num_topics
    alpha, beta = cfg.resolved_alpha(), cfg.beta
    n, t = state.z.shape
    M = cfg.micro_chunks
    n_pad = -n % M
    if uniforms is None:
        uniforms = iteration_uniforms(cfg, state)

    theta, ell_c, ell_t, overflow = theta_and_ell(cfg, shard, state.z,
                                                  model_group)
    v_total = shard.num_words_total or shard.num_words
    kw = dict(alpha=alpha, beta=beta, num_words_total=v_total)
    overlap = cfg.sync_overlap and M > 1 and data_group is not None

    def sync_delta(delta, async_op=False):
        return sync.sync_phi_delta(delta, data_group, heavy_rows,
                                   cfg.compressed_sync, async_op)

    def sweep(tw, td, tm, zc, u, theta_c, cnts, tpcs, c):
        if cfg.sampler == "sq":
            return lda_ops.lda_sample(tw, td, tm, zc, state.phi_vk,
                                      state.phi_sum, cnts, tpcs, u,
                                      tiles_per_step=c, **kw)
        zero = torch.zeros((), dtype=torch.float32, device=zc.device)
        z_new = dense_sampler.sample_sweep_dense(
            state.phi_vk, state.phi_sum, tw, td, tm, zc, theta_c, u,
            tiles_per_step=c, **kw)
        return z_new, sampler.SamplerStats(zero, zero)

    if M == 1:   # WorkSchedule1: one sweep over every tile
        z_new, st = sweep(shard.tile_word, shard.token_doc, shard.token_mask,
                          state.z, uniforms, theta, ell_c, ell_t,
                          min(cfg.tiles_per_step, max(n, 1)))
        sparse_frac, mean_ssq = st.sparse_frac, st.mean_s_over_sq
    else:        # WorkSchedule2: M micro-chunks, theta refreshed in between
        tw_a, td_a, tm_a, z_a = _pad_tiles(
            (shard.tile_word, shard.token_doc, shard.token_mask, state.z),
            n_pad)
        nc = (n + n_pad) // M
        P = ell_c.shape[1]
        chunk_segs = phi_ops.shard_chunk_segments(shard, M) if overlap \
            else None
        theta_c = theta
        z_parts, sfs, ssqs, pending = [], [], [], []
        for m in range(M):
            sl = slice(m * nc, (m + 1) * nc)
            cnts, tpcs = updates.ell_topk(theta_c, P, ell_c.dtype)
            z_c, st = sweep(tw_a[sl], td_a[sl], tm_a[sl], z_a[sl],
                            uniforms[sl], theta_c, cnts, tpcs,
                            min(cfg.tiles_per_step, nc))
            theta_c = theta_c + sync.sync_theta(updates.theta_delta(
                z_a[sl], z_c, td_a[sl], tm_a[sl], theta_c.shape[0], K),
                model_group)
            if overlap:   # this chunk's delta (K2 on its tiles), on the wire
                pending.append(sync_delta(phi_ops.phi_delta(
                    tw_a[sl], None, z_a[sl], z_c, tm_a[sl],
                    num_words=shard.num_words, num_topics=K,
                    segments=chunk_segs and chunk_segs[m]), async_op=True))
            z_parts.append(z_c)
            sfs.append(st.sparse_frac)
            ssqs.append(st.mean_s_over_sq)
        z_new = torch.cat(z_parts)[:n]
        sparse_frac = torch.stack(sfs).mean()
        mean_ssq = torch.stack(ssqs).mean()

    if overlap:
        phi = state.phi_vk
        for p in pending:
            phi = phi + p.wait()
    else:
        # incremental phi advance: one count pass over the sweep's moves
        # (K2 on a CUDA device), exact in integer arithmetic, then synced
        delta = phi_ops.phi_delta(shard.tile_word, shard.tile_first,
                                  state.z, z_new, shard.token_mask,
                                  num_words=shard.num_words, num_topics=K,
                                  segments=phi_ops.shard_segments(shard))
        phi = state.phi_vk + sync_delta(delta)
    new_state = LDAState(z=z_new, phi_vk=phi,
                         phi_sum=sync.global_phi_sum(phi, model_group),
                         iteration=state.iteration + 1)
    return new_state, IterStats(sparse_frac=sparse_frac,
                                ell_overflow=overflow.sum(),
                                mean_s_over_sq=mean_ssq)


def log_likelihood(cfg: LDAConfig, shard: TiledCorpusShard, state: LDAState,
                   data_group=None, model_group=None) -> torch.Tensor:
    """Joint collapsed log-likelihood (Fig. 8 metric), 0-d float32.  Over a
    mesh: the doc term summed over the document shards, the word term from
    the phi this rank holds (the replica in 1d, summed over the word shards
    in 2d), so every rank returns the whole."""
    alpha, beta = cfg.resolved_alpha(), cfg.beta
    theta = sync.sync_theta(updates.theta_from_z(
        state.z, shard.token_doc, shard.token_mask, shard.num_docs_local,
        cfg.num_topics), model_group)
    dterm = sync.maybe_all_reduce(
        likelihood.doc_term(theta, shard.doc_length, alpha), data_group)
    winner = sync.maybe_all_reduce(
        likelihood.word_inner_term(state.phi_vk, beta), model_group)
    return dterm + winner + likelihood.word_outer_term(
        state.phi_sum, beta, shard.num_words_total or shard.num_words)


@dataclasses.dataclass
class TrainResult:
    state: LDAState
    ll_per_token: list[float]
    tokens_per_sec: list[float]
    stats: list[tuple[float, float, float]]  # (sparse_frac, ell_overflow, S/(S+Q))
    compile_sec: float = 0.0   # warm-up (first iteration, kernel load
    #                            included), excluded from tokens_per_sec
    cfg: LDAConfig | None = None  # the resolved config actually trained with
