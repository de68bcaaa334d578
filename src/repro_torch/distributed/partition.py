"""Multi-device LDA partitions on ``torch.distributed`` (paper §4-§5), as
``repro.distributed.partition`` on a JAX mesh.

One process per rank (SPMD).  A ``torch.distributed.device_mesh.DeviceMesh``
takes the place of ``jax.sharding.Mesh``: its dimension names are the axis
names, and each set of axes becomes a process group.  NCCL serves a mesh on
``cuda``, gloo one on ``cpu``; nothing switches to the other.

Two partition modes:

* ``"1d"`` — the paper's partition by document: one chunk of documents per
  rank over every doc axis, balanced by token count (C1); phi is replicated
  and its per-iteration delta all-reduced (C3).
* ``"2d"`` — doc x word: documents over ``doc_axes``, the vocabulary over
  ``word_axes`` (LPT by token count).  A rank samples the tokens of (its
  documents) ∩ (its words) against its local phi rows; theta partials sum
  over the word axes, phi deltas over the doc axes only.

Shard g = d * n_word + m (doc-major) lives on the rank at doc coordinate d
and word coordinate m.  A rank tiles and keeps only its own shard; the tile
count every shard is padded to (the largest, as the reference pads) comes
from each shard's word counts, without tiling the others.

Left out on purpose: ``stack_shards`` (the reference stacks every shard on a
leading axis for one controller; here each rank holds its own), and
``lower_step``/``compile_step`` (``fit``'s warm-up iteration takes their
place).

The request-side token routing of V-sharded serving (``comm="all2all"``)
lives here too, as in the reference: the host-side plan (numpy) and the
bucketing of one doc slice's tokens by owning shard (torch).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import sync
from repro_torch.core import trainer as core_trainer
from repro_torch.core.corpus import Corpus, partition_by_document, tile_shard
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.kernels.phi_update import ops as phi_ops
from repro_torch.obs.trace import NULL_TRACER, SpanTracer

# A word's per-iteration phi_delta entry is bounded by its corpus frequency,
# so the int16 compressed sync (sync.compressed_sync_phi) is exact for every
# word occurring fewer than 2**15 times; words at or above the bound take the
# int32 correction path.  Read at call time, so tests can patch it.
INT16_FLUX_BOUND = 1 << 15


# ---------------------------------------------------------------------------
# request-side token routing (V-sharded serving, comm="all2all")
# ---------------------------------------------------------------------------
# Each shard takes a contiguous slice of the batch's documents, buckets its
# real tokens' local-row ids by owning shard, the owners gather those phi
# rows and send them back into batch order; the sweeps then run on the doc
# slice only.  The bytes moved scale with the tokens routed, not B*L*K.


def doc_slice_bounds(num_docs: int, num_shards: int):
    """Contiguous per-shard document slices covering [0, num_docs).

    Every shard gets the same slice width ``Bs = ceil(B/S)``; when B is not
    divisible the trailing slices are clamped to ``B - Bs`` and overlap —
    duplicated docs are computed twice and deduplicated at assembly
    (``doc_slice_owner``), which keeps draws bit-identical for any B.

    Returns (starts (S,) int32, Bs)."""
    if num_docs < 1 or num_shards < 1:
        raise ValueError("num_docs and num_shards must be >= 1")
    per = -(-num_docs // num_shards)   # ceil
    starts = np.minimum(np.arange(num_shards, dtype=np.int64) * per,
                        num_docs - per)
    return starts.astype(np.int32), int(per)


def doc_slice_owner(num_docs: int, num_shards: int):
    """Deduplication map for overlapping slices: for each doc, the shard
    whose slice "officially" covers it plus its row within that slice.

    Returns (owner (B,) int64, row (B,) int64)."""
    starts, per = doc_slice_bounds(num_docs, num_shards)
    d = np.arange(num_docs, dtype=np.int64)
    owner = np.minimum(d // per, num_shards - 1)
    return owner, d - starts[owner]


@dataclasses.dataclass(frozen=True)
class TokenRoutingPlan:
    """Host-side routing plan for one (tokens, mask) batch.

    ``capacity`` is the per-(requester, owner) bucket size: the measured
    largest bucket rounded up to a power of two, clamped to the slice size
    so it can never be exceeded.  The byte counts are measured for this
    batch, summed over every shard, counting only traffic between shards
    (a shard's own bucket stays local)."""

    num_shards: int
    docs_per_shard: int      # Bs — the doc-slice width
    capacity: int            # per (requester, owner) bucket slots
    routed_tokens: int       # real (unmasked) tokens routed, duplicates incl.
    a2a_bytes: int           # ids + rows all_to_all + per-doc result gather
    psum_bytes: int          # what the dense (B, L, K) psum would have moved


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n - 1).bit_length())


def psum_gather_bytes(batch: int, length: int, num_topics: int,
                      num_shards: int) -> int:
    """Bytes between shards of a ring all-reduce of the (B, L, K) int32
    gathered rows (reduce-scatter + all-gather), summed over the shards."""
    return 4 * 2 * (num_shards - 1) * batch * length * num_topics


def plan_token_routing(word_shard_of: np.ndarray, tokens: np.ndarray,
                       mask: np.ndarray, num_shards: int,
                       num_topics: int) -> TokenRoutingPlan:
    """Measure one batch's routing load and fix the bucket capacity.

    ``word_shard_of`` is the snapshot's (V,) word->shard map (LPT-balanced
    for trainer-published snapshots, contiguous for re-split dense ones)."""
    tokens = np.asarray(tokens)
    mask = np.asarray(mask, bool)
    B, L = tokens.shape
    S = int(num_shards)
    shard_of = np.asarray(word_shard_of)
    starts, per = doc_slice_bounds(B, S)

    max_bucket, routed = 0, 0
    for s in range(S):
        sl = slice(int(starts[s]), int(starts[s]) + per)
        owners = shard_of[tokens[sl][mask[sl]]]
        routed += owners.size
        if owners.size:
            max_bucket = max(max_bucket,
                             int(np.bincount(owners, minlength=S).max()))
    capacity = min(_next_pow2(max(max_bucket, 1)), per * L)

    K = int(num_topics)
    off = S * (S - 1)   # (src, dst) pairs that cross between shards
    a2a = 4 * (off * capacity              # token-id request lists
               + off * capacity * K        # gathered rows coming back
               + off * (per * K + 2 * per))  # per-doc theta/sp/ssq gather
    return TokenRoutingPlan(
        num_shards=S, docs_per_shard=per, capacity=capacity,
        routed_tokens=routed, a2a_bytes=a2a,
        psum_bytes=psum_gather_bytes(B, L, K, S))


def route_buckets(owner: torch.Tensor, payload: torch.Tensor,
                  num_shards: int, capacity: int):
    """Bucket a flat token stream by owning shard, on the tensors' device
    and without a host sync.

    ``owner`` (T,) holds each slot's owning shard, or ``num_shards`` for
    slots that route nowhere (padding).  ``payload`` (T,) is what travels
    (local phi-row ids).  Returns (send (S, C) int32 payload buckets, src
    (S, C) int32 flat source position per slot, T where the slot is empty).
    A slot past the capacity is dropped (the plan's capacity leaves none
    for real tokens), as are padding slots: both are sent to one spare slot
    past the (S, C) table before the scatter, which then drops it."""
    S, C = int(num_shards), int(capacity)
    T = owner.shape[0]
    dev = owner.device
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order]
    first = torch.searchsorted(sorted_owner,
                               torch.arange(S, dtype=owner.dtype, device=dev))
    rank = (torch.arange(T, device=dev)
            - first[sorted_owner.clamp(0, S - 1).long()])
    keep = (sorted_owner < S) & (rank < C)
    slot = torch.where(keep, sorted_owner.long() * C + rank, S * C)
    send = torch.zeros(S * C + 1, dtype=torch.int32, device=dev)
    send.index_put_((slot,), payload[order].to(torch.int32))
    src = torch.full((S * C + 1,), T, dtype=torch.int32, device=dev)
    src.index_put_((slot,), order.to(torch.int32))
    return send[:-1].view(S, C), src[:-1].view(S, C)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Static description of how the corpus was laid onto the mesh."""

    mode: str                       # "1d" | "2d"
    doc_axes: tuple[str, ...]       # mesh axes carrying document shards
    word_axes: tuple[str, ...]      # mesh axes carrying vocabulary shards
    num_doc_shards: int
    num_word_shards: int
    word_shard_of: np.ndarray | None = None   # (V,) -> word shard (2d)
    word_local_id: np.ndarray | None = None   # (V,) -> local row (2d)
    vocab_shard_size: int = 0                 # padded local V (2d)


def heavy_word_rows(corpus: Corpus, plan: PartitionPlan) -> np.ndarray:
    """Per-shard local phi rows too heavy for the int16 compressed sync.

    Rows of words with corpus frequency >= ``INT16_FLUX_BOUND`` can wrap the
    int16 delta sum, so ``sync.compressed_sync_phi`` reduces just those rows
    again in int32 and writes the exact sums over the wrapped ones.  Returns
    (num_shards, H) int32 in shard (doc-major) order: global ids in 1d,
    LPT-local rows in 2d, padded with row 0 (re-setting a row to its exact
    sum changes nothing)."""
    counts = np.bincount(corpus.word_ids, minlength=corpus.num_words)
    heavy = np.nonzero(counts >= INT16_FLUX_BOUND)[0].astype(np.int32)
    G = plan.num_doc_shards * plan.num_word_shards
    if plan.word_shard_of is None:      # 1d: phi is the full replicated V
        return np.tile(heavy, (G, 1))
    per = [np.sort(plan.word_local_id[heavy[plan.word_shard_of[heavy] == m]])
           for m in range(plan.num_word_shards)]
    H = max((p.size for p in per), default=0)
    rows = np.zeros((G, H), np.int32)
    for d in range(plan.num_doc_shards):
        for m in range(plan.num_word_shards):
            rows[d * plan.num_word_shards + m, : per[m].size] = per[m]
    return rows


def partition_vocabulary(corpus: Corpus, num_shards: int):
    """LPT-balance words over word shards by token count (the paper's C1
    balance rule applied on the vocabulary axis).  Returns (shard of each
    word, its local row, the largest shard's word count)."""
    counts = np.bincount(corpus.word_ids, minlength=corpus.num_words)
    order = np.argsort(-counts, kind="stable")
    shard_of = np.empty(corpus.num_words, dtype=np.int32)
    local_id = np.empty(corpus.num_words, dtype=np.int32)
    loads = np.zeros(num_shards, dtype=np.int64)
    fill = np.zeros(num_shards, dtype=np.int64)
    for v in order:
        s = int(np.argmin(loads))
        shard_of[v] = s
        local_id[v] = fill[s]
        fill[s] += 1
        loads[s] += int(counts[v])
    return shard_of, local_id, int(fill.max())


def _subset(corpus: Corpus, sel: np.ndarray, word_map: np.ndarray | None,
            num_words_local: int) -> tuple[Corpus, np.ndarray]:
    """Restricted corpus + the canonical indices of the selected tokens."""
    w = corpus.word_ids[sel]
    if word_map is not None:
        w = word_map[w]
    sub = Corpus(corpus.doc_ids[sel].copy(), w.astype(np.int32),
                 corpus.num_docs, num_words_local)
    return sub, np.nonzero(sel)[0].astype(np.int32)


def build_shards(corpus: Corpus, num_doc_shards: int, num_word_shards: int,
                 mode: str, tile_tokens: int, only: int | None = None):
    """Host-side shard construction, doc-major then word order, as the
    reference's ``build_shards``: every shard padded to the largest tile
    count (ceil(count / t) tiles per word of the shard).  ``only=g`` tiles
    shard g alone; the others are only counted.

    Returns (shards, plan).  A shard's ``doc_length`` and
    ``max_doc_length`` are its documents' whole lengths, the reference's
    ``full_doc_lengths``: in 2d a shard sees a part of each document, but
    the ELL holds the model-group sum and the likelihood's doc term the
    whole document."""
    if mode not in ("1d", "2d"):
        raise ValueError(f"unknown partition mode {mode!r}")
    if mode == "1d" and num_word_shards != 1:
        raise ValueError("a 1d partition has one word shard")
    doc_parts = partition_by_document(corpus, num_doc_shards)
    doc_shard = np.empty(corpus.num_docs, dtype=np.int64)
    for d, pd in enumerate(doc_parts):
        doc_shard[pd] = d
    shard_of_tok = doc_shard[corpus.doc_ids] * num_word_shards
    if mode == "1d":
        word_map, v_local, local_word = None, corpus.num_words, corpus.word_ids
        plan_words = (None, None, 0)
    else:
        shard_of, word_map, v_local = partition_vocabulary(corpus,
                                                           num_word_shards)
        shard_of_tok += shard_of[corpus.word_ids]
        local_word = word_map[corpus.word_ids]
        plan_words = (shard_of, word_map, v_local)
    G = num_doc_shards * num_word_shards
    counts = np.bincount(shard_of_tok * v_local + local_word,
                         minlength=G * v_local).reshape(G, v_local)
    n_max = int((-(-counts // int(tile_tokens))).sum(1).max())

    lengths = corpus.doc_lengths()
    shards = []
    for g in (range(G) if only is None else (only,)):
        pd = doc_parts[g // num_word_shards]
        sub, uid = _subset(corpus, shard_of_tok == g, word_map, v_local)
        s = tile_shard(sub, pd, tile_tokens, n_max, token_uid=uid,
                       num_words_total=corpus.num_words)
        full = lengths[pd].astype(np.int32)
        shards.append(dataclasses.replace(
            s, doc_length=torch.from_numpy(full),
            max_doc_length=int(full.max(initial=0))))
    plan = PartitionPlan(mode, (), (), num_doc_shards, num_word_shards,
                         *plan_words)
    return shards, plan


def canonical_phi(blocks: np.ndarray, plan: PartitionPlan) -> np.ndarray:
    """(n_word, vocab_shard_size, K) word-shard phi blocks of a 2d plan ->
    the (V, K) phi in word order: word v is row ``word_local_id[v]`` of
    block ``word_shard_of[v]``; padding rows drop out."""
    rows = (plan.word_shard_of.astype(np.int64) * plan.vocab_shard_size
            + plan.word_local_id)
    return blocks.reshape(-1, blocks.shape[-1])[rows]


def axes_group(mesh, axes: Sequence[str]):
    """The process group over ``axes`` of ``mesh`` that holds this rank,
    its ranks in row-major order of those axes; None for no axes.  Over
    several axes every rank creates every such group (``new_group`` is
    collective)."""
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    rest = [i for i in range(mesh.ndim) if i not in dims]
    size = math.prod(mesh.shape[i] for i in dims)
    table = mesh.mesh.permute(*rest, *dims).reshape(-1, size).tolist()
    me, mine = dist.get_rank(), None
    for ranks in table:
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def mesh_device(mesh, device=None) -> torch.device:
    """This rank's device for a mesh: ``device``, else the mesh's device
    type (the current card for ``cuda``).  A ``cuda`` mesh without CUDA
    raises; no mesh moves to another device type."""
    dev = resolve_device(mesh.device_type if device is None else device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} is not on the {mesh.device_type} "
                         "mesh")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(|group|, *x.shape): ``x`` from every rank of ``group`` in group
    order, carried as bytes (any element type; gloo and NCCL take no
    int16)."""
    G = dist.get_world_size(group)
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    out = torch.empty(G * raw.numel(), dtype=torch.uint8, device=x.device)
    sync.all_gather_bytes(out, raw, group)
    return out.view(x.dtype).view(G, *x.shape)


class DistributedLDA:
    """Mesh-wide LDA, one rank's part: its shard, the groups, the step.

    1d (paper): ``doc_axes`` = every mesh axis, ``word_axes=()``.
    2d:         ``doc_axes`` = e.g. ("data",), ``word_axes=("model",)``.

    ``tracer`` records ``step``'s and ``log_likelihood``'s phase spans
    (``core/trainer.py``'s module docstring), ``lda.stats`` among them.
    """

    def __init__(self, cfg: core_trainer.LDAConfig, mesh, corpus: Corpus,
                 mode: str = "1d", doc_axes: Sequence[str] | None = None,
                 word_axes: Sequence[str] = ("model",), device=None,
                 tracer: SpanTracer = NULL_TRACER):
        self.device = mesh_device(mesh, device)
        self.tracer = tracer
        cfg = core_trainer.resolve_config(cfg, corpus)
        self.cfg = cfg
        self.mesh = mesh
        self.corpus = corpus
        self.num_tokens = corpus.num_tokens
        names = tuple(mesh.mesh_dim_names)
        word_axes = tuple(word_axes) if mode == "2d" else ()
        if doc_axes is None:
            doc_axes = tuple(a for a in names if a not in word_axes)
        doc_axes = tuple(doc_axes)
        sizes = dict(zip(names, mesh.shape))
        coord = dict(zip(names, mesh.get_coordinate()))
        if sorted(doc_axes + word_axes) != sorted(names):
            raise ValueError(f"doc_axes {doc_axes} and word_axes "
                             f"{word_axes} must cover the mesh's {names} "
                             "once each")

        def flat(axes):
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + coord[a]
            return idx

        n_doc = math.prod(sizes[a] for a in doc_axes)
        n_word = math.prod(sizes[a] for a in word_axes)
        self.num_shards = n_doc * n_word
        self.rank = flat(doc_axes) * n_word + flat(word_axes)   # shard g
        shards, plan = build_shards(corpus, n_doc, n_word, mode,
                                    cfg.tile_tokens, only=self.rank)
        self.plan = dataclasses.replace(plan, doc_axes=doc_axes,
                                        word_axes=word_axes)
        self.shard = shards[0].to(self.device)
        self._mode = mode
        self.data_group = axes_group(mesh, doc_axes)
        self.model_group = axes_group(mesh, word_axes)
        self.all_group = (self.data_group if mode == "1d"
                          else axes_group(mesh, doc_axes + word_axes))
        rows = heavy_word_rows(corpus, self.plan)[self.rank] \
            if cfg.compressed_sync else np.zeros(0, np.int32)
        self.heavy_rows = (torch.from_numpy(rows.astype(np.int64))
                           .to(self.device) if rows.size else None)
        # K2's tables, built here with their host syncs, not in a step
        phi_ops.shard_segments(self.shard)
        if cfg.sync_overlap and cfg.micro_chunks > 1:
            phi_ops.shard_chunk_segments(self.shard, cfg.micro_chunks)
        self._token_uid = None      # every shard's uids, gathered on need

    def _groups(self):
        return dict(data_group=self.data_group, model_group=self.model_group)

    # -- public API ---------------------------------------------------------
    def init(self, seed: int | None = None) -> core_trainer.LDAState:
        """Uniform random assignments, drawn per shard from (seed, g)."""
        gen = core_trainer.seeded_generator(
            [self.cfg.seed if seed is None else seed, self.rank], self.device)
        return core_trainer.init_state(self.cfg, self.shard, gen,
                                       **self._groups())

    def step(self, state, uniforms: torch.Tensor | None = None):
        """One iteration on this rank's shard and the syncs; ``uniforms``
        as ``trainer.lda_iteration`` takes them, drawn from (seed,
        iteration, g) when not given.  Stats are the mesh's: mean sparse
        share and S/(S+Q) over the ranks, overflowed docs summed (counted
        once per document in 2d)."""
        tracer = self.tracer
        with tracer.span("lda.step", iteration=state.iteration):
            if uniforms is None:
                with tracer.span("lda.uniforms"):
                    uniforms = core_trainer.iteration_uniforms(
                        self.cfg, state, self.rank)
            st, stats = core_trainer.iteration_in_step(
                self.cfg, self.shard, state, uniforms,
                heavy_rows=self.heavy_rows, tracer=tracer, **self._groups())
            with tracer.span("lda.stats"):
                v = torch.stack([stats.sparse_frac.float(),
                                 stats.mean_s_over_sq.float(),
                                 stats.ell_overflow.float()])
                sparse, ssq, over = sync.maybe_all_reduce(
                    v, self.all_group).unbind()
                return st, core_trainer.IterStats(
                    sparse_frac=sparse / self.num_shards,
                    ell_overflow=torch.floor_divide(
                        over, self.plan.num_word_shards),
                    mean_s_over_sq=ssq / self.num_shards)

    def log_likelihood(self, state) -> float:
        """Joint LL per token of the whole corpus (the same on every rank)."""
        return float(core_trainer.log_likelihood(
            self.cfg, self.shard, state, tracer=self.tracer,
            **self._groups())) / self.num_tokens

    def restore(self, z_canon: np.ndarray, iteration: int):
        """Elastic restore: canonical z -> state on THIS mesh and partition,
        whatever rank count or mode wrote it (counts are rebuilt from the
        re-tiled assignments)."""
        z = ckpt.scatter_canonical_z(z_canon, self.shard.token_uid)
        zt = torch.from_numpy(z.astype(np.int64)).to(self.device).to(
            self.cfg.topic_dtype)
        return core_trainer.state_from_z(self.cfg, self.shard, zt, iteration,
                                         **self._groups())

    def gather_canonical_z(self, state) -> np.ndarray:
        """(T,) int16 canonical z from every shard (collective)."""
        if self._token_uid is None:
            self._token_uid = _all_gather(self.shard.token_uid,
                                          self.all_group).cpu()
        z = _all_gather(state.z, self.all_group)
        return ckpt.gather_canonical_z(z, self._token_uid, self.num_tokens)

    def save_checkpoint(self, mgr, state, extra_meta: dict | None = None):
        """Gather z (collective); rank 0 writes the checkpoint."""
        z_canon = self.gather_canonical_z(state)
        if self.rank != 0:
            return
        meta = dict(extra_meta or {})
        meta.setdefault("mode", self._mode)
        meta.setdefault("fingerprint", ckpt.corpus_fingerprint(self.corpus))
        meta.setdefault("num_topics", self.cfg.num_topics)
        mgr.save(int(state.iteration), z_canon, meta)

    # -- serving export -----------------------------------------------------
    def gather_phi(self, state) -> np.ndarray:
        """Canonical (V, K) int32 phi from a state trained on this partition
        (collective in 2d).

        1d: phi is replicated, so this rank's replica is the model.  2d:
        the word shards' blocks, gathered over the model group, are in
        (shard, LPT-local row) order, not word order; exporting them as
        they are would serve a permuted model, so the rows are un-permuted
        through the plan's word maps (dropping the padding rows of shards
        with fewer than ``vocab_shard_size`` words)."""
        if self.plan.mode == "1d":
            return state.phi_vk.cpu().numpy()
        return canonical_phi(
            _all_gather(state.phi_vk, self.model_group).cpu().numpy(),
            self.plan)

    def _publish(self, mgr, state, vocab=None, meta: dict | None = None,
                 shards: int | None = None) -> str:
        """Snapshot of the model (``mgr.publish_snapshot(state,
        partition=self, shards=N)``), a collective: rank 0 writes, every
        rank returns the path.

        * ``shards`` unset or 1: the canonical phi, gathered, as a dense
          ``.npz``;
        * 2d with ``shards`` equal to the word-shard count: each word
          shard's own block under the plan's LPT maps
          (``meta["layout"] = "lpt"``); the ranks of rank 0's model group
          send their blocks to it one at a time and it writes each as it
          comes, so no rank holds a (V, K) buffer;
        * any other ``shards``: the canonical phi gathered and re-split
          contiguously (``"contiguous"``)."""
        from repro_torch.serve import snapshot as snap_mod

        it = int(state.iteration)
        alpha, beta = self.cfg.resolved_alpha(), self.cfg.beta
        meta_full = dict(meta or {}, mode=self._mode)
        if not shards or shards <= 1:
            phi = torch.from_numpy(self.gather_phi(state))
            if self.rank != 0:
                return mgr.snapshot_path(it)
            state_c = state._replace(phi_vk=phi, phi_sum=state.phi_sum.cpu())
            return mgr.publish_snapshot(
                state_c, alpha, beta, num_words_total=self.corpus.num_words,
                vocab=vocab, meta=meta_full)

        plan = self.plan
        n_word = plan.num_word_shards
        if self._mode == "2d" and shards == n_word:
            meta_full["layout"] = "lpt"
            if self.rank // n_word != 0:      # not in rank 0's model group
                return mgr.snapshot_path(it, sharded=True)
            ranks = dist.get_process_group_ranks(self.model_group)
            block = state.phi_vk.contiguous()
            if self.rank != 0:
                dist.send(block, dst=ranks[0])
                return mgr.snapshot_path(it, sharded=True)

            def blocks():
                yield block
                buf = torch.empty_like(block)
                for src in ranks[1:]:
                    dist.recv(buf, src=src)
                    yield buf

            shard_of, local_id = plan.word_shard_of, plan.word_local_id
            block_iter = blocks()
        else:
            meta_full["layout"] = "contiguous"
            phi = self.gather_phi(state)
            if self.rank != 0:
                return mgr.snapshot_path(it, sharded=True)
            block_iter, shard_of, local_id = snap_mod.split_dense_phi(
                phi, shards)
        return mgr.publish_snapshot(
            iteration=it, blocks=block_iter, phi_sum=state.phi_sum,
            shard_of=shard_of, local_id=local_id, alpha=alpha, beta=beta,
            num_words_total=self.corpus.num_words, vocab=vocab,
            meta=meta_full)
