"""Frozen-model snapshots + hot-swap: the train/serve publication boundary.

The port's counterpart of ``repro.serve.snapshot``.  A snapshot freezes what
a server needs: phi_vk (V, K), phi_sum (K,), the hyperparams of Eq. 1 and
optionally the vocabulary strings, as tensors on the serving device(s).

Two on-disk layouts, the same bytes-on-disk format the JAX package writes,
so snapshots cross between the two packages in both directions; both are
written atomically (staged, fsynced, renamed), so a snapshot is either
absent or complete:

* **dense** — one ``.npz`` (count arrays + vocab) with an embedded JSON
  meta entry; loads to a ``ModelSnapshot`` on one device.
* **V-sharded** — a ``.sharded`` directory: ``manifest.json`` (shape,
  hyperparams, comm tag, a crc32 per shard file, meta), ``maps.npz`` (the
  (V,) word->shard and word->local-row maps, phi_sum, vocab) and one
  ``shard_NNNN.npz`` (key ``phi_vk``) per phi block.  Loads to a
  ``ShardedModelSnapshot``: one (Vs, K) block on each of a tuple of
  devices, for models whose (V, K) phi outgrows one card.  One process
  drives every device; the fold-in moves rows between them with device to
  device copies (``serve/infer.py``).

``HotSwapModel`` double-buffers publication: the incoming snapshot is
already device-resident when ``publish`` flips the active index, so the
critical section is a pointer swap and in-flight batches keep the buffer
they acquired.  Dense and sharded snapshots hot-swap interchangeably.
"""
from __future__ import annotations

import dataclasses
import functools
import io
import json
import os
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve.faults import FaultPlan

_FORMAT_VERSION = 1
SHARDED_SUFFIX = ".sharded"
_MANIFEST = "manifest.json"
_MAPS = "maps.npz"


class SnapshotIntegrityError(RuntimeError):
    """A sharded snapshot file failed its integrity check (corrupt or
    truncated shard) — raised instead of serving garbage phi rows."""


class PublishError(RuntimeError):
    """A hot-swap publish failed before the flip: the active snapshot is
    untouched (rollback is implicit in the double-buffered design)."""


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    """Device-resident frozen model (everything Eq. 1 needs at serve time)."""

    phi_vk: torch.Tensor     # (V, K) int32 topic-word counts
    phi_sum: torch.Tensor    # (K,) int32 per-topic totals
    alpha: float
    beta: float
    num_words_total: int     # Eq. 1's V
    meta: dict = dataclasses.field(default_factory=dict)
    vocab: tuple[str, ...] | None = None

    @property
    def num_topics(self) -> int:
        return int(self.phi_sum.shape[0])

    @property
    def num_words(self) -> int:
        return int(self.phi_vk.shape[0])

    @property
    def device(self) -> torch.device:
        return self.phi_vk.device

    def __post_init__(self):
        self.hyper   # staged now: a batch under a sync guard copies nothing

    @functools.cached_property
    def hyper(self) -> torch.Tensor:
        """[alpha, beta] staged on the device once, so a serving batch never
        re-transfers scalar hyperparams."""
        return torch.tensor([self.alpha, self.beta], dtype=torch.float32,
                            device=self.device)

    def topic_words(self, k: int, n: int = 10) -> list[str]:
        """Top-n vocabulary entries of topic k (debug/explain endpoint)."""
        col = self.phi_vk[:, k].cpu().numpy()
        top = np.argsort(-col, kind="stable")[:n]
        if self.vocab is None:
            return [str(v) for v in top]
        return [self.vocab[v] for v in top]


def snapshot_from_numpy(phi_vk, phi_sum, alpha: float, beta: float,
                        num_words_total: int, meta: dict | None = None,
                        vocab: Sequence[str] | None = None,
                        device=None) -> ModelSnapshot:
    """The carry-across function: a model held as numpy arrays (for example
    ``np.asarray`` of a JAX snapshot's ``phi_vk``/``phi_sum``) -> the port's
    snapshot on ``device`` (``cuda:0`` unless given)."""
    dev = resolve_device(device)
    # np.array copies: the frozen model never aliases the caller's memory
    return ModelSnapshot(
        phi_vk=torch.from_numpy(np.array(phi_vk, np.int32)).to(dev),
        phi_sum=torch.from_numpy(np.array(phi_sum, np.int32)).to(dev),
        alpha=float(alpha), beta=float(beta),
        num_words_total=int(num_words_total),
        meta=dict(meta or {}),
        vocab=tuple(vocab) if vocab is not None else None)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def snapshot_from_state(
    state,                       # duck-typed: .phi_vk / .phi_sum / .iteration
    alpha: float,
    beta: float,
    num_words_total: int | None = None,
    vocab: Sequence[str] | None = None,
    meta: dict[str, Any] | None = None,
    device=None,
) -> ModelSnapshot:
    """Export the frozen serving model from a training state (numpy arrays
    or tensors)."""
    m = dict(meta or {})
    m.setdefault("iteration", int(_host(state.iteration)))
    m.setdefault("created_at", time.time())
    phi = _host(state.phi_vk)
    return snapshot_from_numpy(phi, _host(state.phi_sum), alpha, beta,
                               int(num_words_total or phi.shape[0]), meta=m,
                               vocab=vocab, device=device)


def save_snapshot(path: str, snap: ModelSnapshot) -> str:
    """Atomic write: a crash mid-save never leaves a truncated snapshot."""
    payload = dict(
        phi_vk=_host(snap.phi_vk).astype(np.int32),
        phi_sum=_host(snap.phi_sum).astype(np.int32),
        meta_json=np.frombuffer(json.dumps({
            "version": _FORMAT_VERSION,
            "alpha": snap.alpha,
            "beta": snap.beta,
            "num_words_total": snap.num_words_total,
            "meta": snap.meta,
        }).encode(), dtype=np.uint8),
    )
    if snap.vocab is not None:
        payload["vocab"] = np.asarray(snap.vocab, dtype=np.str_)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_snapshot(path: str, device=None) -> ModelSnapshot:
    """Load a snapshot onto ``device`` (``cuda:0`` unless given)."""
    with np.load(path, allow_pickle=False) as d:
        meta = json.loads(bytes(d["meta_json"]).decode())
        vocab = tuple(str(w) for w in d["vocab"]) if "vocab" in d else None
        return snapshot_from_numpy(
            d["phi_vk"], d["phi_sum"], meta["alpha"], meta["beta"],
            meta["num_words_total"], meta=meta.get("meta", {}), vocab=vocab,
            device=device)


# ---------------------------------------------------------------------------
# V-sharded snapshots
# ---------------------------------------------------------------------------

class ShardReplica(NamedTuple):
    """What every shard's device holds besides its phi block: the
    replicated maps and totals a gather or a sweep there reads."""

    phi_sum: torch.Tensor        # (K,) int32
    hyper: torch.Tensor          # (2,) float32 [alpha, beta]
    word_shard_of: torch.Tensor  # (V,) int64 — owning shard per word id
    word_local_id: torch.Tensor  # (V,) int64 — row within the owner's block


@dataclasses.dataclass(frozen=True)
class ShardedModelSnapshot:
    """Frozen model whose phi is word-sharded over several devices.

    ``phi_blocks[s]`` on ``devices[s]`` holds the rows of the words
    ``word_shard_of`` assigns to shard s, at local row ``word_local_id``,
    so the model loads even when (V, K) exceeds one device.  The maps make
    the layout general: contiguous blocks (``plan_contiguous_shards``) and
    the 2d trainer's LPT-balanced shards serve through the same gather.
    ``devices[0]`` is the lead: a batch's one H2D copy, the sweeps under
    ``comm="psum"`` and the assembled result live there.  Several shards
    may share a device.
    """

    phi_blocks: tuple[torch.Tensor, ...]  # (Vs, K) int32, one per device
    phi_sum: torch.Tensor        # (K,) int32 on the lead device
    word_shard_of: np.ndarray    # (V,) int32 host map — owning shard
    word_local_id: np.ndarray    # (V,) int32 host map — row in its block
    alpha: float
    beta: float
    num_words_total: int
    devices: tuple[torch.device, ...]
    comm: str = "psum"       # default gather strategy ("psum" | "all2all");
    #                          InferConfig(comm="auto") defers to this tag
    meta: dict = dataclasses.field(default_factory=dict)
    vocab: tuple[str, ...] | None = None

    def __post_init__(self):
        self.replicas   # staged now: a batch under a sync guard copies nothing

    @property
    def num_topics(self) -> int:
        return int(self.phi_sum.shape[0])

    @property
    def num_words(self) -> int:
        """Valid word-id bound — the full vocabulary (every id routable)."""
        return int(self.word_shard_of.shape[0])

    @property
    def num_shards(self) -> int:
        return len(self.phi_blocks)

    @property
    def device(self) -> torch.device:
        """The lead device."""
        return self.devices[0]

    @property
    def host_word_shard_of(self) -> np.ndarray:
        """The word->shard map on the host: the engine plans the all2all
        routing of a batch from it without a device->host read."""
        return self.word_shard_of

    @functools.cached_property
    def replicas(self) -> tuple[ShardReplica, ...]:
        """Shard s's ``ShardReplica`` on ``devices[s]`` (one copy a
        device, shared by the shards there)."""
        made: dict[torch.device, ShardReplica] = {}
        hyper = torch.tensor([self.alpha, self.beta], dtype=torch.float32)
        shard_of = torch.from_numpy(self.word_shard_of.astype(np.int64))
        local_id = torch.from_numpy(self.word_local_id.astype(np.int64))
        for dev in self.devices:
            if dev not in made:
                made[dev] = ShardReplica(self.phi_sum.to(dev), hyper.to(dev),
                                         shard_of.to(dev), local_id.to(dev))
        return tuple(made[dev] for dev in self.devices)

    @property
    def hyper(self) -> torch.Tensor:
        """[alpha, beta] on the lead device."""
        return self.replicas[0].hyper

    def assemble(self, device=None) -> ModelSnapshot:
        """Gather to a dense ``ModelSnapshot`` on ``device`` (the lead
        device unless given; tests and offline eval — the serving path
        never builds it)."""
        phi = _host_rows(self.phi_blocks, self.word_shard_of,
                         self.word_local_id)
        return snapshot_from_numpy(
            phi, _host(self.phi_sum), self.alpha, self.beta,
            self.num_words_total, meta=self.meta, vocab=self.vocab,
            device=self.device if device is None else device)


def _host_rows(blocks, shard_of, local_id) -> np.ndarray:
    """(V, K) phi in word order from per-shard blocks and the maps."""
    blocks = [_host(b) for b in blocks]
    phi = np.empty((len(shard_of), blocks[0].shape[1]), np.int32)
    for s, blk in enumerate(blocks):
        words = np.flatnonzero(shard_of == s)
        phi[words] = blk[local_id[words]]
    return phi


def plan_contiguous_shards(num_words: int, num_shards: int):
    """Contiguous word->shard layout: shard s owns rows [s*Vs, (s+1)*Vs).

    Returns (shard_of (V,), local_id (V,), rows_per_shard)."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    rows = -(-num_words // num_shards)   # ceil
    ids = np.arange(num_words, dtype=np.int64)
    return ((ids // rows).astype(np.int32), (ids % rows).astype(np.int32),
            int(rows))


def serving_devices(num_shards: int, device=None) -> tuple[torch.device, ...]:
    """The devices ``num_shards`` phi blocks are placed on: one card each,
    ``cuda:0`` .. ``cuda:S-1`` (``device`` None or ``"cuda"``), or S
    entries of the CPU (``device="cpu"``).  Raises when there are fewer
    cards than shards; a caller that wants several shards on one card
    passes the devices explicitly (``devices=``)."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return (dev,) * num_shards
    if dev.type != "cuda":
        raise ValueError(f"cannot serve phi shards on {dev}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < num_shards:
        raise ValueError(
            f"serving {num_shards} phi shards needs {num_shards} CUDA "
            f"devices; have {have} (pass devices= to place several shards "
            "on one card, or device='cpu')")
    return tuple(torch.device("cuda", i) for i in range(num_shards))


def split_dense_phi(phi, num_shards: int):
    """(V, K) dense phi -> contiguous (S, Vs, K) blocks + their word maps.

    The one place the dense->sharded split lives: ``shard_snapshot``,
    ``save_sharded_snapshot`` and ``DistributedLDA._publish``'s re-split
    all call this."""
    phi = _host(phi).astype(np.int32, copy=False)
    shard_of, local_id, rows = plan_contiguous_shards(phi.shape[0],
                                                      num_shards)
    blocks = np.zeros((num_shards, rows, phi.shape[1]), np.int32)
    blocks[shard_of, local_id] = phi
    return blocks, shard_of, local_id


def _sharded_from_blocks(blocks, phi_sum, shard_of, local_id, alpha, beta,
                         num_words_total, meta, vocab, devices=None,
                         comm: str = "psum",
                         device=None) -> ShardedModelSnapshot:
    """Place host blocks on their devices: block s on ``devices[s]``
    (``serving_devices(S, device)`` unless given), phi_sum on the lead."""
    blocks = list(blocks)
    devices = tuple(torch.device(d) for d in (
        devices if devices is not None
        else serving_devices(len(blocks), device)))
    if len(devices) != len(blocks):
        raise ValueError(f"{len(devices)} devices for {len(blocks)} phi "
                         "shards")
    return ShardedModelSnapshot(
        phi_blocks=tuple(torch.from_numpy(np.array(_host(b), np.int32))
                         .to(dev) for b, dev in zip(blocks, devices)),
        phi_sum=torch.from_numpy(np.array(_host(phi_sum), np.int32))
        .to(devices[0]),
        word_shard_of=np.array(shard_of, np.int32),
        word_local_id=np.array(local_id, np.int32),
        alpha=float(alpha), beta=float(beta),
        num_words_total=int(num_words_total), devices=devices,
        comm=str(comm), meta=dict(meta or {}),
        vocab=tuple(vocab) if vocab is not None else None)


def shard_snapshot(snap: ModelSnapshot, num_shards: int, devices=None,
                   comm: str = "psum", device=None) -> ShardedModelSnapshot:
    """Split a dense snapshot into ``num_shards`` contiguous word blocks,
    block s on ``devices[s]`` (in memory; no disk round-trip)."""
    blocks, shard_of, local_id = split_dense_phi(snap.phi_vk, num_shards)
    return _sharded_from_blocks(
        blocks, snap.phi_sum, shard_of, local_id, snap.alpha, snap.beta,
        snap.num_words_total, snap.meta, snap.vocab, devices, comm=comm,
        device=device)


def write_sharded_snapshot(path: str, blocks, phi_sum, shard_of, local_id, *,
                           alpha: float, beta: float, num_words_total: int,
                           meta: dict | None = None, vocab=None,
                           comm: str = "psum") -> str:
    """Write the sharded layout (the low-level writer that
    ``save_sharded_snapshot`` and the trainers' publish land in).

    ``blocks`` is any iterable of (Vs, K) arrays or tensors, read one at a
    time: a publisher that receives its blocks one by one passes a
    generator and never holds the whole phi.  Atomic at directory level:
    everything is staged in a temporary directory (each file fsynced), the
    old copy moved aside, the new one renamed in, and only then the old
    one dropped — no moment without a complete snapshot."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, suffix=".tmp")

    def _put(name: str, writer):
        with open(os.path.join(tmp, name), "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())

    try:
        maps = dict(word_shard_of=np.asarray(shard_of, np.int32),
                    word_local_id=np.asarray(local_id, np.int32),
                    phi_sum=_host(phi_sum).astype(np.int32))
        if vocab is not None:
            maps["vocab"] = np.asarray(vocab, dtype=np.str_)
        _put(_MAPS, lambda f: np.savez_compressed(f, **maps))
        crcs, shape = {}, None
        for s, blk in enumerate(blocks):
            blk = _host(blk).astype(np.int32, copy=False)
            if shape is not None and blk.shape != shape:
                raise ValueError(f"phi block {s} has shape {blk.shape}, "
                                 f"block 0 {shape}")
            shape = blk.shape
            name = f"shard_{s:04d}.npz"
            _put(name, lambda f, b=blk: np.savez_compressed(f, phi_vk=b))
            with open(os.path.join(tmp, name), "rb") as f:
                crcs[name] = zlib.crc32(f.read())
        if shape is None:
            raise ValueError("a sharded snapshot needs at least one block")
        # the manifest last, after the crc32s it records
        manifest = {
            "version": _FORMAT_VERSION,
            "num_shards": len(crcs),
            "rows_per_shard": int(shape[0]),
            "num_topics": int(shape[1]),
            "num_words_total": int(num_words_total),
            "alpha": float(alpha),
            "beta": float(beta),
            "comm": str(comm),
            "crc32": crcs,
            "meta": dict(meta or {}),
        }
        _put(_MANIFEST, lambda f: f.write(json.dumps(manifest).encode()))
        stale = None
        if os.path.exists(path):
            stale = tempfile.mkdtemp(dir=parent, suffix=".stale")
            os.rmdir(stale)
            os.replace(path, stale)
        os.replace(tmp, path)
        if stale is not None:
            shutil.rmtree(stale)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    return path


def save_sharded_snapshot(path: str, snap, num_shards: int | None = None) -> str:
    """Save ``snap`` in the sharded layout: a ``ShardedModelSnapshot``
    keeps its own layout, a dense ``ModelSnapshot`` is split contiguously
    into ``num_shards`` blocks."""
    if isinstance(snap, ShardedModelSnapshot):
        return write_sharded_snapshot(
            path, snap.phi_blocks, snap.phi_sum, snap.word_shard_of,
            snap.word_local_id, alpha=snap.alpha, beta=snap.beta,
            num_words_total=snap.num_words_total, meta=snap.meta,
            vocab=snap.vocab, comm=snap.comm)
    if not num_shards:
        raise ValueError("num_shards required to shard a dense snapshot")
    blocks, shard_of, local_id = split_dense_phi(snap.phi_vk, num_shards)
    return write_sharded_snapshot(
        path, blocks, snap.phi_sum, shard_of, local_id, alpha=snap.alpha,
        beta=snap.beta, num_words_total=snap.num_words_total,
        meta=snap.meta, vocab=snap.vocab)


def is_sharded_snapshot_path(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, _MANIFEST))


def _read_sharded(path: str, fault_plan: FaultPlan | None = None):
    """Host-side read of the sharded layout -> (blocks, maps, manifest).

    Each shard file is crc32-checked against the manifest: a corrupt or
    truncated shard raises :class:`SnapshotIntegrityError`.  ``fault_plan``
    polls ``shard_load_error`` once per shard file: a ``delay_s``-only spec
    makes the read slow, any other makes it fail."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, _MAPS), allow_pickle=False) as d:
        maps = {k: d[k] for k in d.files}
    crcs = manifest.get("crc32", {})
    blocks = []
    for s in range(int(manifest["num_shards"])):
        name = f"shard_{s:04d}.npz"
        if fault_plan is not None:
            spec = fault_plan.check("shard_load_error")
            if spec is not None:
                if spec.delay_s > 0:
                    time.sleep(spec.delay_s)
                else:
                    raise SnapshotIntegrityError(
                        f"injected corrupt shard read: {name}")
        with open(os.path.join(path, name), "rb") as f:
            raw = f.read()
        if name in crcs and zlib.crc32(raw) != crcs[name]:
            raise SnapshotIntegrityError(
                f"crc32 mismatch for {name}: snapshot shard is corrupt or "
                f"truncated (expected {crcs[name]})")
        with np.load(io.BytesIO(raw), allow_pickle=False) as d:
            blocks.append(d["phi_vk"])
    return blocks, maps, manifest


def load_sharded_snapshot(path: str, devices=None, comm: str | None = None,
                          fault_plan: FaultPlan | None = None,
                          device=None) -> ShardedModelSnapshot:
    """Load a sharded snapshot, block s on ``devices[s]``
    (``serving_devices(S, device)`` unless given).  ``comm`` overrides the
    snapshot's published gather strategy (else the manifest's, else
    ``"psum"``)."""
    blocks, maps, manifest = _read_sharded(path, fault_plan=fault_plan)
    vocab = [str(w) for w in maps["vocab"]] if "vocab" in maps else None
    return _sharded_from_blocks(
        blocks, maps["phi_sum"], maps["word_shard_of"], maps["word_local_id"],
        manifest["alpha"], manifest["beta"], manifest["num_words_total"],
        manifest.get("meta", {}), vocab, devices,
        comm=comm or manifest.get("comm", "psum"), device=device)


def assemble_sharded_snapshot(path: str, device=None) -> ModelSnapshot:
    """Read a sharded snapshot into a dense ``ModelSnapshot`` on ``device``
    (``cuda:0`` unless given; verification, or serving a small model
    unsharded)."""
    blocks, maps, manifest = _read_sharded(path)
    vocab = (tuple(str(w) for w in maps["vocab"]) if "vocab" in maps
             else None)
    return snapshot_from_numpy(
        _host_rows(blocks, maps["word_shard_of"], maps["word_local_id"]),
        maps["phi_sum"], manifest["alpha"], manifest["beta"],
        manifest["num_words_total"], meta=manifest.get("meta", {}),
        vocab=vocab, device=device)


def load_any_snapshot(path: str, devices=None, shards: int | None = None,
                      comm: str | None = None,
                      fault_plan: FaultPlan | None = None, device=None):
    """Dispatch on layout: a ``.sharded`` directory loads sharded, a dense
    ``.npz`` onto ``device``; ``shards > 1`` re-shards a dense snapshot at
    load time (``serve_lda --shards``), never placing the whole phi on a
    card.  ``comm`` tags a sharded result's gather strategy
    (``serve_lda --comm``)."""
    if is_sharded_snapshot_path(path):
        return load_sharded_snapshot(path, devices, comm=comm,
                                     fault_plan=fault_plan, device=device)
    if shards and shards > 1:
        return shard_snapshot(load_snapshot(path, device="cpu"), shards,
                              devices, comm=comm or "psum", device=device)
    return load_snapshot(path, device=device)


class HotSwapModel:
    """Double-buffered snapshot holder: publish() while serving continues.

    Readers call ``acquire()`` and keep using the returned snapshot for the
    whole batch even if a publish lands mid-flight; the next batch picks up
    the new buffer.  Device staging happens before the flip (the snapshot
    is constructed device-resident), so the critical section is a pointer
    swap.
    """

    def __init__(self, snap: ModelSnapshot | ShardedModelSnapshot,
                 fault_plan: FaultPlan | None = None):
        self._buffers: list[ModelSnapshot | ShardedModelSnapshot | None] = [
            snap, None]
        self._active = 0
        self._version = 1
        self._publish_failures = 0
        self._fault_plan = fault_plan
        self._lock = threading.Lock()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def publish_failures(self) -> int:
        with self._lock:
            return self._publish_failures

    def acquire(self) -> tuple[int, ModelSnapshot | ShardedModelSnapshot]:
        with self._lock:
            return self._version, self._buffers[self._active]

    def publish(self, snap: ModelSnapshot | ShardedModelSnapshot) -> int:
        """Stage into the inactive buffer, then flip.  Returns new version.

        Anything that goes wrong before the flip (an injected
        ``publish_failure``) raises :class:`PublishError` and leaves the
        active buffer — the last good snapshot — untouched."""
        if self._fault_plan is not None:
            fault = self._fault_plan.check("publish_failure")
            if fault is not None:
                with self._lock:
                    self._publish_failures += 1
                raise PublishError(
                    "injected publish failure before flip; active snapshot "
                    "rolled back (unchanged)")
        with self._lock:
            inactive = 1 - self._active
            self._buffers[inactive] = snap
            self._active = inactive
            self._version += 1
            return self._version
