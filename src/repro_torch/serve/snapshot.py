"""Frozen-model snapshots + hot-swap: the train/serve publication boundary.

The port's counterpart of ``repro.serve.snapshot``, dense layout only.  A
snapshot freezes what a server needs: phi_vk (V, K), phi_sum (K,), the
hyperparams of Eq. 1 and optionally the vocabulary strings, as tensors on
one device.

On disk it is the same ``.npz`` + ``meta_json`` format the JAX package
writes, so snapshots cross between the two packages in both directions.
Writes are atomic (tmp + fsync + rename): a snapshot is either absent or
complete.

``HotSwapModel`` double-buffers publication: the incoming snapshot is
already device-resident when ``publish`` flips the active index, so the
critical section is a pointer swap and in-flight batches keep the buffer
they acquired.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve.faults import FaultPlan

_FORMAT_VERSION = 1


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


class HotSwapModel:
    """Double-buffered snapshot holder: publish() while serving continues.

    Readers call ``acquire()`` and keep using the returned snapshot for the
    whole batch even if a publish lands mid-flight; the next batch picks up
    the new buffer.  Device staging happens before the flip (the snapshot
    is constructed device-resident), so the critical section is a pointer
    swap.
    """

    def __init__(self, snap: ModelSnapshot,
                 fault_plan: FaultPlan | None = None):
        self._buffers: list[ModelSnapshot | None] = [snap, None]
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

    def acquire(self) -> tuple[int, ModelSnapshot]:
        with self._lock:
            return self._version, self._buffers[self._active]

    def publish(self, snap: ModelSnapshot) -> int:
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
