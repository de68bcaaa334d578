"""Checkpoints of training state and published serving snapshots, in the
on-disk format of ``repro.distributed.checkpoint``: a checkpoint written by
one package restores in the other.

The whole mutable state of CGS-LDA is the assignment vector z; theta and
phi are counts rebuilt exactly from it.  A checkpoint is therefore:

    ckpt_<iteration>.npz   z  (T,) int16, topic per token in canonical
                              corpus order
    ckpt_<iteration>.json  iteration, corpus fingerprint, config

* atomic — written to a temporary file, fsynced and renamed; a crash
  mid-save leaves the previous checkpoint intact;
* async  — the device-to-host copy is synchronous, the file write runs on a
  background thread so sampling continues;
* elastic — restore re-tiles z onto whatever tiling the run has.

Snapshots publish the derived frozen model (phi + hyperparameters) to the
serving side, as dense ``.npz`` files or V-sharded ``.sharded`` directories
(``shards=N``; listing and pruning treat both alike).  A state trained over
a mesh publishes through its partition (``publish_snapshot(state,
partition=dl)``), which writes the canonical phi, or a 2d trainer's own
word blocks.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.corpus import Corpus

_FORMAT_VERSION = 1


def corpus_fingerprint(corpus: Corpus) -> str:
    h = hashlib.sha256()
    h.update(np.asarray([corpus.num_docs, corpus.num_words,
                         corpus.num_tokens]).tobytes())
    h.update(corpus.word_ids[:4096].tobytes())
    h.update(corpus.word_ids[-4096:].tobytes())
    return h.hexdigest()[:16]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gather_canonical_z(state_z, token_uid, num_tokens: int) -> np.ndarray:
    """(n, t) tiled z + uids (tensors or arrays) -> (T,) canonical int16."""
    z = _host(state_z).reshape(-1)
    uid = _host(token_uid).reshape(-1)
    valid = uid >= 0
    out = np.zeros(num_tokens, dtype=np.int16)
    out[uid[valid]] = z[valid].astype(np.int16)
    return out


def scatter_canonical_z(z_canon: np.ndarray, token_uid) -> np.ndarray:
    """(T,) canonical z -> tiled z (numpy int16) in ``token_uid``'s layout."""
    uid = _host(token_uid)
    flat = uid.reshape(-1)
    z = np.zeros(flat.shape, dtype=np.int16)
    valid = flat >= 0
    z[valid] = z_canon[flat[valid]]
    return z.reshape(uid.shape)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------
    def save(self, iteration: int, z_canon: np.ndarray, meta: dict[str, Any]):
        self.wait()  # one outstanding write at a time
        meta = dict(meta, iteration=int(iteration), version=_FORMAT_VERSION,
                    wall_time=time.time())

        def _write():
            name = f"ckpt_{iteration:08d}"
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez_compressed(f, z=z_canon)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, os.path.join(self.dir, name + ".npz"))
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            mtmp = os.path.join(self.dir, name + ".json.tmp")
            with open(mtmp, "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, os.path.join(self.dir, name + ".json"))
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.list_steps()[: -self.keep]:
            for ext in (".npz", ".json"):
                p = os.path.join(self.dir, f"ckpt_{s:08d}{ext}")
                if os.path.exists(p):
                    os.unlink(p)

    # -- restore ------------------------------------------------------------
    def list_steps(self) -> list[int]:
        return sorted(int(fn[5:13]) for fn in os.listdir(self.dir)
                      if fn.startswith("ckpt_") and fn.endswith(".json"))

    def latest(self) -> tuple[int, np.ndarray, dict] | None:
        """Newest checkpoint whose npz + json pair is complete."""
        for s in reversed(self.list_steps()):
            npz = os.path.join(self.dir, f"ckpt_{s:08d}.npz")
            js = os.path.join(self.dir, f"ckpt_{s:08d}.json")
            if os.path.exists(npz) and os.path.exists(js):
                with np.load(npz) as d:
                    z = d["z"]
                with open(js) as f:
                    meta = json.load(f)
                return s, z, meta
        return None

    # -- serving snapshots --------------------------------------------------
    def snapshot_path(self, iteration: int, sharded: bool = False) -> str:
        """Where the snapshot of ``iteration`` is written: a dense ``.npz``
        or a ``.sharded`` directory."""
        from repro_torch.serve.snapshot import SHARDED_SUFFIX

        ext = SHARDED_SUFFIX if sharded else ".npz"
        return os.path.join(self.dir, f"snapshot_{int(iteration):08d}{ext}")

    def publish_snapshot(self, state=None, alpha: float | None = None,
                         beta: float | None = None,
                         num_words_total: int | None = None, vocab=None,
                         meta: dict | None = None,
                         shards: int | None = None, *,
                         partition=None, iteration: int | None = None,
                         blocks=None, phi_sum=None, shard_of=None,
                         local_id=None) -> str:
        """The one snapshot-publish entry point; prunes to the newest
        ``keep`` snapshots of either layout.  Three call shapes:

        * ``publish_snapshot(state, alpha, beta, ..., shards=N)`` — a
          replicated-phi state: ``snapshot_<iteration>.npz``, or a
          contiguous-split ``.sharded`` directory when ``shards > 1``;
        * ``publish_snapshot(state, partition=dl, ..., shards=N)`` — the
          ``DistributedLDA`` that trained ``state`` publishes the canonical
          phi or its 2d word blocks (a collective: every rank calls this;
          alpha and beta come from its config; its rank 0 writes);
        * ``publish_snapshot(blocks=..., phi_sum=..., shard_of=...,
          local_id=..., iteration=..., alpha=..., beta=...,
          num_words_total=...)`` — pre-sharded phi blocks (any iterable,
          read one at a time), no dense phi anywhere.
        """
        if partition is not None:
            return partition._publish(self, state, vocab=vocab, meta=meta,
                                      shards=shards)
        if blocks is not None:
            required = dict(iteration=iteration, phi_sum=phi_sum,
                            shard_of=shard_of, local_id=local_id,
                            alpha=alpha, beta=beta,
                            num_words_total=num_words_total)
            missing = [k for k, v in required.items() if v is None]
            if missing:
                raise TypeError(
                    f"publish_snapshot(blocks=...) missing {missing}")
            return self._publish_blocks(
                iteration, blocks, phi_sum, shard_of, local_id, alpha=alpha,
                beta=beta, num_words_total=num_words_total, meta=meta,
                vocab=vocab)
        if state is None or alpha is None or beta is None:
            raise TypeError("publish_snapshot needs (state, alpha, beta), "
                            "a partition=, or blocks=")
        from repro_torch.serve import snapshot as snap_mod

        it = int(_host(state.iteration))
        snap = snap_mod.snapshot_from_state(
            state, alpha=alpha, beta=beta, num_words_total=num_words_total,
            vocab=vocab, meta=dict(meta or {}, iteration=it), device="cpu")
        if shards and shards > 1:
            out = snap_mod.save_sharded_snapshot(
                self.snapshot_path(it, sharded=True), snap, shards)
        else:
            out = snap_mod.save_snapshot(self.snapshot_path(it), snap)
        self._prune_snapshots()
        return out

    def _publish_blocks(self, iteration: int, blocks, phi_sum, shard_of,
                        local_id, *, alpha: float, beta: float,
                        num_words_total: int, meta: dict | None = None,
                        vocab=None) -> str:
        """Write pre-sharded phi blocks (a 2d trainer's word shards) as a
        serving snapshot, no dense phi anywhere."""
        from repro_torch.serve import snapshot as snap_mod

        out = snap_mod.write_sharded_snapshot(
            self.snapshot_path(iteration, sharded=True), blocks, phi_sum,
            shard_of, local_id, alpha=alpha, beta=beta,
            num_words_total=num_words_total,
            meta=dict(meta or {}, iteration=int(iteration)), vocab=vocab)
        self._prune_snapshots()
        return out

    def _snapshot_names(self) -> list[str]:
        from repro_torch.serve.snapshot import SHARDED_SUFFIX

        names = [fn for fn in os.listdir(self.dir)
                 if fn.startswith("snapshot_")
                 and (fn.endswith(".npz") or fn.endswith(SHARDED_SUFFIX))]
        # iteration first, publish time second
        return sorted(names, key=lambda fn: (
            int(fn[9:17]), os.stat(os.path.join(self.dir, fn)).st_mtime_ns))

    def _prune_snapshots(self):
        for fn in self._snapshot_names()[: -self.keep]:
            p = os.path.join(self.dir, fn)
            shutil.rmtree(p) if os.path.isdir(p) else os.unlink(p)

    def latest_snapshot_path(self) -> str | None:
        snaps = self._snapshot_names()
        return os.path.join(self.dir, snaps[-1]) if snaps else None
