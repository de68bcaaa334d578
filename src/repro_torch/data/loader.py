"""Host data pipeline of the LM training path: batches made on the host,
copied to the device ahead of the step that reads them.

The port of ``repro.data.loader``.  A worker thread makes each batch
(numpy), pins it and copies it to the device with ``non_blocking=True`` on
a side stream, into a queue ``depth`` deep; the consumer's stream waits on
that copy's event, so the step that reads a batch never waits for the host
to make it and the copy overlaps the previous step.  On the CPU the batch
is wrapped as tensors, no copy.  ``lm_batches`` is the reference's
synthetic stream, the same numpy arrays for the same seed.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from ..device import resolve_device


class PrefetchLoader:
    """Wraps a host-side batch generator ``make_batch(i) -> {name: numpy
    array}`` with ``depth``-deep prefetch onto ``device`` (``cuda:0`` by
    default).  Iterating yields ``{name: tensor}`` on the device in the
    order of ``i``; ``close()`` stops the worker.  An exception raised in
    the worker is raised again by the next ``next()``."""

    def __init__(self, make_batch: Callable[[int], dict], depth: int = 2,
                 device=None):
        self.device = resolve_device(device)
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _to_device(self, batch: dict, stream):
        if stream is None:
            return {k: torch.from_numpy(np.asarray(v)) for k, v in
                    batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _worker(self):
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        i = 0
        try:
            while not self._stop.is_set():
                self._put(self._to_device(self._make(i), stream))
                i += 1
        except Exception as exc:    # handed to the consumer, raised there
            self._put((exc, None))

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch, done = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in batch.values():    # its memory is the side stream's
                t.record_stream(consumer)
        return batch

    def close(self):
        """Stop the worker and drop the batches it made ahead."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               table_size: int = 4096):
    """Deterministic synthetic LM stream (Zipf-initialised bigram table —
    learnable structure so loss curves mean something)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, vocab, size=(table_size,))

    def make(i: int) -> dict:
        r = np.random.default_rng(seed * 1_000_003 + i)
        toks = [r.integers(0, vocab, size=(batch, 1))]
        for _ in range(seq):
            toks.append(table[toks[-1] % table_size])
        seq_arr = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": seq_arr[:, :-1], "labels": seq_arr[:, 1:]}

    return make
