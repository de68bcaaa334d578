"""Deterministic fault injection for the serving engine (chaos harness).

A ``FaultPlan`` is a seedable, fully deterministic schedule of injected
faults, wired into the serving stack through ``EngineConfig(fault_plan=)``
(and, for the publish/load paths, ``HotSwapModel(fault_plan=)`` /
``load_sharded_snapshot(fault_plan=)``).  Each injection *site* polls the
plan with its own monotonically increasing event index, so a plan replays
identically run after run — the chaos tests and the ``--chaos`` benchmark
assert engine behaviour under every fault kind without any real hardware
failing.

Fault kinds (== site names; each site keeps an independent counter):

* ``worker_exception`` — the batch executor raises mid-batch: the batch
  must fail fast with a labelled reason and the engine must keep serving.
* ``worker_crash``     — the worker thread dies outright (raises through
  the per-batch guard): supervision must restart it, in-flight requests
  must fail fast with reason ``worker_crash``.
* ``device_oom``       — a simulated RESOURCE_EXHAUSTED on dispatch: the
  engine retries with backoff, then falls back to smaller batch buckets.
* ``slow_batch``       — the executor stalls ``delay_s`` (a hung device /
  interference stand-in): deadlines and cancellation must still work.
* ``publish_failure``  — a snapshot publish raises mid-hot-swap: the
  active model must stay the last good snapshot (rollback).
* ``shard_load_error`` — a sharded shard file read fails (corrupt /
  truncated stand-in): the loader raises a structured error instead of
  serving garbage; ``delay_s`` alone makes it a *slow* load.

Specs trigger on event index: ``FaultSpec(kind, at=2, count=3)`` fires on
the 2nd..4th event of that site (0-based).  ``every=N`` fires periodically
from ``at``.  No randomness is consumed unless ``rate`` is set, in which
case a PRNG seeded from ``(plan seed, kind)`` makes even the probabilistic
schedule replayable.
"""
from __future__ import annotations

import dataclasses
import json
import threading

import numpy as np

KINDS = ("worker_exception", "worker_crash", "device_oom", "slow_batch",
         "publish_failure", "shard_load_error")


class InjectedFault(RuntimeError):
    """An error raised by a FaultPlan site (chaos testing)."""

    def __init__(self, kind: str, index: int):
        self.kind = kind
        self.index = index
        super().__init__(f"injected fault {kind!r} (event #{index})")


class SimulatedOOM(InjectedFault):
    """Stands in for the runtime's RESOURCE_EXHAUSTED on dispatch."""


class WorkerCrash(BaseException):
    """Raised through the per-batch guard to kill the worker thread.

    BaseException on purpose: the engine's batch-level ``except Exception``
    must NOT catch it — only the supervisor does."""

    def __init__(self, index: int):
        self.index = index
        super().__init__(f"injected worker crash (event #{index})")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fires on events [at, at+count) of its site,
    or periodically (``every``) from ``at`` on."""

    kind: str
    at: int = 0
    count: int = 1
    every: int | None = None
    delay_s: float = 0.0
    rate: float | None = None   # probabilistic (still deterministic via seed)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")

    def fires_at(self, index: int, coin: float | None = None) -> bool:
        if self.rate is not None:
            return coin is not None and coin < self.rate
        if index < self.at:
            return False
        if self.every:
            return (index - self.at) % self.every == 0
        return index < self.at + self.count


class FaultPlan:
    """A deterministic schedule of FaultSpecs, polled per site.

    Thread-safe: sites are polled from the engine worker threads and from
    publish/load callers concurrently; each site's event counter is guarded.
    """

    def __init__(self, specs: list[FaultSpec] | tuple[FaultSpec, ...] = (),
                 seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        # one replayable uniform stream per kind, for rate-based specs
        self._coins = {k: np.random.default_rng(
            np.random.SeedSequence([self.seed, i]))
            for i, k in enumerate(KINDS)}

    def check(self, kind: str) -> FaultSpec | None:
        """Advance the site's event counter; return the firing spec (or
        None).  Pure bookkeeping — raising is the caller's (or ``fire``'s)
        job, so sites like ``slow_batch`` can sleep instead."""
        if kind not in KINDS:
            raise ValueError(f"unknown fault site {kind!r}")
        with self._lock:
            index = self._counters.get(kind, 0)
            self._counters[kind] = index + 1
            coin = None
            if any(s.rate is not None for s in self.specs if s.kind == kind):
                coin = float(self._coins[kind].random())
            for spec in self.specs:
                if spec.kind == kind and spec.fires_at(index, coin):
                    self._fired[kind] = self._fired.get(kind, 0) + 1
                    return dataclasses.replace(spec)  # defensive copy
        return None

    def fire(self, kind: str) -> FaultSpec | None:
        """``check`` + raise the site's canonical exception when it fires.

        ``slow_batch`` and pure-delay ``shard_load_error`` specs are
        returned (not raised) so the caller can sleep."""
        spec = self.check(kind)
        if spec is None:
            return None
        index = self._counters.get(kind, 1) - 1
        if kind == "worker_crash":
            raise WorkerCrash(index)
        if kind == "device_oom":
            raise SimulatedOOM(kind, index)
        if kind == "slow_batch" or (kind == "shard_load_error"
                                    and spec.delay_s > 0):
            return spec
        raise InjectedFault(kind, index)

    def fired(self) -> dict[str, int]:
        """Per-site count of faults actually injected (chaos assertions)."""
        with self._lock:
            return dict(self._fired)

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Build a plan from a JSON list or the compact CLI grammar.

        Compact: comma-separated ``kind[@at[xcount]][:delay_s]`` items, e.g.
        ``device_oom@1``, ``worker_exception@0x3``, ``slow_batch@2:0.05``.
        The repeat count rides on the ``@at`` suffix (kind names themselves
        contain ``x``).  JSON: ``[{"kind": "device_oom", "at": 1}, ...]``
        (FaultSpec fields).
        """
        text = text.strip()
        if not text:
            return cls()
        if text.startswith("["):
            return cls([FaultSpec(**obj) for obj in json.loads(text)],
                       seed=seed)
        specs = []
        for item in text.split(","):
            item = item.strip()
            delay = 0.0
            if ":" in item:
                item, d = item.rsplit(":", 1)
                delay = float(d)
            at, count = 0, 1
            if "@" in item:
                item, a = item.rsplit("@", 1)
                if "x" in a:
                    a, c = a.split("x", 1)
                    count = int(c)
                at = int(a)
            specs.append(FaultSpec(kind=item, at=at, count=count,
                                   delay_s=delay))
        return cls(specs, seed=seed)
