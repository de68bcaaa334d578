"""Continuous-batching inference engine with an explicit robustness contract.

The serving front end used to be a flush-on-timeout micro-batcher over an
unbounded queue: under overload it queued forever, a timed-out caller's
request still burned a full device batch, and the only answer to a fault
was shutdown.  This engine replaces it with a two-stage pipeline and a
robustness contract sized for real traffic:

**Admission control & backpressure** — the queue is bounded
(``EngineConfig(max_queue)``); when it is full, ``submit()`` applies the
configured admission policy: ``"block"`` (backpressure the submitter,
honoring the request's own deadline), ``"reject"`` (raise a structured
:class:`RejectedError` — HTTP 429 in ``launch/serve_lda``), or
``"shed_oldest"`` (drop the oldest queued request with reason ``shed`` and
admit the newcomer).  Saturation is surfaced through ``ready()`` /
``/healthz`` readiness.

**Per-request deadlines & cancellation** — ``submit(tokens, deadline_ms=)``
attaches a deadline tracked in a min-heap; the scheduler drops expired
requests *before* they occupy a device batch (reason ``expired``), and an
abandoned request (``infer()`` timeout calls ``_Request.cancel()``) is
skipped the same way (reason ``cancelled``) — device batches are never
spent on dead requests.

**SLO-aware continuous batching** — a *scheduler* thread forms batches and
launches the (async) fold-in, a separate *assembler* thread blocks
on device results and fires callbacks; new requests are admitted into the
next bucket while the current batch is in flight (the in-flight queue depth
``max_inflight`` bounds device pipelining).  Batch/length buckets are chosen
from queue depth as before; the flush decision additionally watches the
nearest deadline against a per-bucket execution-time EWMA and flushes early
when waiting longer would blow it (the p99-vs-throughput knob, driven by
the queue-wait/latency histograms).

**Fault injection & graceful degradation** — ``EngineConfig(fault_plan=)``
wires a deterministic :class:`repro_torch.serve.faults.FaultPlan` through the hot
path: injected worker exceptions fail their batch fast and serving
continues; a simulated device OOM is retried with backoff and then *falls
back to smaller batch buckets* (splitting the batch); a worker crash is
caught by thread supervision, in-flight requests fail fast with reason
``worker_crash``, and the worker restarts up to
``EngineConfig(max_worker_restarts)`` before being declared dead
(``stats()['worker_alive']`` — ``/healthz`` turns 503).

On the non-faulted path: shape bucketing bounds the set of launched
shapes, one packed H2D transfer per batch, hot-swap via ``HotSwapModel``
between batches, reason-labelled error counters, p50/p99 latency +
sliding-window rates; each executed batch draws one seed from the same
``seed``-anchored generator.

This is the port of ``repro.serve.engine`` (dense snapshots).  On the card:
the scheduler thread copies the packed batch once from pinned host memory
and *launches* the fold-in on the current stream without synchronising
(nothing there reads a device result); the assembler's ``.cpu()`` is the
blocking device->host copy.  Both threads use the same (default) stream,
so the copy is ordered after the batch's kernels.
"""
from __future__ import annotations

import dataclasses
import heapq
import queue
import threading
import time
import traceback
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.analysis.runtime import (assert_lock_held,
                                          enable_lock_sanitizer)
from repro_torch.obs import LATENCY_BUCKETS_MS, SIZE_BUCKETS, Observability
from repro_torch.serve.faults import FaultPlan, SimulatedOOM
from repro_torch.serve.infer import (InferConfig, fold_in_cost,
                                     fold_in_request, pack_request_buffer)
from repro_torch.serve.snapshot import HotSwapModel

_SENTINEL = object()

ADMISSION_POLICIES = ("block", "reject", "shed_oldest")


class RejectedError(RuntimeError):
    """Structured admission-control rejection (maps to HTTP 429).

    ``reason`` is one of ``queue_full`` (policy ``reject`` with a full
    queue), ``deadline`` (policy ``block`` could not admit before the
    request's own deadline) or ``worker_dead`` (the scheduler exhausted its
    restart budget — the engine cannot serve)."""

    def __init__(self, reason: str, queue_depth: int, max_queue: int):
        self.reason = reason
        self.queue_depth = int(queue_depth)
        self.max_queue = int(max_queue)
        super().__init__(
            f"request rejected ({reason}): queue {queue_depth}/{max_queue}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 32
    max_delay_ms: float = 3.0
    length_buckets: tuple[int, ...] = (32, 64, 128, 256)
    infer: InferConfig = InferConfig()
    rate_window_s: float = 10.0   # docs_per_sec_window sliding window
    # -- admission control / backpressure --
    max_queue: int = 256          # bounded queue (0 = unbounded, legacy mode)
    admission: str = "block"      # "block" | "reject" | "shed_oldest"
    default_deadline_ms: float | None = None   # per-request deadline default
    # -- SLO-aware flush: spare slack before the nearest deadline at which
    # the scheduler stops waiting for a fuller batch and flushes now.
    # Must exceed the scheduler's cond.wait wake-up jitter (several ms on
    # a loaded host) — a tighter margin lets the wake overshoot the
    # deadline itself and the reaper expire a request the flush was
    # scheduled to save --
    slo_margin_ms: float = 5.0
    # -- continuous batching: batches in flight on device while the next
    # one is being formed (the scheduler blocks past this depth) --
    max_inflight: int = 2
    # -- graceful degradation --
    oom_retries: int = 1          # same-bucket retries before shrinking
    oom_backoff_ms: float = 5.0
    max_worker_restarts: int = 3  # crashes tolerated before declared dead
    fault_plan: FaultPlan | None = None   # chaos injection (tests/bench)
    # Debug mode: lock-held assertions in the guarded sections.
    sanitize: bool = False

    def __post_init__(self):
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of {ADMISSION_POLICIES},"
                             f" got {self.admission!r}")
        if self.max_queue < 0 or self.max_inflight < 1:
            raise ValueError("max_queue must be >= 0, max_inflight >= 1")

    def batch_buckets(self) -> tuple[int, ...]:
        b, out = 1, []
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return tuple(out)


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def _is_oom(e: BaseException) -> bool:
    """Simulated or real device OOM."""
    if isinstance(e, (SimulatedOOM, torch.cuda.OutOfMemoryError)):
        return True
    return "out of memory" in str(e).lower()


class _Request:
    __slots__ = ("tokens", "truncated", "event", "result", "t_submit",
                 "t_deadline", "cancelled", "queued", "on_cancel", "_slock")

    def __init__(self, tokens: np.ndarray, truncated: bool = False,
                 deadline_ms: float | None = None):
        self.tokens = tokens
        self.truncated = truncated
        self.event = threading.Event()
        self.result: dict[str, Any] | None = None
        self.t_submit = time.perf_counter()
        self.t_deadline = (self.t_submit + float(deadline_ms) / 1e3
                           if deadline_ms is not None else None)
        self.cancelled = False
        self.queued = False          # scheduler-owned: still in the pending deque
        self.on_cancel = None        # engine hook: count reason="cancelled"
        self._slock = threading.Lock()

    def _settle(self, result: dict[str, Any]) -> bool:
        """First writer wins: the request's result is set exactly once, so a
        cancel racing a batch completion can never tear the event."""
        with self._slock:
            if self.result is not None:
                return False
            self.result = result
            self.event.set()
            return True

    def cancel(self) -> bool:
        """Abandon the request.  If it has not been served yet it never will
        be — the scheduler skips settled requests at batch formation, so no
        device batch is spent on it.  Returns True if the cancel won."""
        if self._settle(dict(error="request cancelled", reason="cancelled")):
            self.cancelled = True
            cb = self.on_cancel
            if cb is not None:
                cb()
            return True
        return False


class _InFlight:
    """One dispatched batch riding the scheduler -> assembler queue."""

    __slots__ = ("batch", "res", "buf", "version", "B", "L", "t_dispatch")

    def __init__(self, batch, res, buf, version, B, L, t_dispatch):
        self.batch = batch
        self.res = res
        self.buf = buf           # pinned host batch: alive until assembled
        self.version = version
        self.B = B
        self.L = L
        self.t_dispatch = t_dispatch


class LDAServeEngine:
    """Continuous-batching threaded front end over ``fold_in``."""

    def __init__(self, model: HotSwapModel, cfg: EngineConfig | None = None,
                 seed: int = 0, obs: Observability | None = None):
        self.model = model
        self.cfg = cfg or EngineConfig()
        self.obs = obs if obs is not None else Observability.default()
        self._cond = threading.Condition()
        self._pending: "list[_Request]" = []   # FIFO admission queue
        self._heap: list = []                  # (t_deadline, seq, req) min-heap
        self._seq = 0
        self._closed = False
        self._exec_ms: dict[tuple[int, int], float] = {}  # (B, L) -> EWMA
        self._shapes: set[tuple[int, int]] = set()        # (B, L) launched
        self._dispatching: list[_Request] | None = None   # crash fail-fast
        self._assembling: _InFlight | None = None
        self._inflight: queue.Queue = queue.Queue(maxsize=self.cfg.max_inflight)
        if self.cfg.sanitize:
            enable_lock_sanitizer()
        reg = self.obs.registry
        self._m_requests = reg.counter(
            "repro_serve_requests_total", "documents served")
        self._m_errors = reg.counter(
            "repro_serve_errors_total",
            "failed requests by reason (shutdown|oov_hotswap|exception|"
            "expired|cancelled|shed|oom|worker_crash)",
            labelnames=("reason",))
        self._m_rejected = reg.counter(
            "repro_serve_rejected_total",
            "submit()-side admission rejections by reason "
            "(queue_full|deadline|worker_dead)",
            labelnames=("reason",))
        self._m_truncated = reg.counter(
            "repro_serve_truncated_total",
            "requests cut to the largest length bucket")
        self._m_batches = reg.counter(
            "repro_serve_batches_total", "batches executed")
        self._m_h2d = reg.counter(
            "repro_serve_h2d_transfers_total",
            "host->device transfers (one packed buffer per batch)")
        self._m_oom = reg.counter(
            "repro_serve_oom_total", "device OOMs seen at dispatch")
        self._m_oom_fallbacks = reg.counter(
            "repro_serve_oom_fallbacks_total",
            "batches split to a smaller bucket after OOM")
        self._m_restarts = reg.counter(
            "repro_serve_worker_restarts_total",
            "worker threads restarted by supervision after a crash")
        self._m_deadline_flushes = reg.counter(
            "repro_serve_deadline_flushes_total",
            "batches flushed early to protect the nearest deadline")
        self._m_latency = reg.histogram(
            "repro_serve_request_latency_ms",
            "end-to-end request latency, submit -> result ready",
            buckets=LATENCY_BUCKETS_MS)
        self._m_queue_wait = reg.histogram(
            "repro_serve_queue_wait_ms",
            "submit -> batch collection wait", buckets=LATENCY_BUCKETS_MS)
        self._m_admission_wait = reg.histogram(
            "repro_serve_admission_wait_ms",
            "time submit() spent blocked on admission (block policy)",
            buckets=LATENCY_BUCKETS_MS)
        self._m_batch_size = reg.histogram(
            "repro_serve_batch_size", "documents per executed batch",
            buckets=SIZE_BUCKETS)
        self._m_exec = reg.histogram(
            "repro_serve_batch_exec_ms",
            "dispatch -> results materialized, per (B, L) bucket",
            buckets=LATENCY_BUCKETS_MS, labelnames=("bucket",))
        reg.gauge("repro_serve_queue_depth", "requests waiting for a batch",
                  fn=lambda: len(self._pending))
        reg.gauge("repro_serve_inflight_batches",
                  "dispatched batches not yet assembled",
                  fn=self._inflight.qsize)
        reg.gauge("repro_serve_ready",
                  "1 when the engine is admitting and workers are alive",
                  fn=lambda: 1.0 if self.ready()["ready"] else 0.0)
        reg.gauge("repro_serve_jit_cache_size",
                  "distinct (B, L) fold-in shapes launched (bucketing "
                  "invariant)", fn=self.jit_cache_size)
        self._rate = self.obs.window_rate(self.cfg.rate_window_s)
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._rng = np.random.default_rng(seed)
        self._sched = threading.Thread(
            target=self._supervised, args=("scheduler", self._schedule_loop),
            daemon=True)
        self._asm = threading.Thread(
            target=self._supervised, args=("assembler", self._assemble_loop),
            daemon=True)
        self._sched.start()
        self._asm.start()

    # -- client API ---------------------------------------------------------
    def submit(self, tokens, deadline_ms: float | None = None) -> _Request:
        """Admit one document (1-D array of word ids) under the configured
        admission policy.

        Raises ValueError on out-of-vocabulary ids — on the card the phi
        gather would hit a device-side assert that kills the context —
        RuntimeError once the engine has been stopped, and
        :class:`RejectedError` when admission control turns the request away
        (full queue under ``reject``, deadline blown while blocked, or a
        dead worker).  ``deadline_ms`` is relative to now; ``None`` takes
        ``cfg.default_deadline_ms``.
        """
        cfg = self.cfg
        L_max = cfg.length_buckets[-1]
        full = np.asarray(tokens, np.int32).reshape(-1)
        toks = full[:L_max]
        v = self.model.acquire()[1].num_words
        if toks.size and (toks.min() < 0 or toks.max() >= v):
            raise ValueError(f"word ids must be in [0, {v})")
        if deadline_ms is None:
            deadline_ms = cfg.default_deadline_ms
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        req = _Request(toks, truncated=full.size > L_max,
                       deadline_ms=deadline_ms)
        req.on_cancel = self._count_cancelled
        if req.truncated:
            self._m_truncated.inc()
        t_wait0 = time.perf_counter()
        with self._cond:
            assert_lock_held(self._cond)
            if self._closed:
                raise RuntimeError("engine stopped")
            if not self._sched.is_alive():
                depth = len(self._pending)
                self._m_rejected.labels(reason="worker_dead").inc()
                raise RejectedError("worker_dead", depth, cfg.max_queue)
            while cfg.max_queue > 0 and len(self._pending) >= cfg.max_queue:
                depth = len(self._pending)
                if cfg.admission == "reject":
                    self._m_rejected.labels(reason="queue_full").inc()
                    raise RejectedError("queue_full", depth, cfg.max_queue)
                if cfg.admission == "shed_oldest":
                    victim = self._pending.pop(0)
                    victim.queued = False
                    self._fail([victim],
                               "request shed under overload (shed_oldest)",
                               reason="shed")
                    continue
                # "block": backpressure — wait for space, up to the deadline
                timeout = None
                if req.t_deadline is not None:
                    timeout = req.t_deadline - time.perf_counter()
                    if timeout <= 0:
                        self._m_rejected.labels(reason="deadline").inc()
                        raise RejectedError("deadline", depth, cfg.max_queue)
                self._cond.wait(timeout=timeout)
                if self._closed:
                    raise RuntimeError("engine stopped")
            if self._t_first is None:
                # docs/sec span opens at first *submit*, not first batch
                # completion: a single served batch must report real work
                self._t_first = req.t_submit
            self._pending.append(req)
            req.queued = True
            if req.t_deadline is not None:
                self._seq += 1
                heapq.heappush(self._heap, (req.t_deadline, self._seq, req))
            self._cond.notify_all()
        self._m_admission_wait.observe((time.perf_counter() - t_wait0) * 1e3)
        return req

    def infer(self, tokens, timeout: float | None = 30.0,
              deadline_ms: float | None = None) -> dict[str, Any]:
        """Blocking single-document inference.  On timeout the request is
        *cancelled* so the scheduler never spends a device batch on it."""
        req = self.submit(tokens, deadline_ms=deadline_ms)
        if not req.event.wait(timeout):
            req.cancel()
            raise TimeoutError("inference request timed out")
        assert req.result is not None
        if "error" in req.result:
            raise RuntimeError(req.result["error"])
        return req.result

    def infer_many(self, docs: Sequence, timeout: float | None = 60.0,
                   deadline_ms: float | None = None):
        reqs = [self.submit(d, deadline_ms=deadline_ms) for d in docs]
        for r in reqs:
            if not r.event.wait(timeout):
                r.cancel()
                raise TimeoutError("inference request timed out")
            if "error" in r.result:
                raise RuntimeError(r.result["error"])
        return [r.result for r in reqs]

    def stop(self):
        """Shut down: no new submits, every still-pending request fails fast
        (its event fires with an error), and worker liveness is *checked* —
        a worker that out-lives the join timeout is reported, not ignored."""
        with self._cond:
            assert_lock_held(self._cond)
            self._closed = True
            self._cond.notify_all()
        self._sched.join(timeout=30)
        if self._sched.is_alive():
            # scheduler hung mid-batch: feed the assembler its shutdown
            # sentinel ourselves so it can still exit once its queue drains
            try:
                self._inflight.put_nowait(_SENTINEL)
            except queue.Full:
                pass
        self._asm.join(timeout=30)
        self._drain_pending("engine stopped")
        if self._sched.is_alive() or self._asm.is_alive():
            print("[engine] WARNING: worker thread still alive after stop() "
                  "join timeout — stats()['worker_alive'] stays True; the "
                  "thread is a daemon and cannot block interpreter exit")

    def _count_cancelled(self):
        self._m_errors.labels(reason="cancelled").inc()

    def _drain_pending(self, msg: str, reason: str = "shutdown"):
        with self._cond:
            assert_lock_held(self._cond)
            pending = [r for r in self._pending if not r.event.is_set()]
            self._pending.clear()
            for r in pending:
                r.queued = False
        if pending:
            self._fail(pending, msg, reason=reason)

    # -- health -------------------------------------------------------------
    def workers_alive(self) -> bool:
        """Both pipeline threads (scheduler + assembler) are running.  False
        after a clean stop, after a crash that exhausted the restart budget,
        or if a thread died in a way supervision could not absorb."""
        return self._sched.is_alive() and self._asm.is_alive()

    def ready(self) -> dict[str, Any]:
        """Readiness contract for ``/healthz``: admitting AND able to serve.
        Saturation (full queue) flips readiness so load balancers can back
        off before submits start failing."""
        with self._cond:
            assert_lock_held(self._cond)
            closed = self._closed
            depth = len(self._pending)
        alive = self.workers_alive()
        saturated = self.cfg.max_queue > 0 and depth >= self.cfg.max_queue
        reasons = []
        if closed:
            reasons.append("stopped")
        if not alive:
            reasons.append("worker_dead")
        if saturated:
            reasons.append("saturated")
        return dict(ready=not reasons, worker_alive=alive,
                    saturated=saturated, queue_depth=depth, reasons=reasons)

    # -- metrics ------------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        """Counters over the engine lifetime; percentiles over the last
        <=4096 requests (the bounded recording window).

        ``docs_per_sec`` is the lifetime rate (first submit -> last done);
        ``docs_per_sec_window`` slides over ``cfg.rate_window_s`` so idle
        gaps between traffic bursts don't drag it toward zero.
        """
        with self._cond:
            assert_lock_held(self._cond)
            span = ((self._t_last or 0.0) - (self._t_first or 0.0))
            depth = len(self._pending)
        health = self.ready()
        n = self._m_requests.value
        return dict(
            requests=n,
            errors=self._m_errors.value,
            errors_by_reason=self._m_errors.per_label(),
            rejected=self._m_rejected.value,
            rejected_by_reason=self._m_rejected.per_label(),
            truncated=self._m_truncated.value,
            batches=self._m_batches.value,
            mean_batch=self._m_batch_size.mean,
            h2d_transfers=self._m_h2d.value,
            comm_bytes_moved=0.0,         # dense phi only: nothing moves
            oom_events=self._m_oom.value,
            oom_fallbacks=self._m_oom_fallbacks.value,
            worker_restarts=self._m_restarts.value,
            deadline_flushes=self._m_deadline_flushes.value,
            worker_alive=health["worker_alive"],
            saturated=health["saturated"],
            ready=health["ready"],
            p50_ms=self._m_latency.percentile(50),
            p99_ms=self._m_latency.percentile(99),
            queue_wait_p50_ms=self._m_queue_wait.percentile(50),
            docs_per_sec=(n / span) if span > 0 else 0.0,
            docs_per_sec_window=self._rate.rate(),
            queue_depth=float(depth),
            inflight_batches=float(self._inflight.qsize()),
            jit_cache_size=float(self.jit_cache_size()),
        )

    def jit_cache_size(self) -> int:
        """The number of distinct (B, L) shapes launched (bucketing check).

        The key keeps its JAX-era name for ``/stats`` consumers; PyTorch
        compiles nothing per shape, but the count still shows that batches
        stay inside the bucket matrix."""
        with self._cond:
            return len(self._shapes)

    # -- scheduler ----------------------------------------------------------
    def _reap_locked(self, now: float):
        """Drop dead requests from the pending queue *before* they cost
        device time: settled ones (cancelled / already failed) silently,
        expired deadlines with reason ``expired``."""
        expired = []
        keep = []
        for r in self._pending:
            if r.event.is_set():
                r.queued = False          # cancelled or failed elsewhere
            elif r.t_deadline is not None and now > r.t_deadline:
                r.queued = False
                expired.append(r)
            else:
                keep.append(r)
        if len(keep) != len(self._pending):
            self._pending.clear()
            self._pending.extend(keep)
        if expired:
            self._fail(expired, "deadline expired before service",
                       reason="expired")

    def _nearest_deadline_locked(self) -> float | None:
        """Min pending deadline via the lazy-deletion heap: entries whose
        request left the queue (served, shed, cancelled, expired) pop off."""
        while self._heap:
            t, _, r = self._heap[0]
            if r.queued and not r.event.is_set():
                return t
            heapq.heappop(self._heap)
        return None

    def _estimate_exec_s_locked(self) -> float:
        """Expected execution time of the bucket the current pending set
        would form, from the per-bucket EWMA (0 until first measurement —
        the scheduler can't flush early on data it doesn't have)."""
        if not self._pending or not self._exec_ms:
            return 0.0
        B = _bucket(len(self._pending), self.cfg.batch_buckets())
        L = _bucket(max(len(r.tokens) for r in self._pending),
                    self.cfg.length_buckets)
        ms = self._exec_ms.get((B, L))
        if ms is None:
            # transfer a timed bucket's EWMA via the static cost-ratio model
            (kB, kL), kms = max(self._exec_ms.items(),
                                key=lambda kv: kv[1])
            ms = kms * (fold_in_cost(B, L, self.cfg.infer)
                        / fold_in_cost(kB, kL, self.cfg.infer))
        return ms / 1e3

    def _next_batch(self) -> list[_Request] | None:
        """Form one batch: flush on size, batch timeout, shutdown, or — the
        SLO rule — when waiting any longer would blow the nearest deadline
        given the bucket's expected execution time."""
        cfg = self.cfg
        with self._cond:
            assert_lock_held(self._cond)
            while True:
                now = time.perf_counter()
                self._reap_locked(now)
                if self._closed:
                    return None   # pending failed fast by stop()'s drain
                if not self._pending:
                    self._cond.wait()
                    continue
                oldest = self._pending[0]
                flush_at = oldest.t_submit + cfg.max_delay_ms / 1e3
                nd = self._nearest_deadline_locked()
                est_s = self._estimate_exec_s_locked()
                margin_s = cfg.slo_margin_ms / 1e3
                full = len(self._pending) >= cfg.max_batch
                slo_flush = (nd is not None and now + est_s + margin_s >= nd)
                if full or now >= flush_at or slo_flush:
                    if slo_flush and not (full or now >= flush_at):
                        self._m_deadline_flushes.inc()
                    batch = self._pending[:cfg.max_batch]
                    del self._pending[:cfg.max_batch]
                    for r in batch:
                        r.queued = False
                    self._cond.notify_all()   # space freed: wake submitters
                    return batch
                timeout = flush_at - now
                if nd is not None:
                    timeout = min(timeout,
                                  max(nd - est_s - margin_s - now, 0.0))
                self._cond.wait(timeout=max(timeout, 1e-4))

    def _schedule_loop(self):
        tracer = self.obs.tracer
        tracer.name_thread("engine-scheduler")
        while True:
            t0 = time.perf_counter()
            batch = self._next_batch()
            if batch is None:
                self._inflight.put(_SENTINEL)
                return
            tracer.complete("collect", t0, time.perf_counter(),
                            n=len(batch))
            with self._cond:
                self._dispatching = batch
            # A failed batch must never kill the worker: pending requests
            # would hang and the queue would silently stop draining.
            # (An injected WorkerCrash is a BaseException on purpose — it
            # passes through to the supervisor, which fails the batch fast
            # and restarts this thread.  NOT a finally: on a crash,
            # _dispatching must stay set so _fail_crashed can see the batch.)
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — report to callers, keep serving
                traceback.print_exc()
                self._fail([r for r in batch if not r.event.is_set()],
                           f"{type(e).__name__}: {e}", reason="exception")
            with self._cond:
                self._dispatching = None

    def _to_device(self, packed: np.ndarray, snap):
        """The batch's single H2D transfer: one asynchronous copy from pinned
        host memory on the card.  Returns (device buffer, host buffer); the
        caller keeps the host buffer referenced until the batch is
        assembled, so the copy never reads freed memory."""
        self._m_h2d.inc()
        host = torch.from_numpy(packed)
        if snap.device.type != "cuda":
            return host, host
        host = host.pin_memory()
        return host.to(snap.device, non_blocking=True), host

    def _dispatch(self, batch: list[_Request]):
        """Validate against the live snapshot, then execute (scheduler
        thread; the device work is dispatched async — the assembler blocks
        on the results)."""
        cfg = self.cfg
        t_collected = time.perf_counter()
        for r in batch:
            self._m_queue_wait.observe((t_collected - r.t_submit) * 1e3)
        version, snap = self.model.acquire()
        # Re-validate against the snapshot this batch will actually be
        # served with: a hot-swap between submit() and here may have shrunk
        # the vocabulary, and an OOV id in the device gather is fatal.
        ok, bad = [], []
        for r in batch:
            if r.tokens.size and int(r.tokens.max()) >= snap.num_words:
                bad.append(r)
            else:
                ok.append(r)
        if bad:
            self._fail(bad, f"word ids must be in [0, {snap.num_words}) "
                            "(vocabulary changed by hot-swap)",
                       reason="oov_hotswap")
        if not ok:
            return
        fp = cfg.fault_plan
        if fp is not None:
            fp.fire("worker_crash")        # raises WorkerCrash when scheduled
            spec = fp.fire("slow_batch")   # returns the spec; we do the sleep
            if spec is not None:
                time.sleep(spec.delay_s)
            fp.fire("worker_exception")    # raises InjectedFault -> batch guard
        self._execute(ok, snap, version)

    def _execute(self, batch: list[_Request], snap, version):
        """Pack + one H2D + dispatch for one bucketized batch, with the OOM
        degradation ladder: retry with backoff at the same bucket, then
        split to smaller batch buckets, and only then fail (reason ``oom``).
        """
        cfg = self.cfg
        tracer = self.obs.tracer
        B = _bucket(len(batch), cfg.batch_buckets())
        L = _bucket(max(len(r.tokens) for r in batch), cfg.length_buckets)
        seed = int(self._rng.integers(2**31))
        with tracer.span("pack", B=B, L=L, n=len(batch)):
            packed = pack_request_buffer([r.tokens for r in batch], B, L, seed)

        with tracer.span("h2d", bytes=packed.nbytes):
            buf, host = self._to_device(packed, snap)   # ONE H2D per batch
        fp = cfg.fault_plan
        attempts = 0
        while True:
            try:
                if fp is not None:
                    fp.fire("device_oom")          # raises SimulatedOOM
                with tracer.span("sweep", B=B, L=L, impl=cfg.infer.impl):
                    # launches only; the seed comes from the host copy
                    res = fold_in_request(snap, buf, cfg.infer, seed=seed)
                break
            except Exception as e:  # noqa: BLE001 — OOM ladder, else re-raise
                if not _is_oom(e):
                    raise
                self._m_oom.inc()
                if attempts < cfg.oom_retries:
                    attempts += 1
                    time.sleep(cfg.oom_backoff_ms / 1e3 * attempts)
                    continue
                if len(batch) > 1:
                    # graceful degradation: shrink the bucket — each half
                    # lands on a smaller batch bucket of the same matrix
                    self._m_oom_fallbacks.inc()
                    mid = (len(batch) + 1) // 2
                    self._execute(batch[:mid], snap, version)
                    self._execute(batch[mid:], snap, version)
                    return
                self._fail([r for r in batch if not r.event.is_set()],
                           f"device out of memory: {e}", reason="oom")
                return
        with self._cond:
            self._shapes.add((B, L))
        self._inflight.put(
            _InFlight(batch, res, host, version, B, L, time.perf_counter()))

    # -- assembler ----------------------------------------------------------
    def _assemble_loop(self):
        tracer = self.obs.tracer
        tracer.name_thread("engine-assembler")
        while True:
            item = self._inflight.get()
            if item is _SENTINEL:
                return
            with self._cond:
                self._assembling = item
            try:
                with tracer.span("assemble"):
                    # the blocking D2H: waits for the batch's kernels on
                    # the stream the scheduler launched them on
                    theta = item.res.theta.cpu().numpy()
                    tt = item.res.top_topics.cpu().numpy()
                    tw = item.res.top_weights.cpu().numpy()
            except Exception as e:  # noqa: BLE001 — device failure at materialization
                traceback.print_exc()
                reason = "oom" if _is_oom(e) else "exception"
                self._fail([r for r in item.batch if not r.event.is_set()],
                           f"{type(e).__name__}: {e}", reason=reason)
                with self._cond:
                    self._assembling = None
                continue
            now = time.perf_counter()
            exec_ms = (now - item.t_dispatch) * 1e3
            with tracer.span("callback", n=len(item.batch)):
                with self._cond:
                    assert_lock_held(self._cond)
                    self._t_last = now
                    self._assembling = None
                    key = (item.B, item.L)
                    prev = self._exec_ms.get(key)
                    self._exec_ms[key] = (exec_ms if prev is None
                                          else 0.5 * prev + 0.5 * exec_ms)
                self._m_batch_size.observe(len(item.batch))
                self._m_batches.inc()
                self._m_exec.labels(bucket=f"{item.B}x{item.L}").observe(
                    exec_ms)
                served = 0
                for i, r in enumerate(item.batch):
                    result = dict(
                        theta=theta[i], top_topics=tt[i], top_weights=tw[i],
                        model_version=item.version,
                        truncated=r.truncated,
                        latency_ms=(now - r.t_submit) * 1e3,
                    )
                    # a request cancelled after dispatch was already settled
                    # by its caller — discard, don't double-fire
                    if r._settle(result):
                        served += 1
                        self._m_latency.observe(result["latency_ms"])
                        self._m_requests.inc()
                self._rate.record(served, t=now)

    # -- supervision --------------------------------------------------------
    def _fail(self, reqs: list[_Request], msg: str,
              reason: str = "exception"):
        n = 0
        for r in reqs:
            if r._settle(dict(error=msg, reason=reason)):
                n += 1
        if n:
            self._m_errors.labels(reason=reason).inc(n)

    def _fail_crashed(self, name: str):
        """Fail fast whatever the crashed worker was holding, so no caller
        waits out a timeout on a thread that no longer exists."""
        with self._cond:
            assert_lock_held(self._cond)
            batch = self._dispatching
            self._dispatching = None
            item = self._assembling
            self._assembling = None
        held = list(batch or [])
        if item is not None and item is not _SENTINEL:
            held.extend(item.batch)
        if held:
            self._fail([r for r in held if not r.event.is_set()],
                       f"{name} worker crashed mid-batch",
                       reason="worker_crash")

    def _supervised(self, name: str, fn):
        """Worker supervision: a crash (anything escaping the per-batch
        guard, incl. an injected WorkerCrash) fails the held work fast and
        restarts the loop, up to ``cfg.max_worker_restarts`` — after which
        the worker is declared dead, pending requests are drained with
        reason ``worker_crash``, and ``ready()`` flips false."""
        restarts = 0
        while True:
            try:
                fn()
                return
            except BaseException:  # noqa: BLE001 — supervision boundary
                traceback.print_exc()
                self._fail_crashed(name)
                with self._cond:
                    assert_lock_held(self._cond)
                    closed = self._closed
                if closed:
                    return
                restarts += 1
                if restarts > self.cfg.max_worker_restarts:
                    print(f"[engine] {name} exceeded restart budget "
                          f"({self.cfg.max_worker_restarts}); declaring dead")
                    self._drain_pending(f"{name} worker dead",
                                        reason="worker_crash")
                    if name == "scheduler":
                        try:
                            self._inflight.put_nowait(_SENTINEL)
                        except queue.Full:
                            pass
                    return
                self._m_restarts.inc()
                time.sleep(min(0.005 * restarts, 0.1))
