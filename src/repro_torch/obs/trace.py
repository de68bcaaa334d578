"""Phase-span tracing: Chrome trace-event JSON, Perfetto-loadable.

``SpanTracer.span("sweep", B=8)`` times a host-side phase and records one
complete (``ph="X"``) trace event; ``export()`` writes the standard
``{"traceEvents": [...]}`` JSON that chrome://tracing and ui.perfetto.dev
open directly.  Events live in a bounded ring (``max_events``) and every
event carries the real tid so multi-threaded phases (the engine worker vs
submitters) land on separate tracks; the pid is the exporting process's,
read once at export: ``os.getpid`` is a system call, and took 2.7-7.4 us
a call on an H100 machine's host under a profile, too much for a span a
phase.

Timestamps are microseconds since the Unix epoch (``time.time_ns``), the
clock ``torch.profiler`` stamps its events on (its results'
``trace_start_ns()`` plus an event's ``time_range.start``), so an exported
trace merges with a profiler trace, and the ranks of one host line up.
Durations are read on the monotonic clock.

With ``annotate=True`` each span additionally opens a profiler range of the
same name, so when a device profile is captured (``torch.profiler.profile``)
the host spans line up with the CUDA kernel rows under identical names, and
the profiler's correlation ids tie each kernel to the range it was launched
in — pure metadata, so instrumented draws stay bit-identical.  The range is
``torch._C._profiler._RecordFunctionFast``: a ``RecordFunction``, as
``torch.profiler.record_function`` opens one, without the Python op call
around it (and at function scope, so the profiler lists it as no user
annotation): 1.9 us a range against 15.5 us under a CPU profile on an Intel
Xeon host, which matters in an LDA step whose host launches only just keep
ahead of the card.

A disabled tracer's ``span`` returns a shared ``nullcontext`` — the hot path
pays one attribute check and nothing else (``NULL_TRACER``).
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

_NULL_CM = contextlib.nullcontext()


class SpanTracer:
    def __init__(self, enabled: bool = True, annotate: bool = False,
                 max_events: int = 65536, process_name: str = "repro_torch"):
        self.enabled = enabled
        self.process_name = process_name
        self._record_function = None
        if annotate:
            from torch._C._profiler import _RecordFunctionFast
            self._record_function = _RecordFunctionFast
        self._t0 = time.perf_counter()
        self._epoch_us = time.time_ns() / 1e3     # the wall clock at _t0
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._thread_names: dict[int, str] = {}

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing one phase; free when disabled."""
        if not self.enabled:
            return _NULL_CM
        return _Span(self, name, args)

    def complete(self, name: str, t_start_s: float, t_end_s: float, **args):
        """Record an already-timed phase from perf_counter() endpoints."""
        if not self.enabled:
            return
        ts = self._epoch_us + (t_start_s - self._t0) * 1e6
        self._record(name, ts, max((t_end_s - t_start_s) * 1e6, 0.0), args)

    def name_thread(self, name: str) -> None:
        """Label the calling thread's track in the exported trace."""
        with self._lock:
            self._thread_names[threading.get_ident()] = name

    def _record(self, name: str, ts: float, dur: float, args: dict) -> None:
        ev = dict(name=name, ph="X", ts=ts, dur=dur,
                  tid=threading.get_ident(), cat="phase")
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- export -------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (sorted ``ts``, metadata rows)."""
        with self._lock:
            events = sorted(self._events, key=lambda e: e["ts"])
            tnames = dict(self._thread_names)
        pid = os.getpid()
        meta = [dict(name="process_name", ph="M", pid=pid, tid=0,
                     args={"name": self.process_name})]
        meta += [dict(name="thread_name", ph="M", pid=pid, tid=tid,
                      args={"name": nm}) for tid, nm in sorted(tnames.items())]
        return {"traceEvents": meta + [dict(e, pid=pid) for e in events],
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_wall_ns", "_ann")

    def __init__(self, tracer: SpanTracer, name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._ann = None

    def __enter__(self):
        if self._tracer._record_function is not None:
            self._ann = self._tracer._record_function(self._name)
            self._ann.__enter__()
        self._wall_ns = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def set(self, **args) -> None:
        """Attach args discovered mid-span (e.g. collected batch size)."""
        self._args.update(args)

    def __exit__(self, *exc):
        dur_us = (time.perf_counter() - self._t0) * 1e6
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self._name, self._wall_ns / 1e3, dur_us,
                             self._args)
        return False


NULL_TRACER = SpanTracer(enabled=False)
