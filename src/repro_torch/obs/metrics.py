"""Metrics registry: counters, gauges, fixed-bucket histograms.

Design constraints (this is the hot-path substrate every perf PR is judged
against, so it must not perturb what it measures):

  * lock-cheap — each metric owns one uncontended ``threading.Lock`` taken
    only around a couple of float ops (~100 ns per ``inc``/``observe``; the
    observer-effect benchmark in ``benchmarks/serving.py`` pins the total
    under 2% of the serving hot path);
  * bounded memory — histograms hold a fixed bucket vector plus a bounded
    sample window (for exact p50/p99; the fixed buckets feed the Prometheus
    exposition), ``WindowRate`` holds a bounded timestamp deque.  Nothing
    grows with lifetime traffic;
  * no model-side effects — every metric is host-side Python; nothing here
    touches generators, tensors or kernel launches, so instrumented and
    uninstrumented paths draw bit-identically by construction.

``NOOP_REGISTRY`` serves the same API with every method a no-op, so call
sites stay unconditional and the observer effect can be *measured* (real
vs no-op registry) rather than asserted.

Exposition is Prometheus text format 0.0.4 via ``render_prometheus()``:
``# HELP``/``# TYPE`` headers, ``{label="value"}`` children, cumulative
``_bucket{le=...}`` + ``_sum`` + ``_count`` rows per histogram.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, Sequence

import numpy as np

# default latency buckets (milliseconds), roughly log-spaced 0.1ms..30s
LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0, 30000.0)
# batch sizes / small counts
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render without '.0'."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter; optionally a labelled family (``labels(...)``)."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name, self.help = name, help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._value = 0.0
        self._children: dict[tuple, Counter] = {}

    def inc(self, n: float = 1.0) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled; use .labels(...)")
        with self._lock:
            self._value += n

    def labels(self, **kv) -> "Counter":
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(f"{self.name} labels are {self.labelnames}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Counter(self.name, self.help)
                self._children[key] = child
        return child

    @property
    def value(self) -> float:
        with self._lock:
            if self.labelnames:
                return sum(c.value for c in self._children.values())
            return self._value

    def per_label(self) -> dict[str, float]:
        """Child values keyed by comma-joined label values (flat dicts for
        ``stats()``-style surfacing)."""
        with self._lock:
            children = dict(self._children)
        return {",".join(k): c.value for k, c in children.items()}

    def sample_lines(self) -> list[str]:
        if not self.labelnames:
            return [f"{self.name} {_fmt(self.value)}"]
        with self._lock:
            children = dict(self._children)
        return [f"{self.name}{_label_str(self.labelnames, k)} "
                f"{_fmt(c.value)}" for k, c in sorted(children.items())]


class Gauge:
    """Settable value, or a live callback (``set_function``) evaluated at
    collection time — queue depth, launched-shape count, device memory."""

    kind = "gauge"

    def __init__(self, name: str, help: str):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Callable[[], float] | None = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        with self._lock:
            return self._value

    def sample_lines(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Histogram:
    """Fixed-bucket histogram plus a bounded exact-sample window.

    The buckets (cumulative ``le`` counts) are what Prometheus scrapes and
    what ``quantile_est`` interpolates; the bounded window keeps the *exact*
    recent distribution so ``percentile()`` matches ``np.percentile`` on the
    last ``window`` observations bit-for-bit (the engine's p50/p99 contract
    predates this module and stays exact).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                 window: int = 4096, labelnames: Sequence[str] = ()):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("need at least one bucket bound")
        self.labelnames = tuple(labelnames)
        self._maxwin = int(window)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf
        self._sum = 0.0
        self._count = 0
        self._window: collections.deque = collections.deque(maxlen=window)
        self._children: dict[tuple, Histogram] = {}

    def observe(self, v: float) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled; use .labels(...)")
        v = float(v)
        # bisect by hand: bucket vectors are short and this avoids an import
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._window.append(v)

    def labels(self, **kv) -> "Histogram":
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(f"{self.name} labels are {self.labelnames}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Histogram(self.name, self.help, buckets=self.buckets,
                                  window=self._maxwin)
                self._children[key] = child
        return child

    def _child_list(self) -> list["Histogram"]:
        with self._lock:
            return list(self._children.values())

    @property
    def count(self) -> int:
        if self.labelnames:
            return sum(c.count for c in self._child_list())
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        if self.labelnames:
            return sum(c.sum for c in self._child_list())
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        if self.labelnames:
            n = self.count
            return self.sum / n if n else 0.0
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def per_label(self) -> dict[str, dict]:
        """Per-child summaries keyed by comma-joined label values."""
        with self._lock:
            children = dict(self._children)
        return {",".join(k): dict(count=c.count, mean=c.mean,
                                  p50=c.percentile(50), p99=c.percentile(99))
                for k, c in children.items()}

    def percentile(self, q: float) -> float:
        """Exact percentile over the bounded recent window (numpy method).
        For a labelled family: over the union of the children's windows."""
        if self.labelnames:
            wins = [c._window_values() for c in self._child_list()]
            win = np.asarray([v for w in wins for v in w], np.float64)
        else:
            with self._lock:
                win = np.asarray(self._window, np.float64)
        return float(np.percentile(win, q)) if win.size else 0.0

    def _window_values(self) -> list[float]:
        with self._lock:
            return list(self._window)

    def quantile_est(self, q: float) -> float:
        """Prometheus-style estimate from the fixed buckets (linear
        interpolation inside the target bucket) — what a scraper computing
        ``histogram_quantile`` over ``/metrics`` would see."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if not total:
            return 0.0
        rank = (q / 100.0) * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
                return lo + (hi - lo) * ((rank - prev_cum) / c)
        return self.buckets[-1]

    def sample_lines(self) -> list[str]:
        if self.labelnames:
            with self._lock:
                children = sorted(self._children.items())
            out = []
            for key, child in children:
                inner = ",".join(
                    f'{n}="{_escape_label(v)}"'
                    for n, v in zip(self.labelnames, key))
                out.extend(child._labelled_lines(inner))
            return out
        return self._labelled_lines("")

    def _labelled_lines(self, inner: str) -> list[str]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        pre = (inner + ",") if inner else ""
        suffix = ("{" + inner + "}") if inner else ""
        out, cum = [], 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(f'{self.name}_bucket{{{pre}le="{_fmt(b)}"}} {cum}')
        out.append(f'{self.name}_bucket{{{pre}le="+Inf"}} {total}')
        out.append(f"{self.name}_sum{suffix} {_fmt(s)}")
        out.append(f"{self.name}_count{suffix} {total}")
        return out


class WindowRate:
    """Sliding-window event rate over a bounded timestamp deque.

    ``rate()`` = events inside the last ``window_s`` seconds divided by the
    elapsed time since the first such event — so idle gaps *before* the
    window never drag the rate down (the ``docs_per_sec`` lifetime-span bug),
    while a window with no events honestly reads 0.
    """

    def __init__(self, window_s: float = 10.0, maxlen: int = 4096):
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._ts: collections.deque = collections.deque(maxlen=maxlen)

    def record(self, n: int = 1, t: float | None = None) -> None:
        t = time.perf_counter() if t is None else t
        with self._lock:
            for _ in range(n):
                self._ts.append(t)

    def rate(self, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        cutoff = now - self.window_s
        with self._lock:
            recent = [t for t in self._ts if t >= cutoff]
        if not recent:
            return 0.0
        span = max(now - recent[0], 1e-3)
        return len(recent) / span


class MetricsRegistry:
    """Create-or-get metric factory + Prometheus text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"{name} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames=labelnames)

    def gauge(self, name: str, help: str = "",
              fn: Callable[[], float] | None = None) -> Gauge:
        g = self._get(Gauge, name, help)
        if fn is not None:
            g.set_function(fn)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                  window: int = 4096,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets,
                         window=window, labelnames=labelnames)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._metrics)

    def render_prometheus(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.sample_lines())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Flat JSON-able dump (the ``--metrics-out`` payload)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {}
        for m in metrics:
            if isinstance(m, Histogram) and m.labelnames:
                out[m.name] = m.per_label()
            elif isinstance(m, Histogram):
                out[m.name] = dict(count=m.count, sum=m.sum, mean=m.mean,
                                   p50=m.percentile(50), p99=m.percentile(99))
            elif isinstance(m, Counter) and m.labelnames:
                out[m.name] = m.per_label()
            else:
                out[m.name] = m.value
        return out


# ---------------------------------------------------------------------------
# No-op twins: same API, every method free.  The observer-effect benchmark
# swaps these in to measure (not assume) instrumentation overhead.
# ---------------------------------------------------------------------------

class NoopCounter:
    kind = "counter"
    labelnames: tuple = ()
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def labels(self, **kv) -> "NoopCounter":
        return self

    def per_label(self) -> dict:
        return {}

    def sample_lines(self) -> list[str]:
        return []


class NoopGauge:
    kind = "gauge"
    value = 0.0

    def set(self, v: float) -> None:
        pass

    def inc(self, n: float = 1.0) -> None:
        pass

    def set_function(self, fn) -> None:
        pass

    def sample_lines(self) -> list[str]:
        return []


class NoopHistogram:
    kind = "histogram"
    labelnames: tuple = ()
    count = 0
    sum = 0.0
    mean = 0.0

    def observe(self, v: float) -> None:
        pass

    def labels(self, **kv) -> "NoopHistogram":
        return self

    def per_label(self) -> dict:
        return {}

    def percentile(self, q: float) -> float:
        return 0.0

    def quantile_est(self, q: float) -> float:
        return 0.0

    def sample_lines(self) -> list[str]:
        return []


class NoopWindowRate:
    def record(self, n: int = 1, t: float | None = None) -> None:
        pass

    def rate(self, now: float | None = None) -> float:
        return 0.0


class NoopRegistry:
    """API-compatible free registry (shared singleton: ``NOOP_REGISTRY``)."""

    _COUNTER = NoopCounter()
    _GAUGE = NoopGauge()
    _HISTOGRAM = NoopHistogram()

    def counter(self, name, help="", labelnames=()):
        return self._COUNTER

    def gauge(self, name, help="", fn=None):
        return self._GAUGE

    def histogram(self, name, help="", buckets=LATENCY_BUCKETS_MS,
                  window=4096, labelnames=()):
        return self._HISTOGRAM

    def names(self) -> list[str]:
        return []

    def render_prometheus(self) -> str:
        return ""

    def snapshot(self) -> dict:
        return {}


NOOP_REGISTRY = NoopRegistry()
