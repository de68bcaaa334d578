"""repro_torch.obs — unified telemetry for training and serving.

Three pieces, one bundle:

  * :mod:`repro_torch.obs.metrics` — lock-cheap, bounded-memory counters / gauges /
    fixed-bucket histograms behind a :class:`MetricsRegistry`, rendered as
    Prometheus text exposition (``GET /metrics`` in ``launch/serve_lda``);
  * :mod:`repro_torch.obs.trace` — host phase-span tracing exported as Chrome
    trace-event JSON (Perfetto-loadable), optionally mirrored into
    ``torch.profiler`` ranges (a ``RecordFunction`` each);
  * :mod:`repro_torch.obs.sink` — per-iteration JSONL rows for training.

:class:`Observability` carries a registry + tracer pair through the engine
and trainer.  ``Observability.noop()`` is the measured-overhead baseline:
same call sites, every operation free.
"""
from __future__ import annotations

import dataclasses

from .metrics import (LATENCY_BUCKETS_MS, NOOP_REGISTRY, SIZE_BUCKETS,
                      Counter, Gauge, Histogram, MetricsRegistry,
                      NoopRegistry, NoopWindowRate, WindowRate)
from .sink import NULL_SINK, JsonlSink, NullSink
from .trace import NULL_TRACER, SpanTracer

__all__ = [
    "Counter", "Gauge", "Histogram", "JsonlSink", "LATENCY_BUCKETS_MS",
    "MetricsRegistry", "NOOP_REGISTRY", "NULL_SINK", "NULL_TRACER",
    "NoopRegistry", "NoopWindowRate", "NullSink", "Observability",
    "SIZE_BUCKETS", "SpanTracer", "WindowRate",
]


@dataclasses.dataclass(frozen=True)
class Observability:
    """Registry + tracer pair threaded through engine/trainer hot paths."""

    registry: MetricsRegistry | NoopRegistry
    tracer: SpanTracer

    @classmethod
    def default(cls, trace: bool = True, annotate: bool = False,
                max_events: int = 65536) -> "Observability":
        return cls(registry=MetricsRegistry(),
                   tracer=SpanTracer(enabled=trace, annotate=annotate,
                                     max_events=max_events))

    @classmethod
    def noop(cls) -> "Observability":
        return cls(registry=NOOP_REGISTRY, tracer=NULL_TRACER)

    @property
    def enabled(self) -> bool:
        return not isinstance(self.registry, NoopRegistry)

    def window_rate(self, window_s: float = 10.0,
                    maxlen: int = 4096):
        """A :class:`WindowRate` matching this bundle's cost profile."""
        if not self.enabled:
            return NoopWindowRate()
        return WindowRate(window_s=window_s, maxlen=maxlen)
