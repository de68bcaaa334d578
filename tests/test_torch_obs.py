"""The port's phase spans inside the LDA step (``core/trainer.py``,
``distributed/partition.py``) and the span tracer's clock
(``obs/trace.py``), on the CPU under a CPU ``torch.profiler``.

* names and nesting: one ``lda.step`` at the top, every other phase of the
  step directly under it, in WorkSchedule1, WorkSchedule2 and over two gloo
  ranks (``lda.sync`` and ``lda.stats`` there; the overlapped sync's
  launches and waits under ``lda.sync``); ``lda.ll`` on its own;
* ``NULL_TRACER`` opens no range;
* the spans are metadata: z, phi_vk and phi_sum bit-identical with them on
  and off (the counterpart of the reference's
  ``test_instrumentation_does_not_change_draws``);
* the exported start of a span lies within 1 ms of its profiler range's
  start on the profiler's clock (``trace_start_ns()`` + ``time_range.start``).
"""
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import trainer
from repro_torch.core.corpus import tile_corpus
from repro_torch.data.synthetic import zipf_corpus
from repro_torch.distributed import launch
from repro_torch.obs import NULL_TRACER, SpanTracer

STEP_PHASES = {"lda.uniforms", "lda.theta", "lda.ell", "lda.sweep",
               "lda.advance", "lda.sync"}
CORPUS = dict(num_docs=40, num_words=120, avg_doc_len=30, seed=4)


def _case(micro_chunks=1):
    corpus = zipf_corpus(**CORPUS)
    cfg = trainer.resolve_config(trainer.LDAConfig(
        num_topics=16, tile_tokens=32, tiles_per_step=4,
        micro_chunks=micro_chunks, seed=7), corpus)
    shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0]
    return cfg, shard, trainer.init_state(cfg, shard)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _lda_ranges(prof):
    """[(name, the nearest enclosing lda.* range's name or None)], in the
    order the ranges opened."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith("lda."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("lda."):
            p = p.cpu_parent
        out.append((e.name, p.name if p is not None else None))
    return out


def _check_step(ranges):
    """One lda.step at the top; every other range of the step under it."""
    steps = [r for r in ranges if r[0] == "lda.step"]
    assert steps == [("lda.step", None)]
    inner = [r for r in ranges if r[0] not in ("lda.step", "lda.ll")]
    assert all(parent == "lda.step" for _, parent in inner), ranges
    return [name for name, _ in inner]


@pytest.mark.parametrize("M", [1, 3], ids=["ws1", "ws2"])
def test_step_phases_nest_under_one_step(M):
    cfg, shard, st = _case(M)
    tracer = SpanTracer(annotate=True)
    prof, _ = _profiled(lambda: (
        trainer.lda_iteration(cfg, shard, st, tracer=tracer),
        trainer.log_likelihood(cfg, shard, st, tracer=tracer)))
    ranges = _lda_ranges(prof)
    names = _check_step(ranges)
    assert set(names) == STEP_PHASES
    assert ("lda.ll", None) in ranges
    # WS2 refreshes theta and its ELL once a micro-chunk, after the
    # iteration's first build; the sweep adds the chunks' assembly
    count = {n: names.count(n) for n in STEP_PHASES}
    assert count == {"lda.uniforms": 1, "lda.theta": 1 + (M > 1) * M,
                     "lda.ell": 1 + (M > 1) * M,
                     "lda.sweep": M + (M > 1), "lda.advance": 2,
                     "lda.sync": 1}
    # the tracer's own record holds the same spans as the profiler's
    exported = [e["name"] for e in tracer.to_chrome()["traceEvents"]
                if e["ph"] == "X"]
    assert sorted(exported) == sorted(n for n, _ in ranges)


def test_theta_and_ell_opens_its_two_phases_alone():
    cfg, shard, st = _case()
    tracer = SpanTracer(annotate=True)
    prof, _ = _profiled(lambda: trainer.theta_and_ell(cfg, shard, st.z,
                                                      tracer=tracer))
    assert _lda_ranges(prof) == [("lda.theta", None), ("lda.ell", None)]


def test_null_tracer_opens_no_range():
    cfg, shard, st = _case(2)
    prof, _ = _profiled(lambda: (
        trainer.lda_iteration(cfg, shard, st),
        trainer.lda_iteration(cfg, shard, st, tracer=NULL_TRACER),
        trainer.log_likelihood(cfg, shard, st)))
    assert not [e for e in prof.events() if e.name.startswith("lda.")]
    assert len(NULL_TRACER) == 0


@pytest.mark.parametrize("M", [1, 2], ids=["ws1", "ws2"])
def test_spans_do_not_change_the_draws(M):
    cfg, shard, st0 = _case(M)
    tracer = SpanTracer(annotate=True)

    def run(**kw):
        st = st0
        for _ in range(2):
            st, _ = trainer.lda_iteration(cfg, shard, st, **kw)
        return st

    plain = run()
    _, traced = _profiled(lambda: run(tracer=tracer))
    assert len(tracer) > 0
    for field in ("z", "phi_vk", "phi_sum"):
        assert torch.equal(getattr(plain, field), getattr(traced, field)), \
            field
    assert traced.iteration == plain.iteration == 2


def test_exported_start_is_on_the_profilers_clock():
    cfg, shard, st = _case()
    tracer = SpanTracer(annotate=True)
    prof, _ = _profiled(
        lambda: trainer.lda_iteration(cfg, shard, st, tracer=tracer))
    base_ns = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((e for e in prof.events() if e.name.startswith("lda.")),
                    key=lambda e: e.time_range.start)
    spans = sorted((e for e in tracer.to_chrome()["traceEvents"]
                    if e["ph"] == "X"), key=lambda e: e["ts"])
    assert [e.name for e in ranges] == [s["name"] for s in spans]
    for e, s in zip(ranges, spans):
        range_us = base_ns / 1e3 + e.time_range.start
        assert abs(s["ts"] - range_us) < 1e3, (e.name, s["ts"] - range_us)
        assert s["dur"] <= e.time_range.elapsed_us() + 1e3


def test_complete_and_span_share_the_wall_clock():
    tracer = SpanTracer()
    wall_us, t0 = time.time_ns() / 1e3, time.perf_counter()
    tracer.complete("done", t0, t0 + 0.002)
    with tracer.span("now"):
        pass
    done, now = [e for e in tracer.to_chrome()["traceEvents"]
                 if e["ph"] == "X"]
    assert abs(done["ts"] - wall_us) < 1e3
    assert done["dur"] == pytest.approx(2e3)
    assert done["pid"] == now["pid"] == os.getpid()
    assert 0 <= now["ts"] - wall_us < 1e6
    assert not hasattr(tracer, "instant") and not hasattr(tracer, "now_us")


def test_a_plain_tracer_records_spans_without_ranges():
    cfg, shard, st = _case()
    tracer = SpanTracer()
    prof, _ = _profiled(
        lambda: trainer.lda_iteration(cfg, shard, st, tracer=tracer))
    assert not [e for e in prof.events() if e.name.startswith("lda.")]
    names = [e["name"] for e in tracer.to_chrome()["traceEvents"]
             if e["ph"] == "X"]
    assert set(names) == STEP_PHASES | {"lda.step"}
    step = [e for e in tracer.to_chrome()["traceEvents"]
            if e.get("name") == "lda.step"][0]
    assert step["args"] == {"iteration": 0}


# ---------------------------------------------------------------------------
# two gloo ranks: DistributedLDA.step
# ---------------------------------------------------------------------------
MESH_CASES = {"1d": {}, "1d_m2_overlap": dict(micro_chunks=2,
                                               sync_overlap=True)}


def _mesh_rank(rank, out_dir):
    """Each case's ranges on this rank (spawned; importable by name)."""
    from repro_torch.distributed.partition import DistributedLDA

    corpus = zipf_corpus(**CORPUS)
    mesh = launch.training_mesh("cpu", "1d")
    found = {}
    for name, over in MESH_CASES.items():
        cfg = trainer.LDAConfig(num_topics=16, tile_tokens=32,
                                tiles_per_step=4, seed=7, **over)
        dl = DistributedLDA(cfg, mesh, corpus, mode="1d", device="cpu",
                            tracer=SpanTracer(annotate=True))
        st = dl.init()
        prof, _ = _profiled(lambda: (dl.step(st), dl.log_likelihood(st)))
        found[name] = _lda_ranges(prof)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)


@pytest.fixture(scope="module")
def mesh_ranges(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_spans")
    launch.spawn(_mesh_rank, 2, args=(str(out),))
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_step_phases_nest_under_one_step(mesh_ranges, case):
    M = MESH_CASES[case].get("micro_chunks", 1)
    for found in mesh_ranges:
        ranges = [tuple(r) for r in found[case]]
        names = _check_step(ranges)
        assert set(names) == STEP_PHASES | {"lda.stats"}
        assert names.count("lda.stats") == 1
        # overlapped: each chunk's launch, then each wait, under lda.sync
        assert names.count("lda.sync") == (2 * M if M > 1 else 1)
        assert ("lda.ll", None) in ranges
