"""The phases' attribution (``portbench/phases.py``) on hand-built
timelines, and the hook that turns the program's spans on, on the CPU.

A hand-built step (times in ns): each phase's host operator launches one
device operation after the host has moved on, as a CUDA stream runs
behind its host; the phi sync's NCCL kernel and the likelihood's kernel
are among them, one memcpy is found through its runtime call alone and one
launch lies outside every range.
"""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import devtrace, phases, run
from portbench.kinds import lda_train
from portbench.tests import tiny

E = phases.Event
# phase: (host range, device kernel's name, its device duration in ns)
STEP = [("lda.uniforms", "rand_kernel", 5_000),
        ("lda.theta", "indexFuncLargeIndex", 60_000),
        ("lda.ell", "radixSortKVInPlace", 140_000),
        ("lda.sweep", "lda_sample_kernel", 300_000),
        ("lda.advance", "phi_count_kernel", 20_000),
        ("lda.sync", "ncclDevKernel_AllReduce_Sum_u32", 80_000)]


def step_events(t0: int, corr0: int, scale: float = 1.0,
                sync: tuple | None = None) -> list:
    """One step from host time ``t0``, its correlation ids from ``corr0``;
    device durations times ``scale``; the NCCL kernel from ``sync[0]`` to
    ``sync[1]`` where given."""
    evs = [E("lda.step", "range", t0, t0 + 10_000, 1, corr0)]
    dev_t = t0 + 20_000
    c = corr0 + 1
    for i, (phase, kernel, ns) in enumerate(STEP):
        h = t0 + 100 + i * 1_000
        evs += [E(phase, "range", h, h + 900, 1, c),
                E(f"op:{phase}", "op", h + 100, h + 800, 1, c + 1)]
        a, b = dev_t, dev_t + int(ns * scale)
        if phase == "lda.sync" and sync:
            a, b = sync
        evs.append(E(kernel, "device", a, b, corr=10_000 + c, linked=c + 1))
        dev_t = b
        c += 2
    # directly under the step: the step's stats
    evs += [E("aten::sum", "op", t0 + 8_000, t0 + 8_100, 1, c),
            E("reduce_kernel", "device", dev_t, dev_t + 1_000, corr=10_000 + c,
              linked=c)]
    return evs


def timeline(steps=2, scales=None, syncs=None) -> list:
    """``steps`` steps 10 ms apart, then the likelihood and a stats read."""
    evs = []
    for s in range(steps):
        evs += step_events(s * 10_000_000, s * 100 + 1,
                           scales[s] if scales else 1.0,
                           syncs[s] if syncs else None)
    t = steps * 10_000_000
    evs += [  # a memcpy found by its runtime call, inside lda.theta
        E("cudaMemcpyAsync", "runtime", 1_150, 1_160, 7, 9_001, linked=0),
        E("Memcpy DtoD", "device", 30_000, 32_000, corr=9_001),
        # the likelihood, outside every step
        E("lda.ll", "range", t, t + 5_000, 1, 9_100),
        E("aten::mul", "op", t + 10, t + 90, 1, 9_101),
        E("ll_kernel", "device", t + 100, t + 50_100, corr=9_102,
          linked=9_101),
        # the window's stats read: under no range
        E("aten::_local_scalar_dense", "op", t + 9_000, t + 9_010, 1, 9_200),
        E("Memcpy DtoH", "device", t + 9_010, t + 9_011, corr=9_201,
          linked=9_200)]
    return evs


def test_each_device_operation_goes_to_its_innermost_phase():
    s = phases.summarize(timeline())
    assert s["steps"] == 2
    for phase, _, ns in STEP:
        if phase != "lda.theta":
            assert s["step_ms"][phase] == pytest.approx([ns * 1e-6] * 2)
    # the first step's theta holds the memcpy found by its runtime call
    assert s["step_ms"]["lda.theta"] == pytest.approx([0.062, 0.06])
    assert s["step_ms"]["lda.step"] == pytest.approx([1e-3] * 2)
    assert s["step_ms"]["lda.stats"] == [0.0] * 2
    assert s["phase_s"]["lda.ll"] == pytest.approx(50e-6)
    assert "lda.ll" not in s["step_ms"]
    assert s["top"]["lda.sweep"] == [["lda_sample_kernel",
                                      pytest.approx(600e-6)]]


def test_a_runtime_call_stands_in_for_a_missing_operator():
    s = phases.summarize(timeline())
    names = dict(s["top"]["lda.theta"])
    assert names["Memcpy DtoD"] == pytest.approx(2e-6)
    # found in the first step's lda.theta: 2 us on top of its kernel
    assert s["phase_s"]["lda.theta"] == pytest.approx(122e-6)


def test_coverage_leaves_out_work_outside_every_range():
    s = phases.summarize(timeline())
    outside = 1e-9      # the stats read's memcpy
    assert s["device_s"] - s["covered_s"] == pytest.approx(outside)
    assert phases.coverage([s]) == pytest.approx(
        100 * (1 - outside / s["device_s"]))


def test_steps_are_told_apart_by_their_lda_step():
    s = phases.summarize(timeline(3, scales=(1.0, 2.0, 4.0)))
    assert s["step_ms"]["lda.sweep"] == pytest.approx([0.3, 0.6, 1.2])
    assert phases.step_ms([s], "lda.sweep") == pytest.approx(0.6)


@pytest.mark.parametrize("name,phase", [
    ("theta_step_ms", "lda.theta"), ("ell_step_ms", "lda.ell"),
    ("sweep_step_ms", "lda.sweep"), ("advance_step_ms", "lda.advance")])
def test_a_step_reading_is_the_slowest_ranks_median(name, phase):
    ns = dict((p, n) for p, _, n in STEP)[phase] * 1e-6
    fast = phases.summarize(timeline(3))
    slow = phases.summarize(timeline(3, scales=(1.0, 3.0, 5.0)))
    got = phases.readings([fast, slow, None])
    assert got[name] == pytest.approx(3 * ns)
    assert phases.readings([fast])[name] == pytest.approx(ns)


def test_sync_is_split_into_wait_and_wire_on_two_ranks():
    # step 0: rank 1 reaches the sync 0.4 ms after rank 0; step 1: rank 0
    # 0.1 ms after rank 1; the bytes take 1.6 ms from the latest start on
    # rank 0, 1.62 ms on rank 1 (start, end in ms)
    ms = 1_000_000
    r0 = phases.summarize(timeline(2, syncs=[(5.0 * ms, 7.0 * ms),
                                             (15.1 * ms, 16.7 * ms)]))
    r1 = phases.summarize(timeline(2, syncs=[(5.4 * ms, 7.02 * ms),
                                             (15.0 * ms, 16.72 * ms)]))
    wait, wire = phases.sync_split([r0, r1])
    assert wait == pytest.approx((0.4 + 0 + 0 + 0.1) / 4)
    assert wire == pytest.approx((1.6 + 1.62) / 2)
    got = phases.readings([r0, r1])
    assert got["sync_wait_ms"] == wait and got["sync_wire_ms"] == wire
    # each rank's kernel is its wait and its wire, no more
    dur = [(b - a) * 1e-6 for s in (r0, r1) for a, b in s["sync"]]
    assert wait + wire == pytest.approx(sum(dur) / len(dur))


def test_the_sync_is_read_from_nccl_kernels_under_lda_sync():
    s = phases.summarize(timeline(1))
    a, b = s["sync"][0]
    assert b - a == 80_000      # the NCCL kernel's own start and end


def test_no_device_trace_reads_nothing():
    host_only = [e for e in timeline() if e.kind != "device"]
    assert phases.summarize(host_only) is None
    assert phases.readings([None, None]) == {}
    assert phases.step_ms([], "lda.theta") is None
    assert phases.coverage([None]) is None
    assert phases.notes([None]) == []
    one = phases.summarize(timeline())
    assert phases.sync_split([one]) is None
    assert "sync_wait_ms" not in phases.readings([one])


def test_events_of_a_cpu_profile_keep_ranges_and_operators():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("lda.step"):
            with record_function("lda.theta"):
                torch.ones(8).sum()
    evs = phases.events(prof)
    ranges = [e for e in evs if e.kind == "range"]
    assert [e.name for e in ranges] == ["lda.step", "lda.theta"]
    assert any(e.kind == "op" and e.name == "aten::sum" for e in evs)
    base = prof.profiler.kineto_results.trace_start_ns()
    first = min(prof.events(), key=lambda e: e.time_range.start)
    assert ranges[0].start == pytest.approx(
        base + first.time_range.start * 1e3, abs=1e3)
    assert phases.summarize(evs) is None       # no device on the CPU


def test_the_hook_hands_the_program_an_annotating_tracer(monkeypatch):
    monkeypatch.setattr(lda_train, "Program", lda_train.Program)
    monkeypatch.setattr(devtrace, "summarize", devtrace.summarize)
    phases.install()
    _, files = tiny.cell("nytimes-train")
    spec = dict(config=files["config"], traffic=files["traffic"],
                seed=tiny.SEED, seconds=0.1, trace=True, device="cpu")
    prog = lda_train.Program(spec, 0, torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = prog.step(prog.take_state())
        prog.ll(state)
    names = [e.name for e in phases.events(prof) if e.kind == "range"]
    assert names.count("lda.step") == 1 and names.count("lda.ll") == 1
    assert {"lda.theta", "lda.ell", "lda.sweep", "lda.advance"} <= set(names)


def test_a_traced_cpu_run_with_the_spans_stays_correct(monkeypatch):
    monkeypatch.setattr(lda_train, "Program", lda_train.Program)
    monkeypatch.setattr(devtrace, "summarize", devtrace.summarize)
    manifest, files = tiny.cell("pubmed-train")
    res, lines = phases.measure(manifest, files, tiny.SEED, 0.3, "cpu",
                                time.time())
    assert res["correct"], res["checks"]
    assert res["spans"] and res["phases"] == {}
    assert {"tokens_per_s", "prep_s", "theta_ell_ms"} <= set(res["metrics"])
    assert "idle_share" not in res["metrics"]
    assert not [line for line in lines if line.startswith("phase")]
    assert run.NAME.fullmatch(res["workload"])
