"""The port's phase spans read from a ``torch.profiler`` trace: each device
operation attributed to the innermost ``lda.*`` range of the program that
was open where it was launched, and grouped into steps by the enclosing
``lda.step``.

The program opens the ranges when it is handed an annotating tracer
(``SpanTracer(enabled=True, annotate=True)``; the phases:
``repro_torch/core/trainer.py``'s module docstring).  A device operation's
launch is found through the profiler's correlation ids: the host operation
it is linked to (the innermost operator open at its launch), or else the
runtime call that launched it; the innermost ``lda.*`` range that holds
that host event's start on its thread is the operation's phase.  Device
time is each operation's own duration, summed (kernels on two streams may
overlap; none is counted twice).  User annotations on the device are not
device work and are left out, as ``devtrace.py`` leaves them out.

``summarize(events(prof))`` is one rank's summary, JSON-ready; the readings
over a run's ranks are ``step_ms`` (a phase's device time a step) and
``sync_split`` (the phi sync's NCCL kernel split into the wait for the
latest rank and the wire after it, on the ranks' shared clock).

The kind ``kinds/lda_train.py`` hands the program no tracer and keeps no
phase summary, so this module's ``install`` (a run's ``hook``) does both
for a run that ``main`` makes:

    python3 -m portbench.phases --workload <cell> --seed <n> --seconds <s> \\
        [--spans 0|1]

runs a cell traced, as ``run.py --trace 1`` does, with the program's spans
on (``--spans 1``, the default) or off, and prints the cell's metrics, the
phases' readings and the coverage on one JSON line (notes on standard
error).  Without as many CUDA cards as the cell asks for it exits with 2.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import sys
import time

PREFIX = "lda."
STEP = "lda.step"
SYNC = "lda.sync"
STEP_PHASES = ("lda.uniforms", "lda.theta", "lda.ell", "lda.sweep",
               "lda.advance", "lda.sync", "lda.stats", "lda.step")
TOP = 3             # device operations named in each phase's summary
NAME_CHARS = 96


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event, times in ns on the profiler's (wall) clock.
    ``kind``: "range" (an ``lda.*`` range on the host), "op" (any other
    host event with no link: an operator, another range), "runtime" (a
    host event linked to an op: a CUDA runtime call, a launch among them)
    or "device"."""
    name: str
    kind: str
    start: int
    end: int
    thread: int = 0
    corr: int = 0       # the profiler's correlation id
    linked: int = 0     # the op a runtime call or device event belongs to


def events(prof) -> list:
    """A finished ``torch.profiler.profile``'s events as ``Event``s; the
    device's user annotations left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        ev = dict(name=e.name(), start=start, end=start + e.duration_ns(),
                  corr=e.correlation_id(), linked=e.linked_correlation_id())
        if e.device_type() == DeviceType.CPU:
            kind = ("range" if ev["name"].startswith(PREFIX)
                    else "op" if ev["linked"] == 0 else "runtime")
            out.append(Event(kind=kind, thread=e.start_thread_id(), **ev))
        elif not e.is_user_annotation():
            out.append(Event(kind="device", **ev))
    return out


class _Ranges:
    """The ``lda.*`` ranges of one thread, sorted by start, each with its
    parent and the index of its step."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r.start, -r.end))
        self.starts = [r.start for r in self.ranges]
        self.parent, self.step = [], []
        stack, self.steps = [], 0
        for i, r in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]].end <= r.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            if r.name == STEP:
                self.step.append(self.steps)
                self.steps += 1
            else:
                p = self.parent[-1]
                self.step.append(self.step[p] if p >= 0 else None)
            stack.append(i)

    def innermost(self, t: int) -> int:
        """The index of the innermost range holding ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ranges[i].end < t:
            i = self.parent[i]
        return i


def summarize(evs: list) -> dict | None:
    """One rank's phases, or None where the trace holds no device time.

    Returns ``steps`` (the ``lda.step`` ranges), ``device_s`` (every device
    operation's time), ``covered_s`` (theirs under an ``lda.*`` range),
    ``phase_s`` ({phase: seconds}, ``lda.ll`` included), ``step_ms``
    ({phase: [ms in each step]}: the time of operations whose innermost
    range is that phase, in the step that holds it; ``lda.step`` for those
    directly under the step), ``sync`` ([[first start, last end] in ns of
    the NCCL kernels under ``lda.sync``, or None, for each step]) and
    ``top`` ({phase: [[device operation, seconds], ...]})."""
    device = [e for e in evs if e.kind == "device"]
    if not device:
        return None
    by_thread = collections.defaultdict(list)
    for e in evs:
        if e.kind == "range":
            by_thread[e.thread].append(e)
    threads = {t: _Ranges(rs) for t, rs in by_thread.items()}
    ops = {e.corr: e for e in evs if e.kind in ("op", "range")}
    runtime = {e.corr: e for e in evs if e.kind == "runtime"}
    n_steps = max((tr.steps for tr in threads.values()), default=0)

    step_ms = {p: [0.0] * n_steps for p in STEP_PHASES}
    sync = [None] * n_steps
    phase_s: dict[str, float] = collections.defaultdict(float)
    names = collections.defaultdict(lambda: collections.defaultdict(float))
    total = covered = 0.0
    for d in device:
        s = (d.end - d.start) * 1e-9
        total += s
        found = _phase_of(d, ops, runtime, threads)
        if found is None:
            continue
        name, step = found
        covered += s
        phase_s[name] += s
        names[name][d.name[:NAME_CHARS]] += s
        if step is None or name not in step_ms:
            continue
        step_ms[name][step] += s * 1e3
        if name == SYNC and "nccl" in d.name.lower():
            a, b = sync[step] or (d.start, d.end)
            sync[step] = [min(a, d.start), max(b, d.end)]
    top = {p: [[k, v] for k, v in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:TOP]]
           for p, per in names.items()}
    return dict(steps=n_steps, device_s=total, covered_s=covered,
                phase_s=dict(phase_s), step_ms=step_ms, sync=sync, top=top)


def _phase_of(d: Event, ops: dict, runtime: dict, threads: dict):
    """(the phase, the step index or None) of device operation ``d``, or
    None where no ``lda.*`` range holds its launch."""
    host = ops.get(d.linked) if d.linked else None
    if host is not None:
        candidates = [threads[host.thread]] if host.thread in threads else []
    else:
        host = runtime.get(d.corr)
        candidates = list(threads.values())     # its thread id may differ
    if host is None:
        return None
    best = None
    for tr in candidates:
        i = tr.innermost(host.start)
        if i >= 0 and (best is None
                       or tr.ranges[i].start > best[0].ranges[best[1]].start):
            best = (tr, i)
    if best is None:
        return None
    tr, i = best
    return tr.ranges[i].name, tr.step[i]


# ---------------------------------------------------------------------------
# readings over a run's ranks (each a ``summarize`` result, or None)
# ---------------------------------------------------------------------------
def step_ms(summaries: list, phase: str) -> float | None:
    """The median over the window's steps of ``phase``'s device time a
    step, in ms; over several ranks the slowest rank's median."""
    medians = [statistics.median(s["step_ms"][phase]) for s in summaries
               if s and s["steps"]]
    return max(medians) if medians else None


def sync_split(summaries: list) -> tuple[float, float] | None:
    """(wait, wire) of the phi sync's NCCL kernel, in ms: in each step, each
    rank's kernel start subtracted from the latest rank's start (the wait),
    and the latest start from each rank's kernel end (the wire); the means
    over the steps and ranks.  None without two ranks' syncs."""
    syncs = [s["sync"] for s in summaries if s]
    if len(syncs) < 2:
        return None
    waits, wires = [], []
    for step in zip(*syncs):
        if any(x is None for x in step):
            continue
        latest = max(a for a, _ in step)
        waits += [(latest - a) * 1e-6 for a, _ in step]
        wires += [(b - latest) * 1e-6 for _, b in step]
    if not waits:
        return None
    return statistics.mean(waits), statistics.mean(wires)


def coverage(summaries: list) -> float | None:
    """The share of device time under an ``lda.*`` range, in %, the least
    over the ranks."""
    shares = [100 * s["covered_s"] / s["device_s"] for s in summaries if s]
    return min(shares) if shares else None


def readings(summaries: list) -> dict:
    """The phases' readings over the ranks, those with a value: the four
    step readings and, with two ranks or more, the sync's wait and wire."""
    out = {}
    for name, phase in (("theta_step_ms", "lda.theta"),
                        ("ell_step_ms", "lda.ell"),
                        ("sweep_step_ms", "lda.sweep"),
                        ("advance_step_ms", "lda.advance")):
        v = step_ms(summaries, phase)
        if v is not None:
            out[name] = v
    split = sync_split(summaries)
    if split is not None:
        out["sync_wait_ms"], out["sync_wire_ms"] = split
    return out


def notes(summaries: list) -> list:
    """One line a phase (median device ms a step, the slowest rank's) and
    the coverage, for standard error."""
    if not any(s and s["steps"] for s in summaries):
        return []
    s0 = next(s for s in summaries if s)
    lines = [f"phase {p}: {step_ms(summaries, p):.3f} ms a step"
             for p in STEP_PHASES]
    lines += [f"phase {p}: {v:.3f} s in the window"
              for p, v in sorted(s0["phase_s"].items())]
    lines += [f"phase {p} top: " + "; ".join(f"{k} {v:.3f} s" for k, v in t)
              for p, t in sorted(s0["top"].items())]
    lines.append(f"phases cover {coverage(summaries):.2f}% of the device "
                 "time (the least over the ranks)")
    return lines


# ---------------------------------------------------------------------------
# a traced run with the program's spans on
# ---------------------------------------------------------------------------
def install() -> None:
    """A run's ``hook``: the kind's ``Program`` hands the program an
    annotating tracer, and its trace summary gains ``phases``."""
    from portbench import devtrace
    from portbench.kinds import lda_train
    from repro_torch.core import trainer
    from repro_torch.obs import SpanTracer

    tracer = SpanTracer(enabled=True, annotate=True)

    class Program(lda_train.Program):
        def __init__(self, spec, rank, dev):
            super().__init__(spec, rank, dev)
            mesh = getattr(self.step, "__self__", None)   # DistributedLDA
            if mesh is not None:
                mesh.tracer = tracer
                return
            cfg, shard = self.cfg, self.shard
            self.step = lambda st: trainer.lda_iteration(cfg, shard, st,
                                                         tracer=tracer)
            self.ll = lambda st: float(trainer.log_likelihood(
                cfg, shard, st, tracer=tracer)) / self.tokens

    plain = devtrace.summarize

    def summarize_with_phases(prof, window_s, kernels=()):
        out = plain(prof, window_s, kernels)
        if out is not None:
            out["phases"] = summarize(events(prof))
        return out

    lda_train.Program = Program
    devtrace.summarize = summarize_with_phases


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    start = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    from portbench import run

    manifest = run.load_json(root / "BENCHMARK.json")
    files = run.load_cell(manifest, args.workload)
    need = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"the cell needs {need} CUDA card(s)", file=sys.stderr)
        return 2
    result, lines = measure(manifest, files, args.seed, args.seconds,
                            "cuda", start, bool(args.spans))
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


def measure(manifest: dict, files: dict, seed: int, seconds: float,
            device: str, start: float, spans: bool = True):
    """One traced run of a cell: (the result, the lines for standard
    error).  The result holds every metric of the cell, end-to-end and
    per-layer, whose reader finds something, ``phases`` (the readings
    above, with ``coverage_pct``), ``correct`` and the breakdown."""
    import importlib

    from portbench import run

    kind = importlib.import_module(
        f"portbench.kinds.{files['traffic']['kind']}")
    spec = dict(config=files["config"], traffic=files["traffic"], seed=seed,
                seconds=seconds, trace=True, device=device,
                hook="portbench.phases:install" if spans else None)
    ranks = kind.run(spec)
    run_d = dict(ranks=ranks, start=start, trace=True)
    metrics = {}
    for trace in (False, True):
        for m in run.cell_metrics(manifest, files["cell"]["name"], trace):
            value = run.reader(m["name"])(run_d)
            if value is not None:
                metrics[m["name"]] = value
    summaries = [(r["trace"] or {}).get("phases") for r in ranks]
    phases = readings(summaries)
    if any(summaries):
        phases["coverage_pct"] = coverage(summaries)
    rep = kind.report(ranks, start)
    correct, checks = run.verdict(rep["readings"], files["limits"])
    result = dict(workload=files["cell"]["name"], seed=seed, spans=spans,
                  correct=correct, metrics=metrics, phases=phases,
                  breakdown=rep["breakdown"], checks=checks)
    return result, rep["notes"] + notes(summaries)


if __name__ == "__main__":
    sys.exit(main())
