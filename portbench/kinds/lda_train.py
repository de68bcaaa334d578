"""LDA training cells: the port's training step on one card, or over N
ranks on N cards (one process each), on the benchmark's corpus.

A run, in each rank's process:

1. the corpus from the seed, on the card (``portbench/corpus.py``), then
   handed to the port on the host, as the port reads a corpus;
2. the port's set-up, as ``train/driver.py::fit`` does it: on one card
   ``trainer.resolve_config``, ``tile_corpus``, the shard to the card,
   K2's segment table, ``trainer.init_state``; over N ranks the launcher's
   1d mesh (``distributed/launch.py::training_mesh``),
   ``DistributedLDA`` and its ``init``;
3. one warm step and one evaluation, thrown away (as ``fit``'s warm-up);
4. the window (``portbench/window.py``): ``trainer.lda_iteration`` /
   ``DistributedLDA.step``, the log-likelihood every ``eval_every``
   steps;
5. the peak memory, then the judge (``portbench/judge.py``) on the last
   step, and with ``--trace 1`` the least-work counts and the timed
   calls of theta + ELL; with ``spec["control"]`` also the readings of
   the judge's control and planted faults (``portbench/control.py``).

N ranks are spawned by the port's ``distributed/launch.py::spawn`` (NCCL
on cards, gloo on the CPU); rank 0 decides when the window closes.

``run(spec)`` gives every rank's record; ``report(ranks, start)`` what
``run.py`` prints of them besides the metrics, which the readers under
``portbench/metrics/`` take from the records.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import statistics
import tempfile
import time

import torch

from portbench import corpus as gen
from portbench import devtrace, foreign, judge, stats, window

CHECKS = judge.NAMES     # the readings a cell's limits file bounds
K1_KERNEL = "lda_sample_kernel"
K2_KERNEL = "phi_count_kernel"
COLLECTIVE_TIMEOUT_S = 300
THETA_ELL_CALLS = 3


class Program:
    """The port set up for one rank of a cell: its config, shard, starting
    state, step and evaluation."""

    def __init__(self, spec: dict, rank: int, dev: torch.device):
        from repro_torch.core import trainer
        from repro_torch.core.corpus import Corpus, tile_corpus
        from repro_torch.kernels.phi_update import ops as phi_ops

        t_gen = time.time()
        c, tr = spec["config"], spec["traffic"]
        if tr["mode"] != "1d":
            raise ValueError(f"partition mode {tr['mode']!r}: the judge "
                             "reads 1d partitions only")
        doc_d, word_d = gen.zipf_corpus(c["num_docs"], c["num_words"],
                                        c["avg_doc_len"], c["zipf_exponent"],
                                        spec["seed"], dev)
        self.doc_ids, self.word_ids = doc_d.cpu().numpy(), word_d.cpu().numpy()
        del doc_d, word_d
        if dev.type == "cuda":      # the generator's memory is not the port's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        corpus = Corpus(self.doc_ids, self.word_ids, c["num_docs"],
                        c["num_words"])
        self.tokens = corpus.num_tokens
        self.setup_parts = dict(corpus_s=time.time() - t_gen)
        # the prior from the cell's file, handed to the program and the
        # judge alike: the judge never reads the program's resolved one
        alpha, beta = float(c["alpha"]), float(c["beta"])
        cfg = trainer.LDAConfig(
            num_topics=c["num_topics"], alpha=alpha, beta=beta,
            tile_tokens=c["tile_tokens"],
            micro_chunks=tr["micro_chunks"],
            compressed_sync=tr["compressed_sync"], seed=spec["seed"])
        t0 = time.time()
        if tr["ranks"] == 1:
            cfg = trainer.resolve_config(cfg, corpus)
            shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0].to(dev)
            phi_ops.shard_segments(shard)
            prep_s = time.time() - t0
            self.state = trainer.init_state(cfg, shard)
            self.step = lambda st: trainer.lda_iteration(cfg, shard, st)
            self.ll = lambda st: float(trainer.log_likelihood(
                cfg, shard, st)) / self.tokens
        else:
            from repro_torch.distributed import launch
            from repro_torch.distributed.partition import DistributedLDA

            mesh = launch.training_mesh(dev.type, tr["mode"])
            dl = DistributedLDA(cfg, mesh, corpus, mode=tr["mode"],
                                device=dev)
            prep_s = time.time() - t0
            cfg, shard = dl.cfg, dl.shard
            self.state = dl.init()
            self.step, self.ll = dl.step, dl.log_likelihood
        self.setup_parts.update(prep_s=prep_s,
                                init_s=time.time() - t0 - prep_s)
        self.cfg, self.shard = cfg, shard
        self.problem = judge.Problem(
            self.doc_ids, self.word_ids, c["num_docs"], c["num_words"],
            c["num_topics"], alpha, beta, spec["seed"], tr["ranks"], rank)

    def take_state(self):
        """The starting state, handed over: the window holds the only
        reference, so a step frees the state it replaced."""
        state, self.state = self.state, None
        return state

    def theta_and_ell(self, z):
        from repro_torch.core import trainer

        return trainer.theta_and_ell(self.cfg, self.shard, z)

    def outputs(self, prev_z, state, ll_per_token: float) -> judge.Outputs:
        """The program's outputs around the step from ``prev_z`` to
        ``state``, with the ELL it builds from ``prev_z``."""
        _, counts, topics, _ = self.theta_and_ell(prev_z)
        n = self.shard.tile_word.shape[0]
        s = self.shard
        return judge.Outputs(
            prev_z=prev_z, z=state.z, phi=state.phi_vk,
            phi_sum=state.phi_sum, ell_counts=counts, ell_topics=topics,
            ll_per_token=ll_per_token, iteration=state.iteration - 1,
            rows=n + (-n % self.cfg.micro_chunks), tile_word=s.tile_word,
            token_doc=s.token_doc, token_mask=s.token_mask,
            token_uid=s.token_uid, doc_global=s.doc_global)


def stopper(ranks: int, dev: torch.device):
    """The window's ``stop``: over several ranks rank 0's "time is up"
    decides for all (a broadcast at each evaluation)."""
    def stop(up: bool) -> bool:
        if ranks == 1:
            return up
        flag = torch.tensor([int(up)], dtype=torch.int32, device=dev)
        torch.distributed.broadcast(flag, src=0)
        return bool(flag.item())
    return stop


def device_of(spec: dict, rank: int) -> torch.device:
    return (torch.device("cuda", rank) if spec["device"] == "cuda"
            else torch.device("cpu"))


def read_back(pb: judge.Problem, out: judge.Outputs, counts: bool):
    """Judge one rank's outputs: (readings, least-work inputs or None)."""
    dev = out.z.device
    doc_d = torch.from_numpy(pb.doc_ids).to(dev)
    word_d = torch.from_numpy(pb.word_ids).to(dev)
    layout, tok, zp, zn, u = judge.canonical(pb, out, doc_d, word_d)
    readings, least = judge.judge(
        pb, doc_d, word_d, tok, zp, zn, u, out.phi, out.phi_sum,
        out.ell_counts, out.ell_topics, out.doc_global, out.ll_per_token,
        layout, counts=counts)
    if least is not None:
        least.update(z_bytes=out.z.element_size(),
                     ell_bytes=out.ell_counts.element_size())
    return readings, least


def run_rank(rank: int, spec: dict) -> dict:
    """One rank's run: its readings, as JSON-ready values."""
    if spec.get("hook"):            # a test's planted fault
        mod, fn = spec["hook"].split(":")
        getattr(importlib.import_module(mod), fn)()
    dev = device_of(spec, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    prog = Program(spec, rank, dev)
    clock = window.clock_for(dev)
    stop = stopper(spec["traffic"]["ranks"], dev)

    t_warm = time.time()
    warm, _ = prog.step(prog.state)            # set-up: thrown away
    prog.ll(warm)
    del warm
    stop(False)
    clock.sync()
    prog.setup_parts["warm_s"] = time.time() - t_warm

    prof = contextlib.nullcontext()
    if spec["trace"]:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    with prof:
        win = window.train(prog.step, prog.ll, prog.take_state(),
                           spec["seconds"], spec["traffic"]["eval_every"],
                           clock, stop)
    trace = (devtrace.summarize(prof, win.seconds,
                                kernels=(K1_KERNEL, K2_KERNEL))
             if spec["trace"] else None)
    del prof
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    loaded = foreign.loaded()

    theta_ell_ms = None
    if spec["trace"]:
        times = []
        for _ in range(THETA_ELL_CALLS):
            a = clock.mark()
            prog.theta_and_ell(win.prev_z)
            b = clock.mark()
            clock.sync()
            times.append(clock.ms(a, b))
        theta_ell_ms = statistics.mean(times)
    out = prog.outputs(win.prev_z, win.state, win.ll_per_token)
    readings, least = read_back(prog.problem, out, counts=spec["trace"])
    found = None
    if spec.get("control"):
        from portbench import control

        found = control.faults(prog.problem, out)
    return dict(
        rank=rank, start_wall=win.start_wall, window_s=win.seconds,
        iterations=win.iterations, iter_ms=win.iter_ms, eval_ms=win.eval_ms,
        tokens=prog.tokens, peak_bytes=peak, setup_parts=prog.setup_parts,
        theta_ell_ms=theta_ell_ms, trace=trace, least=least,
        readings=readings, control=found, foreign_modules=loaded,
        num_topics=spec["config"]["num_topics"])


def rank_main(rank: int, spec: dict) -> None:
    """A spawned rank: its readings to ``spec["out_dir"]``."""
    reading = run_rank(rank, spec)
    path = os.path.join(spec["out_dir"], f"rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(reading, f)
    os.replace(path + ".tmp", path)


def run(spec: dict) -> list:
    """Every rank's readings, rank 0 first."""
    ranks = spec["traffic"]["ranks"]
    if ranks == 1:
        return [run_rank(0, spec)]
    from repro_torch.distributed import launch

    with tempfile.TemporaryDirectory() as out:
        launch.spawn(rank_main, ranks, args=(dict(spec, out_dir=out),),
                     device_type=spec["device"],
                     timeout_s=COLLECTIVE_TIMEOUT_S)
        readings = []
        for r in range(ranks):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                readings.append(json.load(f))
    return readings


def report(ranks: list, start: float) -> dict:
    """What a run prints besides its metrics: the readings that the cell's
    limits bound, the steps attempted, the device's figures, a traced
    run's breakdown, the lines for standard error and the foreign modules
    the ranks had loaded.  ``start`` is the process's start (host clock)."""
    r0 = ranks[0]
    device = dict(memory_peak_bytes=max(r["peak_bytes"] for r in ranks))
    traces = [r["trace"] for r in ranks if r["trace"]]
    breakdown = None
    if traces:
        device.update(busy_s=sum(t["busy_s"] for t in traces) / len(traces),
                      window_s=r0["window_s"])
    if r0["trace"]:
        breakdown = dict(device_ops=devtrace.top_ops(r0["trace"]["ops"]),
                         idle_gaps=r0["trace"]["idle_gaps"])
    parts = r0["setup_parts"]
    rest = r0["start_wall"] - start - sum(parts.values())
    notes = [f"window: {r0['iterations']} iterations in "
             f"{r0['window_s']:.3f} s, {len(r0['eval_ms'])} evaluations",
             f"iter_ms_p90 over {len(r0['iter_ms'])} iterations, "
             f"{stats.beyond(r0['iter_ms'], 90)} above it",
             "set-up, rank 0: " + ", ".join(
                 f"{k} {v:.3f}" for k, v in parts.items())
             + f", the rest {rest:.3f}"]
    return dict(readings=r0["readings"], attempted=r0["iterations"],
                device=device, breakdown=breakdown, notes=notes,
                foreign=sorted(set().union(
                    *(r["foreign_modules"] for r in ranks))))
