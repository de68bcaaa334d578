"""LDA serving launcher: online topic inference against a frozen snapshot.

The port of ``repro.launch.serve_lda``: a snapshot is loaded onto the card
and this process answers per-document topic queries through the
continuous-batching engine with hot-swap.

Self-driving benchmark (trains a small synthetic model if the snapshot is
missing, serves a request storm, hot-swaps a further-trained model
mid-flight):

    PYTHONPATH=src python -m repro_torch.launch.serve_lda --snapshot /tmp/lda.npz --bench

As in the reference, the bench trains through ``repro_torch.train.fit`` on
``lda_corpus`` (256 docs, 400 words, K = ``--topics``, 32 by default) for
``--train-iters`` iterations and exports the state with
``snapshot_from_state``; the hot-swap v2 model is the same chain trained 15
iterations further.

``planted_model``, ``planted_snapshot`` and ``planted_docs`` build a
*planted* model from a seed at NYTimes width (V = 101,636, K = 1024) and
documents drawn from it, for a check of serving at full width
(``chip_smoke.py``).  A planted model has a known answer: every word has a
home topic holding ~80% of its Zipf count, and documents drawn from two
topics' home words must fold in to their major topic.

HTTP JSON endpoint (stdlib only):

    PYTHONPATH=src python -m repro_torch.launch.serve_lda --snapshot /tmp/lda.npz --port 8080
    POST /infer  {"tokens": [3, 17, ...], "deadline_ms": 250}
    POST /swap   {"snapshot": "/path/to/newer.npz"}
    GET  /metrics | /stats | /trace | /healthz

``--device cpu`` serves with the fold-in's plain PyTorch version; the
default is the card (``cuda:0``), and the launcher fails if there is none.
``--shards N`` serves phi word-sharded over N devices (cards ``cuda:0`` ..
``cuda:N-1``, or N CPU entries with ``--device cpu``; fails with fewer
cards than shards): a dense snapshot is re-split at load, a ``.sharded``
directory keeps its own layout, and ``/swap`` re-shards the same way.
``--comm`` picks how the shards' rows meet (``serve/infer.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import numpy as np

from repro_torch.configs import lda_nytimes

ZIPF_EXPONENT = 1.1      # the word-frequency skew of data.synthetic.nytimes_like
HOME_SHARE = 0.8         # planted model: share of a word's count on its home
SPREAD_TOPICS = 3        # ... the rest over this many seeded topics
TRAIN_TOPICS = 32        # K of the bench's trained model, as the reference


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snapshot", required=True,
                    help="snapshot path: a dense .npz or a .sharded "
                         "directory")
    ap.add_argument("--bench", action="store_true",
                    help="self-drive: train-if-missing, storm, hot-swap demo")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain PyTorch fold-in)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    # engine knobs
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--delay-ms", type=float, default=3.0)
    ap.add_argument("--length-buckets", type=int, nargs="+",
                    default=[32, 64, 128, 256])
    # robustness knobs
    ap.add_argument("--max-queue", type=int, default=256,
                    help="bounded admission queue depth (0 = unbounded)")
    ap.add_argument("--admission", choices=("block", "reject", "shed_oldest"),
                    default="block",
                    help="policy when the queue is full: backpressure the "
                         "submitter, 429 the request, or shed the oldest "
                         "queued request to admit the new one")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request deadline; expired requests "
                         "are dropped before device time is spent on them")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="deterministic fault injection: JSON list or "
                         "compact 'kind[@at][xcount][:delay_s]' items "
                         "(see repro_torch.serve.faults)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for rate-based fault specs")
    ap.add_argument("--burn-in", type=int, default=8)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--impl", choices=("kernel", "ref"), default="kernel",
                    help="fold-in sweeps: the CUDA kernel (its plain "
                         "PyTorch version on a CPU device), or the plain "
                         "version everywhere")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve phi word-sharded over this many devices; a "
                         "dense snapshot is re-split at load, a .sharded "
                         "directory keeps its own layout (0/1 = unsharded)")
    ap.add_argument("--comm", choices=("auto", "psum", "all2all"),
                    default="auto",
                    help="V-sharded gather strategy: 'psum' sums every "
                         "shard's (B, L, K) rows on the lead device, "
                         "'all2all' routes only the batch's token ids to "
                         "the owning shards and moves the gathered rows "
                         "back, 'auto' uses the snapshot's own tag; draws "
                         "are bit-identical either way")
    # observability
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the serving phase-span trace (Chrome trace "
                         "JSON) at shutdown / bench end")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a final JSON dump of stats + the metrics "
                         "registry at shutdown / bench end")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable phase-span recording")
    ap.add_argument("--sanitize", action="store_true",
                    help="debug mode: runtime lock-held assertions in the "
                         "engine")
    # bench-mode model knobs
    ap.add_argument("--topics", type=int, default=TRAIN_TOPICS,
                    help="K of the bench's trained model")
    ap.add_argument("--train-iters", type=int, default=25)
    ap.add_argument("--bench-docs", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    return ap


# ---------------------------------------------------------------------------
# planted model (a model with a known answer, at NYTimes width)
# ---------------------------------------------------------------------------

def zipf_weights(num_words: int) -> np.ndarray:
    """Word w's share of the corpus: rank w + 1 of a Zipf(1.1) law, as in
    ``data.synthetic.zipf_corpus``."""
    p = np.arange(1, num_words + 1, dtype=np.float64) ** -ZIPF_EXPONENT
    return p / p.sum()


def planted_model(num_words: int, num_topics: int, seed: int,
                  num_tokens: int = lda_nytimes.FULL["num_tokens"]):
    """(phi (V, K) int32, home (V,) int64): word w's Zipf count out of
    ``num_tokens``, ~80% on its seeded home topic and the rest spread over
    a few seeded topics."""
    rng = np.random.default_rng(seed)
    counts = np.maximum(1, np.rint(zipf_weights(num_words) * num_tokens)
                        ).astype(np.int64)
    home = rng.integers(0, num_topics, num_words)
    others = rng.integers(0, num_topics, (num_words, SPREAD_TOPICS))
    rows = np.arange(num_words)
    phi = np.zeros((num_words, num_topics), np.int32)
    on_home = np.rint(HOME_SHARE * counts).astype(np.int64)
    phi[rows, home] = on_home
    rest = counts - on_home
    share = rest // SPREAD_TOPICS
    for j in range(SPREAD_TOPICS):
        extra = rest - share * SPREAD_TOPICS if j == 0 else 0
        np.add.at(phi, (rows, others[:, j]), (share + extra).astype(np.int32))
    return phi, home


def planted_snapshot(num_words: int, num_topics: int, seed: int,
                     device=None):
    """The planted model as a serving snapshot (through
    ``snapshot_from_state``, as a trained state would go)."""
    from repro_torch.serve import snapshot_from_state

    phi, _ = planted_model(num_words, num_topics, seed)
    state = types.SimpleNamespace(phi_vk=phi, phi_sum=phi.sum(0, dtype=np.int64)
                                  .astype(np.int32), iteration=0)
    return snapshot_from_state(state, lda_nytimes.alpha(num_topics),
                               lda_nytimes.BETA, num_words_total=num_words,
                               meta={"planted_seed": seed}, device=device)


def planted_docs(home: np.ndarray, num_topics: int, num_docs: int,
                 avg_len: int, seed: int):
    """Documents drawn from a planted model: a 75/25 mix of two seeded
    topics, words picked by Zipf frequency among each topic's home words,
    lengths Poisson(avg_len).  Returns (docs, major topic per doc)."""
    rng = np.random.default_rng(seed)
    w = zipf_weights(home.shape[0])
    owned = [np.flatnonzero(home == k) for k in range(num_topics)]
    live = np.asarray([k for k in range(num_topics) if owned[k].size])
    docs, majors = [], []
    for _ in range(num_docs):
        a, b = rng.choice(live, size=2, replace=False)
        n = max(1, int(rng.poisson(avg_len)))
        mix = rng.choice([a, b], size=n, p=[0.75, 0.25])
        words = np.empty(n, np.int32)
        for k in (a, b):
            sel = mix == k
            p = w[owned[k]] / w[owned[k]].sum()
            words[sel] = rng.choice(owned[k], size=int(sel.sum()), p=p)
        docs.append(words)
        majors.append(int(a))
    return docs, np.asarray(majors)


# ---------------------------------------------------------------------------
# engine assembly
# ---------------------------------------------------------------------------

def make_fault_plan(args):
    """One FaultPlan per process (shared by the hot-swap model and the
    engine, so per-site event counters stay globally consistent)."""
    spec = getattr(args, "fault_plan", None)
    if not spec:
        return None
    from repro_torch.serve import FaultPlan

    return FaultPlan.parse(spec, seed=getattr(args, "fault_seed", 0))


def load_model(args, path: str | None = None, fault_plan=None):
    """Load the snapshot honoring --shards: dense files are re-split into
    word shards at load time, ``.sharded`` directories keep their layout."""
    from repro_torch.serve import load_any_snapshot

    return load_any_snapshot(path or args.snapshot,
                             shards=max(args.shards, 0),
                             comm=None if args.comm == "auto" else args.comm,
                             fault_plan=fault_plan, device=args.device)


def layout(snap) -> str:
    from repro_torch.serve import ShardedModelSnapshot

    if isinstance(snap, ShardedModelSnapshot):
        return (f"V-sharded x{snap.num_shards} (comm={snap.comm}) on "
                f"{', '.join(map(str, snap.devices))}")
    return f"dense on {snap.device}"


def make_engine(args, snap, fault_plan=None):
    from repro_torch.obs import Observability
    from repro_torch.serve import (EngineConfig, HotSwapModel, InferConfig,
                                   LDAServeEngine)

    if fault_plan is None:
        fault_plan = make_fault_plan(args)
    model = HotSwapModel(snap, fault_plan=fault_plan)
    cfg = EngineConfig(
        max_batch=args.max_batch, max_delay_ms=args.delay_ms,
        length_buckets=tuple(args.length_buckets),
        infer=InferConfig(burn_in=args.burn_in, samples=args.samples,
                          top_k=args.top_k, impl=args.impl, comm=args.comm),
        max_queue=getattr(args, "max_queue", 256),
        admission=getattr(args, "admission", "block"),
        default_deadline_ms=getattr(args, "deadline_ms", None),
        fault_plan=fault_plan,
        sanitize=bool(getattr(args, "sanitize", False)))
    obs = Observability.default(trace=not getattr(args, "no_trace", False))
    return model, LDAServeEngine(model, cfg, seed=args.seed, obs=obs)


def device_memory_stats() -> dict:
    """Per-card bytes in use by PyTorch, free and total; empty without
    CUDA."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = dict(bytes_in_use=torch.cuda.memory_allocated(i),
                                bytes_free=free, bytes_limit=total)
    return out


def enriched_stats(model, engine) -> dict:
    """``engine.stats()`` + serving context: model version/shape and device
    memory."""
    snap = model.acquire()[1]
    s = engine.stats()
    s.update(model_version=model.version, num_words=snap.num_words,
             num_topics=snap.num_topics, device=str(snap.device),
             device_memory=device_memory_stats())
    return s


def _dump_obs(args, model, engine):
    """Honor --trace-out / --metrics-out at shutdown or bench end."""
    if args.trace_out:
        print(f"[obs] trace -> {engine.obs.tracer.export(args.trace_out)}")
    if args.metrics_out:
        payload = dict(stats=enriched_stats(model, engine),
                       registry=engine.obs.registry.snapshot())
        with open(args.metrics_out, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        print(f"[obs] metrics -> {args.metrics_out}")


# ---------------------------------------------------------------------------
# bench mode
# ---------------------------------------------------------------------------

def _train_and_export(args, extra_iters: int = 0):
    """Train the small synthetic model and export a snapshot to
    ``args.snapshot``, as the reference's bench does.  Returns the
    ``TrainResult``."""
    from repro_torch.core import trainer
    from repro_torch.data.synthetic import lda_corpus
    from repro_torch.serve import save_snapshot, snapshot_from_state
    from repro_torch.train import fit

    K = args.topics
    corpus = lda_corpus(num_docs=256, num_words=400, num_topics=K,
                        avg_doc_len=64, seed=args.seed)
    cfg = trainer.LDAConfig(num_topics=K, tile_tokens=64, tiles_per_step=16,
                            seed=args.seed)
    n = args.train_iters + extra_iters
    res = fit(corpus, cfg, n, device=args.device, eval_every=n)
    save_snapshot(args.snapshot, snapshot_from_state(
        res.state, cfg.resolved_alpha(), cfg.beta,
        num_words_total=corpus.num_words, device=args.device))
    return res


def run_bench(args) -> int:
    from repro_torch.data.synthetic import lda_corpus
    from repro_torch.serve.eval import docs_from_corpus, heldout_perplexity

    if not os.path.exists(args.snapshot):
        t0 = time.perf_counter()
        print(f"[bench] no snapshot at {args.snapshot}; training a "
              f"K={args.topics} synthetic model ({args.train_iters} iters)")
        res = _train_and_export(args)
        print(f"[bench] LL/token {res.ll_per_token[-1]:.4f}")
        print(f"[bench] trained + exported in {time.perf_counter() - t0:.1f}s")
    snap = load_model(args)
    print(f"[bench] snapshot: V={snap.num_words} K={snap.num_topics} "
          f"meta={snap.meta} phi={layout(snap)}")

    # unseen synthetic docs with the same vocabulary
    docs = docs_from_corpus(lda_corpus(
        num_docs=args.bench_docs, num_words=snap.num_words,
        num_topics=snap.num_topics, avg_doc_len=64, seed=args.seed + 1))

    model, engine = make_engine(args, snap)
    print(f"[bench] fold-in impl: {args.impl}")
    engine.infer(docs[0])  # first launch builds the kernel outside the storm
    results = engine.infer_many(docs)
    stats = engine.stats()
    print(f"[bench] served {int(stats['requests'])} docs in "
          f"{stats['batches']:.0f} batches (mean batch "
          f"{stats['mean_batch']:.1f})")
    print(f"[bench] p50 {stats['p50_ms']:.1f} ms   p99 {stats['p99_ms']:.1f} ms"
          f"   {stats['docs_per_sec']:.1f} docs/sec")

    ppl = heldout_perplexity(snap, docs[: min(32, len(docs))])
    print(f"[bench] held-out document-completion perplexity: "
          f"{ppl.perplexity:.1f} over {ppl.num_tokens} tokens")

    # hot-swap: the same chain trained 15 iterations further; the engine
    # keeps running
    print(f"[bench] training {args.train_iters + 15} iters for the v2 "
          "snapshot")
    _train_and_export(args, extra_iters=15)
    snap2 = load_model(args)   # --shards: the v2 model swaps in sharded too
    v = model.publish(snap2)
    results2 = engine.infer_many(docs[:16])
    moved = max(float(np.abs(r2["theta"] - r1["theta"]).sum())
                for r1, r2 in zip(results[:16], results2))
    print(f"[bench] hot-swapped to model_version={v} without restart; "
          f"max |Δtheta|₁ across redone docs = {moved:.3f}")
    if results2[0]["model_version"] != v:
        raise RuntimeError("hot-swapped model was not served")
    _dump_obs(args, model, engine)
    engine.stop()
    return 0


# ---------------------------------------------------------------------------
# HTTP mode (stdlib only — no framework deps)
# ---------------------------------------------------------------------------

def make_http_server(args, model, engine):
    """Build (not start) the ThreadingHTTPServer — separated from
    ``run_http`` so tests can bind port 0 and drive the real endpoints."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj):
            self._reply_raw(code, json.dumps(obj, default=str).encode(),
                            "application/json")

        def _reply_raw(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet access log
            pass

        def do_GET(self):
            if self.path == "/healthz":
                health = engine.ready()
                code = 200 if health["ready"] else 503
                self._reply(code, {"ok": health["ready"],
                                   "model_version": model.version,
                                   **health})
            elif self.path == "/stats":
                self._reply(200, enriched_stats(model, engine))
            elif self.path == "/metrics":
                self._reply_raw(
                    200, engine.obs.registry.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/trace":
                self._reply(200, engine.obs.tracer.to_chrome())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._reply(400, {"error": "bad json"})
            if self.path == "/infer":
                from repro_torch.serve import RejectedError

                toks = payload.get("tokens")
                if not isinstance(toks, list) or not toks:
                    return self._reply(400, {"error": "tokens: [word ids]"})
                deadline = payload.get("deadline_ms")
                try:
                    res = engine.infer(toks, deadline_ms=deadline)
                except RejectedError as e:
                    return self._reply(429, {
                        "error": str(e), "reason": e.reason,
                        "queue_depth": e.queue_depth,
                        "max_queue": e.max_queue})
                except (ValueError, TypeError) as e:
                    return self._reply(400, {"error": str(e)})
                except (RuntimeError, TimeoutError) as e:
                    return self._reply(500, {"error": str(e)})
                return self._reply(200, {
                    "top_topics": res["top_topics"].tolist(),
                    "top_weights": res["top_weights"].tolist(),
                    "theta": res["theta"].tolist(),
                    "model_version": res["model_version"],
                    "truncated": bool(res["truncated"]),
                    "latency_ms": res["latency_ms"],
                })
            if self.path == "/swap":
                from repro_torch.serve import PublishError

                path = payload.get("snapshot")
                if not path or not os.path.exists(path):
                    return self._reply(400, {"error": "snapshot path missing"})
                try:
                    v = model.publish(load_model(args, path))
                except PublishError as e:
                    return self._reply(503, {
                        "error": str(e), "rolled_back": True,
                        "model_version": model.version})
                except Exception as e:  # corrupt / non-snapshot file
                    return self._reply(400, {"error": f"bad snapshot: {e}"})
                return self._reply(200, {"model_version": v})
            return self._reply(404, {"error": "unknown path"})

    return ThreadingHTTPServer((args.host, args.port), Handler)


def run_http(args) -> int:
    fault_plan = make_fault_plan(args)
    snap = load_model(args, fault_plan=fault_plan)
    model, engine = make_engine(args, snap, fault_plan=fault_plan)
    httpd = make_http_server(args, model, engine)
    print(f"[serve] V={snap.num_words} K={snap.num_topics} phi={layout(snap)} "
          f"at http://{args.host}:{httpd.server_address[1]}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        _dump_obs(args, model, engine)
        engine.stop()
        httpd.server_close()
    return 0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    return run_bench(args) if args.bench else run_http(args)


if __name__ == "__main__":
    sys.exit(main())
