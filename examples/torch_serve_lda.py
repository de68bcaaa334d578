"""Train -> snapshot -> serve with the PyTorch port's online LDA path.

Trains a small topic model, publishes it as a frozen snapshot, stands up
the continuous-batching engine, answers topic queries for unseen
documents, hot-swaps a fresher snapshot without restarting, reports
held-out document-completion perplexity, and finally serves a V-sharded
snapshot (phi in word blocks, one a device).

    PYTHONPATH=src python examples/torch_serve_lda.py              # cuda:0
    PYTHONPATH=src python examples/torch_serve_lda.py --device cpu
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SHARDS = 2          # word blocks of the V-sharded snapshot

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core import trainer
    from repro_torch.data.synthetic import lda_corpus
    from repro_torch.device import resolve_device
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.serve import (EngineConfig, HotSwapModel, InferConfig,
                                   LDAServeEngine, heldout_perplexity,
                                   load_any_snapshot)
    from repro_torch.serve.eval import docs_from_corpus
    from repro_torch.train import fit

    dev = resolve_device(args.device)

    # 1. train a small model (K=16 planted-topic corpus)
    corpus = lda_corpus(num_docs=200, num_words=300, num_topics=16,
                        avg_doc_len=50, seed=0)
    cfg = trainer.LDAConfig(num_topics=16, tile_tokens=64, tiles_per_step=16)
    res = fit(corpus, cfg, 20, device=dev, eval_every=20)
    print(f"trained: LL/token {res.ll_per_token[-1]:.3f}")

    # 2. publish the frozen model next to the training checkpoints
    with tempfile.TemporaryDirectory(prefix="lda_serve_") as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        alpha = res.cfg.resolved_alpha()
        path = mgr.publish_snapshot(res.state, alpha, cfg.beta,
                                    num_words_total=corpus.num_words)
        print(f"snapshot published: {path}")

        # 3. serve unseen documents through the engine
        model = HotSwapModel(load_any_snapshot(path, device=dev))
        engine = LDAServeEngine(model, EngineConfig(
            max_batch=16, max_delay_ms=2.0, length_buckets=(32, 64, 128),
            infer=InferConfig(burn_in=6, samples=3, top_k=4)))
        try:
            unseen = lda_corpus(num_docs=24, num_words=300, num_topics=16,
                                avg_doc_len=50, seed=7)
            docs = docs_from_corpus(unseen)
            out = engine.infer_many(docs)
            for i, r in enumerate(out[:3]):
                weights = [round(float(w), 3) for w in r["top_weights"]]
                print(f"doc {i}: top topics {r['top_topics'].tolist()} "
                      f"weights {weights} "
                      f"({r['latency_ms']:.0f} ms, "
                      f"model v{r['model_version']})")
            s = engine.stats()
            print(f"engine: p50 {s['p50_ms']:.0f} ms  p99 {s['p99_ms']:.0f} "
                  f"ms  {s['docs_per_sec']:.1f} docs/sec")

            # 4. hot-swap: train further, publish, keep serving
            res2 = fit(corpus, cfg, 40, device=dev, eval_every=40)
            path2 = mgr.publish_snapshot(res2.state, alpha, cfg.beta,
                                         num_words_total=corpus.num_words)
            v = model.publish(load_any_snapshot(path2, device=dev))
            r2 = engine.infer(docs[0])
            print(f"hot-swapped to v{v}; doc 0 now served by model "
                  f"v{r2['model_version']}")

            # 5. held-out quality of the serving path itself
            ppl = heldout_perplexity(load_any_snapshot(path2, device=dev),
                                     docs, InferConfig(burn_in=8, samples=4))
            print(f"held-out perplexity: {ppl.perplexity:.1f} "
                  f"({ppl.num_tokens} completion tokens)")

            # 6. V-sharded serving: phi published in SHARDS word blocks,
            # one a card where there are as many (else all on --device),
            # and hot-swapped in; draws are bit-identical to the dense
            # layout
            path3 = mgr.publish_snapshot(res2.state, alpha, cfg.beta,
                                         num_words_total=corpus.num_words,
                                         shards=SHARDS)
            cards = (torch.cuda.device_count() if dev.type == "cuda"
                     else 0)
            devices = (tuple(torch.device("cuda", i) for i in range(SHARDS))
                       if cards >= SHARDS else (dev,) * SHARDS)
            v = model.publish(load_any_snapshot(path3, devices=devices,
                                                device=devices[0]))
            r3 = engine.infer(docs[0])
            print(f"hot-swapped to v{v} ({SHARDS}-way V-sharded "
                  f"snapshot on {', '.join(map(str, devices))}); doc 0 "
                  f"served by model v{r3['model_version']}")
        finally:
            engine.stop()
    return dict(results=out, version=v, swapped=r3, perplexity=ppl)


if __name__ == "__main__":
    main()
