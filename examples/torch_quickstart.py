"""Quickstart of the PyTorch port: train LDA with the paper's
sparsity-aware sampler on a small planted-topic corpus.

    PYTHONPATH=src python examples/torch_quickstart.py              # cuda:0
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On a card the sweep runs the port's CUDA kernels; ``--device cpu`` runs
their plain PyTorch versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)

    from repro_torch.core import trainer
    from repro_torch.data.synthetic import lda_corpus
    from repro_torch.train import fit

    corpus = lda_corpus(num_docs=120, num_words=400, num_topics=16,
                        avg_doc_len=64, seed=0)
    print(f"corpus: T={corpus.num_tokens} D={corpus.num_docs} "
          f"V={corpus.num_words}")

    cfg = trainer.LDAConfig(num_topics=16, tile_tokens=64, tiles_per_step=16)
    res = fit(corpus, cfg, args.iters, device=args.device, eval_every=5,
              callback=lambda it, st, ll: print(
                  f"iter {it + 1:3d}  LL/token {ll:8.4f}"))
    tps = res.tokens_per_sec[3:] or res.tokens_per_sec
    print(f"\nsampling speed: {sum(tps) / len(tps) / 1e6:.2f}M tokens/sec "
          f"(sparse hit rate {res.stats[-1][0]:.2f})")
    return res


if __name__ == "__main__":
    main()
