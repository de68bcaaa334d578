"""End-to-end LDA training on the PyTorch port — the paper's workload at
small scale, with checkpointing and restart.

Trains a K x V topic model on an NYTimes-shaped synthetic corpus (or the
UCI bag-of-words file the paper used, ``--uci docword.nytimes.txt``),
reporting the paper's metrics: #Tokens/sec (Eq. 2) and LL/token (Fig. 8).

    PYTHONPATH=src python examples/torch_train_lda.py --iters 200
    PYTHONPATH=src python examples/torch_train_lda.py --device cpu \
        --iters 20 --topics 64

A rerun with the same ``--ckpt-dir`` resumes from the newest checkpoint
of the same corpus.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--topics", type=int, default=1024)
    ap.add_argument("--scale", type=float, default=0.0005)
    ap.add_argument("--uci", default=None, help="UCI bag-of-words file")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "lda_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--sampler", choices=["sq", "dense"], default="sq")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    from repro_torch.configs import lda_nytimes
    from repro_torch.core import trainer
    from repro_torch.core.corpus import ell_capacity, read_uci_bow
    from repro_torch.train import fit

    corpus = (read_uci_bow(args.uci) if args.uci
              else lda_nytimes.scaled(args.scale))
    print(f"corpus: T={corpus.num_tokens:,} D={corpus.num_docs:,} "
          f"V={corpus.num_words:,}; model = K x V = "
          f"{args.topics * corpus.num_words / 1e6:.1f}M counts")

    cfg = trainer.LDAConfig(num_topics=args.topics, tile_tokens=256,
                            tiles_per_step=32, sampler=args.sampler,
                            ell_capacity=ell_capacity(corpus, args.topics))
    res = fit(corpus, cfg, args.iters, device=args.device,
              eval_every=args.eval_every, checkpoint_dir=args.ckpt_dir,
              checkpoint_every=args.ckpt_every, verbose=True)
    tps = res.tokens_per_sec[2:] or res.tokens_per_sec
    if tps:
        print(f"\nmean throughput: {np.mean(tps) / 1e6:.2f}M tokens/sec "
              f"(paper Eq. 2 metric)")
    return res


if __name__ == "__main__":
    main()
