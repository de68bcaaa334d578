"""Train a ~100M-parameter LM with the PyTorch port (the twin of
examples/train_lm.py): a reduced qwen3-family config (~100M params with
the embedding) on a synthetic Zipf-bigram stream.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300     # cuda:0
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 30

The same model, optimizer and step code as ``launch/train.py --workload
lm``; batches reach the device through ``data.loader.PrefetchLoader``.
``main`` returns the loss of every step.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.archs import QWEN3_4B
    from repro_torch.data.loader import PrefetchLoader
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        QWEN3_4B, name="qwen3-100m", num_layers=args.layers,
        d_model=args.d_model, num_heads=8, num_kv_heads=2, head_dim=64,
        d_ff=4 * args.d_model, vocab_size=args.vocab)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  ({dev})")

    state = zoo.TrainState(params, adamw.init(params))
    step = zoo.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))

    # synthetic autoregressive data with learnable structure (Zipf bigrams)
    rng = np.random.default_rng(0)
    trans = rng.integers(0, args.vocab, size=(4096,))

    def batch_at(i):
        starts = rng.integers(0, args.vocab, size=(args.batch, 1))
        toks = [starts]
        for _ in range(args.seq):
            toks.append(trans[toks[-1] % 4096])
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    loader = PrefetchLoader(batch_at, device=dev)
    losses = []
    t0 = time.perf_counter()
    try:
        for i in range(args.steps):
            state, m = step(state, next(loader))
            losses.append(m["loss"])
            if (i + 1) % max(1, args.steps // 10) == 0:
                dt = time.perf_counter() - t0
                tput = (i + 1) * args.batch * args.seq / dt
                print(f"step {i + 1:4d}  loss {float(m['loss']):7.4f}  "
                      f"gnorm {float(m['grad_norm']):6.2f}  "
                      f"{tput:7.0f} tok/s")
    finally:
        loader.close()
    print("done — loss should approach 0 (deterministic bigram table).")
    return [float(x) for x in losses]


if __name__ == "__main__":
    main()
