"""Serving launcher of the LM zoo: batched greedy decode against per-layer
caches.

The port of ``repro.launch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --batch 8 --gen 16

runs the architecture's ``smoke()`` config (random weights from a seeded
``torch.Generator``) on ``cuda:0``, or where ``--device`` says: one decode
step to warm up, then ``--gen`` greedy steps over ``logits[..., :vocab]``,
and prints the decode rate.  Without a card and without ``--device cpu``
it fails.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs.archs import ARCHS, smoke
from ..device import resolve_device
from ..models import transformer as tf
from ..models import zoo

SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-27b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs on the "
                    "host).  The reference's --host-devices has no "
                    "counterpart: it is an XLA flag that fakes host devices")
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke(args.arch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tf.init_params(cfg, gen)
    dstate = zoo.init_decode_state(cfg, args.batch, max_len=args.max_len,
                                   device=dev)
    dstep = zoo.make_decode_step(cfg)
    tok = torch.randint(0, cfg.vocab_size, (args.batch, 1), generator=gen,
                        device=dev)
    logits, dstate = dstep(params, dstate, tok)  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.gen):
        tok = logits[:, :, :cfg.vocab_size].argmax(-1)
        logits, dstate = dstep(params, dstate, tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    rate = args.batch * args.gen / dt
    print(f"{cfg.name}: {rate:8.0f} tok/s decode ({args.batch} streams, "
          f"{dev})")
    return dict(arch=cfg.name, device=str(dev), tokens_per_s=rate,
                seconds=dt, position=int(dstate.position),
                finite=bool(torch.isfinite(logits.float()).all()))


if __name__ == "__main__":
    main()
