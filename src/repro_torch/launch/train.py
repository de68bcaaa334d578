"""Training launcher: CGS-LDA on one device (``--workload lda``).

The port of ``repro.launch.train`` for a single card:

    PYTHONPATH=src python -m repro_torch.launch.train --iters 50 --topics 1024 --scale 0.01

trains on the NYTimes-shaped synthetic corpus (or a UCI bag-of-words file
with ``--uci``) on ``cuda:0``, checkpointing every ``--ckpt-every``
iterations and resuming from the newest compatible checkpoint.
``--device cpu`` runs the plain PyTorch sweep instead of the kernels.
Multi-device training (``--mode 2d``, ``--host-devices``,
``--distributed``) comes with slice 3, and transformer pretraining
(``--workload lm``) with slice 4: those flags exit non-zero.
"""
from __future__ import annotations

import argparse
import math
import sys

NOT_PORTED = {
    "workload": ("--workload lm (transformer pretraining) is not ported: it "
                 "comes with slice 4 of the port"),
    "mode": ("--mode 2d (doc x word partition) needs several devices: it "
             "comes with slice 3 (multi-GPU) of the port"),
    "host_devices": ("--host-devices simulates a mesh: multi-device training "
                     "comes with slice 3 (multi-GPU) of the port"),
    "distributed": ("--distributed (multi-host) comes with slice 3 "
                    "(multi-GPU) of the port"),
}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=["lda", "lm"], default="lda")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--mode", choices=["1d", "2d"], default="1d")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the plain "
                         "PyTorch sweep)")
    ap.add_argument("--sampler", choices=["sq", "dense"], default="sq",
                    help="the paper's S/Q sampler (the fused CUDA kernel on "
                         "a card) or the O(K) dense baseline")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--topics", type=int, default=1024)
    ap.add_argument("--scale", type=float, default=0.0005)
    ap.add_argument("--uci", default=None)
    ap.add_argument("--ckpt-dir", default="ckpts")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write one JSONL metrics row per training "
                         "iteration (tokens/sec, LL, sparse_frac, ...)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export host phase spans (compile/sample/eval) as "
                         "Chrome trace JSON, viewable in Perfetto")
    ap.add_argument("--host-devices", type=int, default=0)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--sanitize", action="store_true",
                    help="debug mode: any host-device synchronisation inside "
                         "the sampling sweep is an error")
    return ap


def refused(args) -> str | None:
    """The message for a flag this slice does not bring, else None."""
    if args.workload != "lda":
        return NOT_PORTED["workload"]
    if args.mode != "1d":
        return NOT_PORTED["mode"]
    if args.host_devices:
        return NOT_PORTED["host_devices"]
    if args.distributed:
        return NOT_PORTED["distributed"]
    return None


def run_lda(args) -> int:
    from repro_torch.core import trainer
    from repro_torch.core.corpus import read_uci_bow
    from repro_torch.data.synthetic import nytimes_like
    from repro_torch.device import resolve_device
    from repro_torch.obs import Observability
    from repro_torch.train import fit

    dev = resolve_device(args.device)
    corpus = read_uci_bow(args.uci) if args.uci else nytimes_like(args.scale)
    cfg = trainer.LDAConfig(num_topics=args.topics, sampler=args.sampler)
    # eval cadence hits every --ckpt-every multiple and keeps the
    # every-10-iterations progress line
    ev = math.gcd(10, max(1, args.ckpt_every))
    obs = Observability.default(trace=bool(args.trace_out))
    res = fit(corpus, cfg, args.iters, device=dev, eval_every=ev, obs=obs,
              metrics_out=args.metrics_out, sanitize=args.sanitize,
              checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
              verbose=True)
    if args.trace_out:
        print(f"[obs] trace -> {obs.tracer.export(args.trace_out)}")
    if args.metrics_out:
        print(f"[obs] per-iteration metrics -> {args.metrics_out}")
    if res.tokens_per_sec:   # empty when resume already covered --iters
        tps = sorted(res.tokens_per_sec)[len(res.tokens_per_sec) // 2]
        print(f"[done] {dev}  warm-up {res.compile_sec:.1f}s  "
              f"median {tps / 1e6:.3f}M tok/s")
    return 0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    msg = refused(args)
    if msg:
        print(f"[train] {msg}", file=sys.stderr)
        return 2
    return run_lda(args)


if __name__ == "__main__":
    sys.exit(main())
