"""Training launcher: CGS-LDA on one device or over a mesh
(``--workload lda``), and transformer pretraining on one device
(``--workload lm --arch <id>``).

The port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --iters 50 --topics 1024 --scale 0.01

trains on the NYTimes-shaped synthetic corpus (or a UCI bag-of-words file
with ``--uci``) on ``cuda:0``, checkpointing every ``--ckpt-every``
iterations and resuming from the newest compatible checkpoint.
``--device cpu`` runs the plain PyTorch sweep instead of the kernels.

Over several devices (one process per rank):

* ``--host-devices N`` spawns N local ranks: gloo ranks with ``--device
  cpu`` (as the reference forces N host devices), NCCL ranks on cards
  0..N-1 otherwise (fewer cards raise);
* ``--distributed`` joins the group ``torchrun`` describes
  (``torchrun --nproc-per-node 4 -m repro_torch.launch.train
  --distributed``; ``--init-method file:///path`` for a shared store);
* ``--mode 2d`` lays the ranks out as a (data, model) mesh; on one device
  it trains without a mesh, as the reference does.

``--workload lm --arch <id>`` trains from seeded random weights on
synthetic batches (B = 8, S = 128) drawn on the device each step,
printing the loss every 10 steps.  On one device it trains the
architecture's ``smoke()`` config.  With ``--host-devices N`` or
``--distributed`` it trains over the reference's ("data", "model") mesh
of shape (N // 2, min(N, 2)) with ``make_policy(mesh, batch=8)``: tensor
parallelism over "model", the batch and ZeRO-3 over "data" (gloo ranks on
the CPU, NCCL on cards); ``smoke()`` below 16 ranks and the full config
from 16, as the reference.  A MoE arch's layers run expert-parallel over
"model".  An odd rank count above one is refused (the mesh would not
cover the ranks).
"""
from __future__ import annotations

import argparse
import math
import sys

LM_BATCH, LM_SEQ, LM_SEED = 8, 128, 0


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
    ap.add_argument("--compressed-sync", action="store_true",
                    help="over a mesh, sync phi deltas on the int16 byte "
                         "wire (half the bytes of the int32 all-reduce)")
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
                    help="export host phase spans as Chrome trace JSON, "
                         "viewable in Perfetto: compile/sample/eval and, "
                         "inside them, each step's lda.step, lda.uniforms, "
                         "lda.theta, lda.ell, lda.sweep, lda.advance, "
                         "lda.sync, lda.stats and lda.ll, stamped on the "
                         "wall clock torch.profiler traces use")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="spawn N local ranks (gloo with --device cpu, "
                         "NCCL on N cards otherwise)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group torchrun describes")
    ap.add_argument("--init-method", default="env://",
                    help="--distributed's rendezvous: env:// (torchrun) or "
                         "file:///path of a shared store")
    ap.add_argument("--sanitize", action="store_true",
                    help="debug mode: any host-device synchronisation inside "
                         "the sampling sweep is an error")
    return ap


def refused(args) -> str | None:
    """The message for a flag combination the port does not run, else
    None."""
    if args.workload == "lm" and not args.arch:
        return "--arch is required for --workload lm"
    if args.workload == "lm" and (args.host_devices or args.distributed):
        n = args.host_devices
        if n > 1 and n % 2:
            return (f"--workload lm over {n} ranks: the ({n // 2}, 2) mesh "
                    "would not cover them; use an even count")
    return None


def run_lm(args) -> int:
    """Train for ``args.iters`` steps: ``smoke(args.arch)`` on one device
    (``cuda:0`` unless ``--device`` says otherwise), or, as this rank of
    the default group when one is initialised, over the reference's mesh
    (the module docstring)."""
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.configs.archs import ARCHS, smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import parallel
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo
    from repro_torch.models.common import NO_SHARDING
    from repro_torch.optim import adamw

    dev = resolve_device(args.device)
    cfg, policy, where, lead = smoke(args.arch), NO_SHARDING, str(dev), True
    if dist.is_initialized():
        from repro_torch.distributed.launch import training_mesh
        from repro_torch.launch.specs import make_policy

        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        n = dist.get_world_size()
        cfg = smoke(args.arch) if n < 16 else ARCHS[args.arch]
        mesh = training_mesh(dev.type, "2d")
        shape = tuple(mesh.mesh.shape)
        policy = make_policy(mesh, batch=LM_BATCH)
        where = f"a {shape} mesh of {n} {dev.type} ranks"
        lead = dist.get_rank() == 0
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_SEED), policy=policy)
    state = zoo.TrainState(params, adamw.init(params))
    step = zoo.make_train_step(cfg, policy=policy)
    # one generator per modality: drawing tokens, frames and patches from
    # one stream would correlate the three synthetic inputs
    g_tok, g_frames, g_patch = (
        torch.Generator(device=dev).manual_seed(LM_SEED * 3 + 1 + k)
        for k in range(3))
    B, S = LM_BATCH, LM_SEQ
    m = {"loss": float("nan")}
    t0 = time.perf_counter()
    for i in range(args.iters):
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g_tok,
                             device=dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.encoder_layers:
            batch["frames"] = torch.randn(
                (B, cfg.encoder_frames, cfg.d_model), generator=g_frames,
                dtype=torch.bfloat16, device=dev)
        if cfg.vision_tokens:
            batch["patches"] = torch.randn(
                (B, cfg.vision_tokens, cfg.d_model), generator=g_patch,
                dtype=torch.bfloat16, device=dev)
        if policy.enabled:
            batch = parallel.dp_rows(batch, policy.ctx)
        state, m = step(state, batch)
        if (i + 1) % 10 == 0 and lead:
            print(f"step {i + 1}: loss {float(m['loss']):.4f}", flush=True)
    wall = time.perf_counter() - t0
    if lead:
        print(f"[done] {cfg.name} on {where}: {args.iters} steps of B = "
              f"{B}, S = {S}, final loss {float(m['loss']):.4f}, "
              f"{args.iters * B * S / max(wall, 1e-9):.0f} tokens/s",
              flush=True)
    return 0


def run_lda(args) -> int:
    """Train on one device, or as this rank of the default group when one
    is initialised."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import trainer
    from repro_torch.core.corpus import read_uci_bow
    from repro_torch.data.synthetic import nytimes_like
    from repro_torch.device import resolve_device
    from repro_torch.distributed.launch import training_mesh
    from repro_torch.obs import Observability
    from repro_torch.train import fit

    dev = resolve_device(args.device)
    mesh, lead = None, True
    if dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = training_mesh(dev.type, args.mode)
        lead = dist.get_rank() == 0
    corpus = read_uci_bow(args.uci) if args.uci else nytimes_like(args.scale)
    cfg = trainer.LDAConfig(num_topics=args.topics, sampler=args.sampler,
                            compressed_sync=args.compressed_sync)
    # eval cadence hits every --ckpt-every multiple and keeps the
    # every-10-iterations progress line
    ev = math.gcd(10, max(1, args.ckpt_every))
    obs = Observability.default(trace=bool(args.trace_out))
    res = fit(corpus, cfg, args.iters, mesh, mode=args.mode,
              doc_axes=("data",),
              word_axes=("model",) if args.mode == "2d" else (),
              device=dev, eval_every=ev, obs=obs,
              metrics_out=args.metrics_out, sanitize=args.sanitize,
              checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
              verbose=True)
    if not lead:
        return 0
    if args.trace_out:
        print(f"[obs] trace -> {obs.tracer.export(args.trace_out)}")
    if args.metrics_out:
        print(f"[obs] per-iteration metrics -> {args.metrics_out}")
    if res.tokens_per_sec:   # empty when resume already covered --iters
        tps = sorted(res.tokens_per_sec)[len(res.tokens_per_sec) // 2]
        where = (f"{mesh.size()} ranks ({args.mode}, "
                 f"{'int16 bytes' if args.compressed_sync else 'int32'} "
                 "sync)" if mesh else str(dev))
        print(f"[done] {where}  warm-up {res.compile_sec:.1f}s  "
              f"median {tps / 1e6:.3f}M tok/s", flush=True)
    return 0


def _local_rank(rank: int, argv: list[str]) -> None:
    args = build_argparser().parse_args(argv)
    run_lm(args) if args.workload == "lm" else run_lda(args)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    msg = refused(args)
    if msg:
        print(f"[train] {msg}", file=sys.stderr)
        return 2
    if args.workload == "lm" and not (args.host_devices
                                      or args.distributed):
        return run_lm(args)
    if args.host_devices:
        from repro_torch.device import resolve_device
        from repro_torch.distributed import launch

        dev = resolve_device(args.device)
        launch.spawn(_local_rank, args.host_devices, args=(argv,),
                     device_type=dev.type)
        return 0
    if args.distributed:
        import torch.distributed as dist

        from repro_torch.device import resolve_device
        from repro_torch.distributed import launch

        launch.init_from_env(resolve_device(args.device).type,
                             args.init_method)
        try:
            return run_lm(args) if args.workload == "lm" else run_lda(args)
        finally:
            dist.destroy_process_group()
    return run_lda(args)


if __name__ == "__main__":
    sys.exit(main())
