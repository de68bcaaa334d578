"""Serve a small LM with the PyTorch port (the twin of
examples/serve_lm.py): a batch of prompts replayed token by token through
the decode step to fill the (ring) KV caches, then greedy decode.

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 4 --gen 32
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Runs the architecture's ``smoke()`` config from seeded random weights on
``cuda:0`` unless ``--device`` says otherwise.  ``main`` returns the rates,
the generated ids and the decode state's position.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--arch", default="gemma2-27b",
                    help="assigned arch family to use (reduced config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.archs import smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo

    dev = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    cfg = smoke(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(cfg, gen)
    B = args.requests
    print(f"serving {cfg.name}: {B} requests, prompt {args.prompt_len}, "
          f"gen {args.gen} ({dev})")

    # prefill: replay the prompt through the decode path to populate the
    # (ring) caches — same numerics as a full-sequence forward
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=gen, device=dev)
    dstate = zoo.init_decode_state(cfg, B, max_len=args.prompt_len + args.gen,
                                   device=dev)
    dstep = zoo.make_decode_step(cfg)

    t0 = time.perf_counter()
    logits = None
    for i in range(args.prompt_len):
        logits, dstate = dstep(params, dstate, prompts[:, i:i + 1])
    sync()
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    out_tokens = []
    tok = logits[:, :, :cfg.vocab_size].argmax(-1)
    for _ in range(args.gen):
        out_tokens.append(tok)
        logits, dstate = dstep(params, dstate, tok)
        tok = logits[:, :, :cfg.vocab_size].argmax(-1)
    sync()
    t_decode = time.perf_counter() - t0

    ids = torch.cat(out_tokens, dim=1)
    print(f"prefill(replay): {B * args.prompt_len / t_prefill:7.0f} tok/s")
    print(f"decode:          {B * args.gen / t_decode:7.0f} tok/s")
    print("sample output ids:", ids[0, :12].tolist())
    return dict(device=str(dev), prefill_tokens_per_s=B * args.prompt_len
                / t_prefill, decode_tokens_per_s=B * args.gen / t_decode,
                ids=ids.cpu(), position=int(dstate.position),
                finite=bool(torch.isfinite(logits.float()).all()))


if __name__ == "__main__":
    main()
