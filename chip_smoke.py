#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py

Drives the port's serving path at the full width of the NYTimes
configuration (V = 101,636, K = 1024, alpha = 50/K, beta = 0.01; engine
buckets B <= 32, L in {32, 64, 128, 256}; 8 burn-in + 4 sample sweeps)
against a planted model made from a seed, and holds the fold-in CUDA kernel
against its plain PyTorch version on the card.  Phases, one JSON line each:

1. the card (``nvidia-smi`` name and power limit, torch's device name);
2. the build of every kernel from ``src/repro_torch/kernels/*/csrc`` with
   nvcc, timed;
3. kernel against plain version at B = 32, L = 256, P = 256 on rows
   gathered from the planted model, same z0 and uniforms (bounds below);
4. kernel and plain-version times at each L bucket, B = 32 (CUDA events,
   3 warm-up launches, median of 20);
5. the main path: ``LDAServeEngine`` on the planted snapshot serves unseen
   documents drawn from the model, then hot-swaps a second planted model
   and serves more; the kernel's launch counter is read around it.

Bounds (fault F2: the kernel's prefix sums are sequential float32 adds and
torch.cumsum sums in another order, so a draw on a float boundary may flip
and a flip then changes the rest of that document's chain):

* one sweep: draws differ on <= 1e-3 of real tokens;
* full run: the sparse-draw count and the argmax topic agree on >= 99% of
  documents, and the mean per-document L1 distance of normalised theta is
  <= 0.02;
* main path: every theta sums to 1 (atol 1e-4), the planted major topic is
  recovered on >= 90% of documents, every answer after the swap carries
  the new model version, and the kernel was launched.

Fails (non-zero exit, no result line) without a CUDA card, outside a
checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ONE_SWEEP_MISMATCH = 1e-3
DOC_AGREEMENT = 0.99
MEAN_THETA_L1 = 0.02
RECOVERY = 0.90
SUM_ATOL = 1e-4

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores

BATCH, BUCKETS, SWEEPS = 32, (32, 64, 128, 256), (8, 4)
SERVE_DOCS, SWAP_DOCS = 256, 32


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0]


def gathered_batch(snap, docs, L, seed, n_sweeps):
    """Docs -> the fold-in kernel's inputs at one bucket, on the card."""
    import torch

    from repro_torch.kernels.fold_in import ops
    from repro_torch.serve.infer import pack_docs

    dev = snap.device
    tokens, mask = pack_docs(docs, L)
    tok = torch.from_numpy(tokens).to(dev).long()
    m = torch.from_numpy(mask).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    z0, uni = ops.draw_fold_in_randoms(gen, len(docs), L, snap.num_topics,
                                       n_sweeps, dev)
    return (snap.phi_vk[tok].contiguous(), snap.phi_sum, snap.hyper,
            uni.transpose(0, 1).contiguous(), m.to(torch.int32), z0)


def bytes_and_ops(args, n_sweeps, z_final):
    """The least work of one launch: each input read once and each output
    written once; float operations of the p* precompute (4 per real token
    and topic) and of the sparse sums and searches, counted with each
    doc's final number of live topics standing in for every sweep's."""
    phi_tok, phi_sum, hyper, uni, mask, z0 = args
    B, L, K = phi_tok.shape
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += B * K * 4 + B * 4 + B * 4 + B * L * 4          # outputs
    real = mask.sum(1)
    live = [len(set(z_final[b][mask[b] != 0].tolist())) for b in range(B)]
    ops = 4 * int(real.sum()) * K
    ops += sum(8 * int(real[b]) * live[b] for b in range(B)) * n_sweeps
    return nbytes, ops


def time_ms(fn, n=20, warm=3):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs import lda_nytimes
    from repro_torch.kernels import _build
    from repro_torch.kernels.fold_in import kernel, ref
    from repro_torch.launch import serve_lda

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=card, torch_name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- 2. build every kernel from the checkout's sources -----------------
    t0 = time.perf_counter()
    logs = _build.build_all(["fold_in"])
    regs = [ln.strip() for ln in logs["fold_in"].splitlines()
            if "registers" in ln]
    emit("build", seconds=time.perf_counter() - t0, ptxas=regs)

    # -- planted NYTimes-width model on the card ----------------------------
    V = lda_nytimes.FULL["num_words"]
    K = lda_nytimes.NUM_TOPICS
    avg_len = lda_nytimes.FULL["avg_doc_len"]
    t0 = time.perf_counter()
    snap = serve_lda.planted_snapshot(V, K, seed=0)
    _, home = serve_lda.planted_model(V, K, seed=0)
    docs, majors = serve_lda.planted_docs(home, K, SERVE_DOCS, avg_len,
                                          seed=1)
    emit("model", V=V, K=K, phi_bytes=snap.phi_vk.numel() * 4,
         seconds=time.perf_counter() - t0)

    # -- 3. kernel against plain version at full width ----------------------
    L, P = BUCKETS[-1], BUCKETS[-1]
    burn_in, samples = SWEEPS
    cmp_docs = docs[:BATCH]
    one = gathered_batch(snap, cmp_docs, L, seed=11, n_sweeps=1)
    kw1 = dict(num_words_total=V, burn_in=0, samples=1, ell_capacity=P)
    k1, r1 = kernel.fold_in_docs(*one, **kw1), ref.fold_in_docs_ref(*one, **kw1)
    torch.cuda.synchronize()
    real = one[4] != 0
    n_real = int(real.sum())
    flips = int(((k1[3] != r1[3]) & real).sum())
    full = gathered_batch(snap, cmp_docs, L, seed=12, n_sweeps=sum(SWEEPS))
    kwf = dict(num_words_total=V, burn_in=burn_in, samples=samples,
               ell_capacity=P)
    kf, rf = kernel.fold_in_docs(*full, **kwf), ref.fold_in_docs_ref(*full, **kwf)
    torch.cuda.synchronize()
    sp_agree = float((kf[1] == rf[1]).float().mean())
    arg_agree = float((kf[0].argmax(1) == rf[0].argmax(1)).float().mean())
    tk = kf[0].float() / kf[0].sum(1, keepdim=True).clamp(min=1)
    tr = rf[0].float() / rf[0].sum(1, keepdim=True).clamp(min=1)
    l1 = float((tk - tr).abs().sum(1).mean())
    max_abs_err = int((kf[0] - rf[0]).abs().max())
    ssq_rel = float(((kf[2] - rf[2]).abs()
                     / rf[2].abs().clamp(min=1e-30)).max())
    emit("kernel_vs_plain", B=BATCH, L=L, K=K, P=P, real_tokens=n_real,
         one_sweep_flips=flips, one_sweep_flip_rate=flips / n_real,
         theta_sum_equal=bool(torch.equal(kf[0], rf[0])),
         sp_doc_agreement=sp_agree, argmax_doc_agreement=arg_agree,
         mean_theta_l1=l1, theta_sum_max_abs_err=max_abs_err,
         ssq_max_rel_err=ssq_rel)
    if flips / n_real > ONE_SWEEP_MISMATCH:
        raise AssertionError(f"one-sweep draws differ on {flips}/{n_real}")
    if sp_agree < DOC_AGREEMENT or arg_agree < DOC_AGREEMENT:
        raise AssertionError(f"doc agreement sp={sp_agree} argmax={arg_agree}")
    if l1 > MEAN_THETA_L1:
        raise AssertionError(f"mean theta L1 {l1} > {MEAN_THETA_L1}")

    # -- 4. times at each L bucket, B = 32 ----------------------------------
    rows = []
    for Lb in BUCKETS:
        args = gathered_batch(snap, cmp_docs, Lb, seed=13,
                              n_sweeps=sum(SWEEPS))
        kwb = dict(num_words_total=V, burn_in=burn_in, samples=samples,
                   ell_capacity=min(Lb, K))
        z_final = kernel.fold_in_docs(*args, **kwb)[3].cpu()
        k_ms = time_ms(lambda: kernel.fold_in_docs(*args, **kwb))
        p_ms = time_ms(lambda: ref.fold_in_docs_ref(*args, **kwb))
        nbytes, ops = bytes_and_ops([a.cpu() for a in args], sum(SWEEPS),
                                    z_final)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
        rows.append(dict(B=BATCH, L=Lb, P=min(Lb, K), ms=k_ms, plain_ms=p_ms,
                         bytes=nbytes, ops=ops, bytes_ms=b_ms, ops_ms=o_ms,
                         bound_ms=max(b_ms, o_ms),
                         bound_by="bytes" if b_ms >= o_ms else "operations"))
    emit("timing", card=card, buckets=rows)

    # -- 5. the main path: engine on the planted snapshot, then a hot-swap --
    args = serve_lda.build_argparser().parse_args(
        ["--snapshot", "unused.npz", "--no-trace"])
    model, engine = serve_lda.make_engine(args, snap)
    kernel.fold_in_docs.launches = 0
    t0 = time.perf_counter()
    try:
        results = engine.infer_many(docs, timeout=300.0)
        stats = engine.stats()
        snap2 = serve_lda.planted_snapshot(V, K, seed=1)
        _, home2 = serve_lda.planted_model(V, K, seed=1)
        docs2, majors2 = serve_lda.planted_docs(home2, K, SWAP_DOCS, avg_len,
                                                seed=2)
        version = model.publish(snap2)
        results2 = engine.infer_many(docs2, timeout=300.0)
    finally:
        engine.stop()
    launches = kernel.fold_in_docs.launches
    wall = time.perf_counter() - t0
    theta = np.stack([r["theta"] for r in results + results2])
    recovered = float(np.mean([int(r["theta"].argmax()) == m
                               for r, m in zip(results, majors)]))
    recovered2 = float(np.mean([int(r["theta"].argmax()) == m
                                for r, m in zip(results2, majors2)]))
    lat = np.asarray([r["latency_ms"] for r in results])
    emit("serve", card=card, docs=len(results), batches=stats["batches"],
         mean_batch=stats["mean_batch"],
         truncated=int(sum(r["truncated"] for r in results)),
         p50_ms=float(np.percentile(lat, 50)),
         p90_ms=float(np.percentile(lat, 90)),
         p99_ms=float(np.percentile(lat, 99)),
         docs_per_sec=stats["docs_per_sec"], recovered=recovered,
         swap_version=version, swap_docs=len(results2),
         swap_recovered=recovered2, kernel_launches=launches,
         h2d_transfers=stats["h2d_transfers"], wall_s=wall)
    if not np.allclose(theta.sum(1), 1.0, atol=SUM_ATOL):
        raise AssertionError("a served theta does not sum to 1")
    if recovered < RECOVERY or recovered2 < RECOVERY:
        raise AssertionError(f"planted topic recovered on {recovered} / "
                             f"{recovered2} of docs")
    if any(r["model_version"] != version for r in results2):
        raise AssertionError("an answer after the swap has an old version")
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")

    # -- 6. where the time goes: the same storm, warm and traced ------------
    args = serve_lda.build_argparser().parse_args(["--snapshot", "unused.npz"])
    model, engine = serve_lda.make_engine(args, snap2)
    try:
        engine.infer_many(docs2[:BATCH], timeout=300.0)      # warm
        engine.obs.tracer.clear()
        t0 = time.perf_counter()
        engine.infer_many(docs, timeout=300.0)
        traced_wall = time.perf_counter() - t0
    finally:
        engine.stop()
    spans = {}
    for ev in engine.obs.tracer.to_chrome()["traceEvents"]:
        if ev.get("ph") == "X":
            n, tot = spans.get(ev["name"], (0, 0.0))
            spans[ev["name"]] = (n + 1, tot + ev["dur"] / 1e3)
    emit("serve_traced", card=card, docs=len(docs), wall_s=traced_wall,
         spans={k: dict(count=n, total_ms=tot, mean_ms=tot / n)
                for k, (n, tot) in sorted(spans.items())})

    main_row = rows[-1]
    print(json.dumps({"kernels": [{
        "name": "fold_in_docs", "route": "cuda",
        "source": "src/repro_torch/kernels/fold_in/csrc/fold_in.cu",
        "replaces": "src/repro/kernels/fold_in/kernel.py:184",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
