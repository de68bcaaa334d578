"""The judge's control and planted faults, read at a cell's own size.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed: the cell's run as ``run.py`` makes it (its kind's
``run``, with ``control`` set), then the judge's readings (``judge.py``)
of

* ``sound``: the program's last step (a sound run: its readings set the
  limits' lower ends);
* ``control``: the reference itself put in the program's place, its
  sampling tables, draws and log-likelihood computed in bfloat16, the
  nearest precision below the configuration's float32 (the counts stay
  integers);
* the faults a training step can have, planted in the program's
  outputs: ``unchanged`` (the step returns its state), ``half`` (half of
  the tiles left out of the sweep), ``altered`` (one token's new topic
  moved by K / 2 where the sweep writes it), and over several ranks
  ``no_exchange`` (each rank keeps its own phi delta).

One JSON line a seed on standard output.  The benchmark's own runs do
not run this; ``portbench/tests/test_bench_control.py`` runs it small.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def faults(pb, out) -> dict:
    """{name: readings} of the control and each planted fault, for one
    rank's outputs ``out`` of the program's last step (``judge.Outputs``)
    on the problem ``pb``."""
    import torch

    from portbench import judge
    from portbench.reference import lda as ref

    dev = out.z.device
    doc_d = torch.from_numpy(pb.doc_ids).to(dev)
    word_d = torch.from_numpy(pb.word_ids).to(dev)
    _, tok, zp, zn, u = judge.canonical(pb, out, doc_d, word_d)
    T, V, K = doc_d.numel(), pb.num_words, pb.num_topics
    rows = out.doc_global
    zp_g = judge.global_topics(pb, tok, zp, T)
    phi_prev = ref.topic_word_counts(word_d, zp_g, V, K)
    rc, rt, _ = ref.ell(doc_d, zp_g, pb.num_docs, K)
    w_r, d_r = word_d[tok], doc_d[tok]
    lengths = torch.bincount(doc_d.long(), minlength=pb.num_docs)

    def ll(z_r, dtype):
        g = judge.global_topics(pb, tok, z_r, T)
        phi = ref.topic_word_counts(word_d, g, V, K)
        return float(ref.doc_log_likelihood(doc_d, g, lengths, K, pb.alpha,
                                            dtype)
                     + ref.word_log_likelihood(phi, phi.sum(0), pb.beta, V,
                                               dtype)) / T

    def read(z_r, ll_per_token, phi=None):
        if phi is None:
            phi = ref.topic_word_counts(
                word_d, judge.global_topics(pb, tok, z_r, T), V, K)
        return judge.judge(pb, doc_d, word_d, tok, zp, z_r, u, phi,
                           phi.sum(0), rc[rows.long()], rt[rows.long()],
                           rows, ll_per_token, 0)[0]

    found = {}
    tables = ref.WordTables(phi_prev, phi_prev.sum(0), pb.alpha, pb.beta, V,
                            dtype=torch.bfloat16)
    z_ctl, _ = ref.sample(tables, rc, rt, w_r, d_r, u)
    del tables
    found["control"] = read(z_ctl, ll(z_ctl, torch.bfloat16))
    found["unchanged"] = read(zp, ll(zp, torch.float32))
    mask = out.token_mask.bool()
    n = mask.shape[0]
    tile = torch.arange(n, device=mask.device)[:, None].expand_as(mask)[mask]
    first = tile[torch.argsort(out.token_uid[mask].long())] < n // 2
    half = torch.where(first, zn, zp)
    found["half"] = read(half, ll(half, torch.float32))
    gen = torch.Generator(device=zn.device)
    gen.manual_seed(pb.seed % (1 << 63))
    i = int(torch.randint(zn.numel(), (1,), generator=gen,
                          device=zn.device))
    altered = zn.clone()
    altered[i] = (altered[i] + K // 2) % K
    found["altered"] = read(altered, ll(altered, torch.float32))
    if pb.ranks > 1:
        own = (ref.topic_word_counts(w_r, zn, V, K)
               - ref.topic_word_counts(w_r, zp, V, K))
        found["no_exchange"] = read(zn, out.ll_per_token, phi_prev + own)
    return found


def run(spec: dict) -> dict:
    """One seed's readings: the sound run's, the control's and each
    fault's."""
    from portbench.kinds import lda_train

    r0 = lda_train.run(dict(spec, control=True))[0]
    return dict(seed=spec["seed"], iterations=r0["iterations"],
                sound=r0["readings"], **r0["control"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:] = [str(HERE.parent), str(HERE.parent / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]
    from portbench import run as bench

    files = bench.load_cell(bench.load_json(bench.ROOT / "BENCHMARK.json"),
                            args.workload)
    for seed in args.seeds:
        spec = dict(config=files["config"], traffic=files["traffic"],
                    seed=seed, seconds=args.seconds, trace=False,
                    device="cuda")
        print(json.dumps(dict(workload=args.workload, **run(spec))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
