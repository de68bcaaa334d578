"""Multi-device LDA on the PyTorch port: the paper's Fig. 9 experiment.

Trains the SAME corpus on one device and on N ranks (the paper's 1d
partition: documents over the ranks, phi replicated), then on a 2d
(N / 2) x 2 mesh (documents over the data axis, the vocabulary over the
model axis), printing time per iteration, the final likelihood and the
speed-up.  Each rank is a process (``distributed/launch.py::spawn``):
gloo ranks on the CPU, NCCL ranks on cards 0..N-1.

    PYTHONPATH=src python examples/torch_multi_device_lda.py     # every card
    PYTHONPATH=src python examples/torch_multi_device_lda.py \
        --device cpu --ranks 4
"""
import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _corpus_and_config():
    from repro_torch.core import trainer
    from repro_torch.data.synthetic import zipf_corpus

    corpus = zipf_corpus(num_docs=256, num_words=2000, avg_doc_len=120,
                         seed=0)
    cfg = trainer.LDAConfig(num_topics=64, tile_tokens=64, tiles_per_step=16)
    return corpus, cfg


def _summary(res, num_tokens: int) -> dict:
    return dict(ms_per_iter=1e3 * num_tokens / (sum(res.tokens_per_sec)
                                                / len(res.tokens_per_sec)),
                ll=res.ll_per_token[-1])


def _rank_work(rank: int, device_type: str, iters: int, out: str) -> None:
    """One rank: the 1d mesh over every rank, then the 2d mesh; rank 0
    writes both runs' summaries to ``out``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train import fit

    corpus, cfg = _corpus_and_config()
    n = dist.get_world_size()
    rows = {}
    mesh = init_device_mesh(device_type, (n,), mesh_dim_names=("data",))
    rows["1d"] = _summary(fit(corpus, cfg, iters, mesh, mode="1d",
                              doc_axes=("data",), word_axes=(),
                              eval_every=iters), corpus.num_tokens)
    md = max(1, n // 2)
    mesh2 = init_device_mesh(device_type, (md, n // md),
                             mesh_dim_names=("data", "model"))
    rows["2d"] = _summary(fit(corpus, cfg, iters, mesh2, mode="2d",
                              doc_axes=("data",), word_axes=("model",),
                              eval_every=iters), corpus.num_tokens)
    rows["2d"]["shape"] = [md, n // md]
    if rank == 0:
        Path(out).write_text(json.dumps(rows))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks; default: NCCL ranks on "
                         "the cards")
    ap.add_argument("--ranks", type=int, default=None,
                    help="N (default: 4 on the CPU, every card otherwise)")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.distributed.launch import spawn
    from repro_torch.train import fit

    dev = resolve_device(args.device)
    n = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                       else 4)
    corpus, cfg = _corpus_and_config()
    print(f"corpus: T={corpus.num_tokens:,}  K={cfg.num_topics}  "
          f"{n} rank(s) on {dev.type}")

    one = _summary(fit(corpus, cfg, args.iters, device=dev,
                       eval_every=args.iters), corpus.num_tokens)
    print(f"1 device:                  {one['ms_per_iter']:7.1f} ms/iter  "
          f"LL/token {one['ll']:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rows.json")
        spawn(_rank_work, n, args=(dev.type, args.iters, out),
              device_type=dev.type, store_dir=tmp)
        rows = json.loads(Path(out).read_text())
    print(f"1D partition, {n} rank(s):  {rows['1d']['ms_per_iter']:7.1f} "
          f"ms/iter  LL/token {rows['1d']['ll']:.4f}")
    shape = "x".join(map(str, rows["2d"]["shape"]))
    print(f"2D partition, {shape} mesh:    {rows['2d']['ms_per_iter']:7.1f} "
          f"ms/iter  LL/token {rows['2d']['ll']:.4f}")
    print(f"\nspeedup vs 1 device: x{n} 1d: "
          f"{one['ms_per_iter'] / rows['1d']['ms_per_iter']:.2f}, "
          f"{shape} 2d: {one['ms_per_iter'] / rows['2d']['ms_per_iter']:.2f}")
    return dict(one=one, **rows)


if __name__ == "__main__":
    main()
