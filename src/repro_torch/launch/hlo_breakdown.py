"""Per-collective breakdown of one cell's probe: every collective of a
traced train step at ``blocks`` blocks, with its op, mesh axis, dtype and
shape, its result bytes and the port's source frame (file:line under
``models/``; a collective of the backward names the frame that ran the
backward), sorted by bytes, with the totals by op.

The port of ``repro.launch.hlo_breakdown``.  It reads the dry run's
dispatch trace of fake tensors (``launch/dryrun.py``) on a fake process
group of ``chips`` ranks, not HLO: the reference's HLO-text parser
(``dryrun.collective_bytes`` over ``compiled.as_text()``) has no
counterpart here.

    PYTHONPATH=src python -m repro_torch.launch.hlo_breakdown qwen3-moe-30b-a3b train_4k [blocks] [chips]
"""
from __future__ import annotations

import sys
from collections import defaultdict

from repro_torch.configs.archs import ARCHS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import MESH_DECODE


def breakdown(arch: str, shape: str, blocks: int = 2,
              chips: int = 256) -> list[tuple]:
    """(bytes, op, axis, dtype[shape], source) of every collective of one
    step, largest first; also printed."""
    sh = SHAPES[shape]
    if sh["kind"] != "train":
        raise NotImplementedError(f"{arch} x {shape}: {MESH_DECODE}")
    cfg = dryrun.at_depth(ARCHS[arch], blocks)
    with dryrun.fake_group(chips):
        mesh = make_production_mesh(chips)
        cell = specs_lib.train_cell(cfg, sh["global_batch"], sh["seq_len"],
                                    mesh, specs_lib.TRAIN_MICRO.get(arch, 1))
        res = dryrun.trace_step(cell, mesh, cell.micro_batches)
    rows = sorted(((c["bytes"], c["op"], c["axis"],
                    f"{c['dtype']}{c['shape']}",
                    c["source"] + (" (backward)" if c["backward"] else ""))
                   for c in res["collectives"]), reverse=True)
    total = sum(r[0] for r in rows)
    print(f"{arch} x {shape} ({blocks}-block probe, {chips} cards): "
          f"{len(rows)} collectives, {total / 2**30:.2f} GiB result bytes\n")
    by_op = defaultdict(int)
    for b, op, *_ in rows:
        by_op[op] += b
    for op, b in sorted(by_op.items(), key=lambda kv: -kv[1]):
        print(f"  {op:20s} {b / 2**30:8.3f} GiB")
    print("\ntop 25:")
    for b, op, axis, shp, src in rows[:25]:
        print(f"  {b / 2**20:9.1f} MiB  {op:15s} {axis:6s} {shp:28s} {src}")
    return rows


if __name__ == "__main__":
    breakdown(sys.argv[1], sys.argv[2],
              int(sys.argv[3]) if len(sys.argv) > 3 else 2,
              int(sys.argv[4]) if len(sys.argv) > 4 else 256)
