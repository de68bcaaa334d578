"""Process groups for multi-device training: ranks from ``torchrun``'s
environment, or N ranks spawned on one host, and the training mesh.

One process per rank.  NCCL serves ranks on cards, gloo ranks on the CPU;
nothing switches from one to the other.  Every group is destroyed when its
rank's work ends.
"""
from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def training_mesh(device_type: str, mode: str):
    """The mesh of ``repro.launch.train`` over every rank of the default
    group: ("data",) in 1d; ("data", "model") of shape (n // 2, 2) in 2d
    (one data row when n < 2): the reference's ``(n // 2, min(n, 2))`` of
    the LDA and the LM workloads alike."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if mode == "1d":
        return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))
    md = max(1, n // 2)
    return init_device_mesh(device_type, (md, n // md),
                            mesh_dim_names=("data", "model"))


def init_from_env(device_type: str, init_method: str = "env://") -> None:
    """Join the default group as ``torchrun`` describes this process
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR`` and
    ``MASTER_PORT`` for ``env://``, or a shared ``file://`` store).
    A cuda rank takes card ``LOCAL_RANK``."""
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(device_type), init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def _rank_main(rank, fn, world, init_method, device_type, args,
               timeout_s=None):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:       # the host's cores shared out, not each rank taking them all
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend_for(device_type), init_method=init_method,
                            rank=rank, world_size=world, **kw)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), device_type: str = "cpu",
          store_dir: str | None = None,
          timeout_s: float | None = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes, each a rank
    of a new default group (gloo on ``cpu``, NCCL on ``cuda``, rank r on
    card r) met through a ``file://`` store in a fresh directory under
    ``store_dir``.  ``fn`` must be importable by name.  ``timeout_s``
    bounds how long a collective waits for the other ranks (torch's
    default otherwise).  Raises if a rank fails; returns when every rank
    has ended."""
    import torch.multiprocessing as mp

    if device_type == "cuda" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"{nprocs} ranks on cuda need {nprocs} cards; "
                           f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_main, nprocs=nprocs, join=True,
                           start_method="spawn",
                           args=(fn, nprocs, store, device_type, tuple(args),
                                 timeout_s))
