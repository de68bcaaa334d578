"""Meshes of H100 cards, and the hardware constants of the roofline.

The port of ``repro.launch.mesh``.  No device or process-group state is
touched at import: meshes are built by functions, over the ranks of the
default process group (``torch.distributed.init_process_group`` first,
one rank a card; gloo ranks make CPU meshes, NCCL ranks card meshes, and
the dry run's fake group CPU meshes of any size).
The reference's production target is a TPU v5e pod of 16 x 16 = 256
chips ("data" x "model"), with a leading "pod" axis for two pods (512
chips); here the card count is a parameter.
"""
from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense rates, 700 W): the roofline's
# denominators, the ones chip_smoke.py uses, and the card's memory, which
# the dry run's fit is held against.
PEAK_FLOPS_BF16 = 989e12       # per card, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12         # per card, float32 outside the tensor cores
HBM_BW = 3.35e12               # bytes/s per card
HBM_BYTES = 80e9               # per card

# one host's NVLink domain: tensor parallelism stays inside it
HOST_CARDS = 8

# The collective bandwidths ``roofline.analyze_cell`` divides each mesh
# axis's bytes by.  Data-sheet figures: no run of this repository has timed
# a collective against either.
NVLINK_BW = 900e9              # bytes/s a card, NVLink 4, inside one host
NETWORK_BW = 50e9              # bytes/s a card, 400 Gb/s NDR, between hosts


def axis_bandwidth(axis: str, cards: int, width: int | None = None) -> float:
    """The bandwidth a card's collectives over mesh ``axis`` get on a mesh
    of ``cards``.  Any axis of a mesh that fits one host gets NVLink.
    Across hosts, the "model" axis (the minor one: its ranks are
    consecutive) gets NVLink while its ``width`` fits one host's
    ``HOST_CARDS`` (``make_production_mesh`` keeps it so by default;
    ``None`` is such a width), and the network beyond: a 16-wide model
    axis spans two 8-card NVLink hosts, and unless an NVLink switch joins
    them, which this module has no figure for, its collectives cross the
    network.  "data" and "pod" cross the network."""
    if cards <= HOST_CARDS:
        return NVLINK_BW
    if axis == "model" and (width is None or width <= HOST_CARDS):
        return NVLINK_BW
    return NETWORK_BW


def _init(shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    # gloo ranks and the dry run's fake group make CPU meshes
    kind = "cpu" if dist.get_backend() in ("gloo", "fake") else "cuda"
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_production_mesh(chips: int, pods: int = 1,
                         model: int | None = None):
    """A ("data", "model") ``DeviceMesh`` of ``chips`` cards a pod, with a
    leading "pod" axis when ``pods`` > 1: the model axis is ``model``
    wide, by default ``min(chips, HOST_CARDS)``, so that tensor
    parallelism runs over NVLink (the reference's own pod is (16, 16):
    ``model=16``).  The default group must hold ``pods * chips`` ranks."""
    model = min(chips, HOST_CARDS) if model is None else model
    if chips % model:
        raise ValueError(f"{chips} cards do not split into model groups of "
                         f"{model}")
    shape, names = (chips // model, model), ("data", "model")
    if pods > 1:
        shape, names = (pods,) + shape, ("pod",) + names
    return _init(shape, names)


def make_host_mesh(n: int | None = None, name: str = "data"):
    """Every rank of the default group on one axis (``n``, when given,
    must be the group's size)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a host mesh of {n} ranks in a group of {world}")
    return _init((world,), (name,))
