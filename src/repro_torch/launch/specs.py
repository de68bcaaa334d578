"""Input specs and the mesh train step of every (arch x shape x mesh) cell.

The port of ``repro.launch.specs``.  ``input_specs(arch, shape)`` gives
every model input as a ``device="meta"`` tensor of the reference's shape
and dtype (int32 tokens and labels, bf16 stubbed frames and patches): no
memory anywhere.  ``make_policy`` is the reference's rule: batch over the
dp axes (every axis but "model") when it divides them, tp over "model",
FSDP params and optimizer over dp.

``build_cell(arch, "train_4k", mesh)`` (``train_cell`` of any config,
batch and sequence) returns the mesh train step
(``zoo.make_train_step`` under the policy, the reference's gradient
accumulation of ``TRAIN_MICRO``) and its arguments as meta tensors: this
rank's shards of the ``TrainState`` and its rows of the batch, the step's
own inputs (the reference's ``Cell`` holds global ShapeDtypeStructs and
the shardings its jit places them with).  Prefill and decode cells raise:
the reference builds them only for its dry run, and the port runs neither
over a mesh yet (ROADMAP item 13f, with the context-parallel cache specs
of ``long_500k``).  MoE train cells run their layers expert-parallel over
"model" (``moe.moe_ffn_ep``), as the reference's do.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.archs import ARCHS, SHAPES
from repro_torch.models import transformer as tf
from repro_torch.models import zoo
from repro_torch.models.common import (ModelConfig, ShardingPolicy,
                                       axis_size, tree_map)
from repro_torch.models.parallel import shard_tree
from repro_torch.optim import adamw

# gradient-accumulation factor per arch for train_4k (activation fit)
TRAIN_MICRO = {
    "qwen1.5-110b": 16,
    "gemma3-27b": 8,
    "gemma2-27b": 2,
    "recurrentgemma-2b": 2,
    "qwen3-moe-235b-a22b": 4,
    "whisper-large-v3": 4,
}


def make_policy(mesh, batch: int, kind: str = "train") -> ShardingPolicy:
    dp_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    dp_size = 1
    for a in dp_axes:
        dp_size *= axis_size(mesh, a)
    dp = dp_axes if batch % dp_size == 0 and batch >= dp_size else ()
    return ShardingPolicy(dp=dp, tp="model", fsdp=True, sp=True,
                          enabled=True, mesh=mesh,
                          weight_gather=(kind != "decode"))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def model_inputs(cfg: ModelConfig, B: int, S: int,
                 kind: str = "train") -> dict[str, torch.Tensor]:
    """A batch of ``B`` sequences of ``S`` tokens (one token to decode) as
    meta tensors: tokens and labels, and the stubbed frontends' inputs."""
    if kind == "decode":
        out = {"token": _meta((B, 1), torch.int32)}
    else:
        out = {"tokens": _meta((B, S), torch.int32),
               "labels": _meta((B, S), torch.int32)}
    if cfg.encoder_layers:
        out["frames"] = _meta((B, cfg.encoder_frames, cfg.d_model),
                              torch.bfloat16)
    if cfg.vision_tokens:
        out["patches"] = _meta((B, cfg.vision_tokens, cfg.d_model),
                               torch.bfloat16)
    return out


def input_specs(arch: str, shape: str) -> dict[str, torch.Tensor]:
    """Model inputs as meta tensors (tokens/labels + stub frontends)."""
    sh = SHAPES[shape]
    return model_inputs(ARCHS[arch], sh["global_batch"], sh["seq_len"],
                        sh["kind"])


class Cell(NamedTuple):
    """Everything needed to run one (arch x shape x mesh) combination."""

    fn: Any                 # the mesh step function
    args: tuple             # its arguments, meta tensors of this rank
    cfg: ModelConfig
    policy: ShardingPolicy
    kind: str
    micro_batches: int = 1  # the step's gradient accumulation


def meta_params(cfg: ModelConfig) -> tf.ModelParams:
    """``init_params``' tree as meta tensors of the same shapes and dtypes
    (traced under a fake-tensor mode: nothing is allocated or drawn)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = tf.init_params(cfg, torch.Generator())
    return tree_map(lambda a: _meta(a.shape, a.dtype), fake)


def train_cell(cfg: ModelConfig, B: int, S: int, mesh,
               micro_batches: int = 1) -> Cell:
    """The mesh train step of ``cfg`` on a global batch of ``B`` x ``S``
    tokens, as the rank at ``mesh.get_coordinate()``: its shards of the
    state and its rows of the batch as meta tensors.  A rank holding fewer
    rows than ``micro_batches`` accumulates over as many micro-batches as
    divide its rows (``TRAIN_MICRO`` counts the micro-batches of the
    reference's 16-wide data axis, one row each)."""
    policy = make_policy(mesh, B)
    names = tuple(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate()))
    size = {a: axis_size(mesh, a) for a in names}
    specs = tf.param_specs(cfg, policy)
    params = shard_tree(meta_params(cfg), specs, coord, size)
    f32 = lambda tree: tree_map(  # noqa: E731
        lambda a: _meta(a.shape, torch.float32), tree)
    state = zoo.TrainState(params, adamw.OptState(
        master=f32(params), m=f32(params), v=f32(params),
        step=_meta((), torch.int32)))
    rows = B // math.prod(size[a] for a in policy.dp)
    batch = {k: _meta((rows,) + tuple(v.shape[1:]), v.dtype)
             for k, v in model_inputs(cfg, B, S).items()}
    micro = math.gcd(micro_batches, rows)
    step = zoo.make_train_step(cfg, policy=policy, micro_batches=micro)
    return Cell(step, (state, batch), cfg, policy, "train", micro)


def build_cell(arch: str, shape: str, mesh) -> Cell:
    sh = SHAPES[shape]
    if sh["kind"] != "train":
        raise NotImplementedError(f"{arch} x {shape}: {tf.MESH_DECODE}")
    return train_cell(ARCHS[arch], sh["global_batch"], sh["seq_len"], mesh,
                      TRAIN_MICRO.get(arch, 1))
