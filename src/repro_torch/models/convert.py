"""Weights, train states and decode states across the package boundary,
as numpy.

The reference's pytrees reach the port as flat ``dict[str, np.ndarray]``s
keyed by their dotted paths (``blocks.0.mixer.wq``, ``tail.1.mixer.conv_w``,
``layer_states.0.pos``, ``opt.master.embed``; ``None`` leaves have no key),
as ``jax.tree_util.tree_flatten_with_path`` names them.  The port never
sees a JAX type.  ``flatten`` gives the port's trees the same keys, so two
trees compare key by key.

Over a mesh, ``shard_params`` and ``shard_train_state`` take a rank's
shards of whole trees (laid out by ``transformer.param_specs``), and
``gather_params`` / ``gather_train_state`` all-gather a rank's shards back
into whole trees, so a mesh run compares with the reference's one-device
run tree by tree.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..optim import adamw
from . import attention as attn_lib
from . import moe as moe_lib
from . import recurrent as rec_lib
from . import transformer as tf
from . import parallel, zoo
from .common import LayerSpec, ModelConfig, P


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``.  bf16 arrives as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: its bits go
    across as uint16."""
    a = np.array(a, order="C")          # a writable copy; keeps 0-d shapes
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _nest(arrays: dict, device) -> dict:
    root: dict = {}
    for key, a in arrays.items():
        *path, leaf = key.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = to_tensor(a, device)
    return root


def _build(cls, d: dict | None):
    """``cls`` from the dict of its fields (absent fields are None)."""
    if d is None:
        return None
    unknown = set(d) - set(cls._fields)
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**{f: d.get(f) for f in cls._fields})


_MIXER = {"global": attn_lib.AttnParams, "local": attn_lib.AttnParams,
          "rglru": rec_lib.RGLRUParams, "ssd": rec_lib.SSDParams}
_STATE = {"global": attn_lib.KVCache, "local": attn_lib.KVCache,
          "rglru": rec_lib.RGLRUState, "ssd": rec_lib.SSDState}


def _seq(d: dict | None, n: int) -> list:
    return [None if d is None else d.get(str(i)) for i in range(n)]


def _layer(cfg: ModelConfig, spec: LayerSpec, d: dict) -> tf.LayerParams:
    ffn = moe_lib.MoEParams if cfg.is_moe else tf.MLPParams
    return tf.LayerParams(
        norm1=d["norm1"], mixer=_build(_MIXER[spec.kind], d["mixer"]),
        norm2=d["norm2"], ffn=_build(ffn, d.get("ffn")),
        cross=_build(attn_lib.AttnParams, d.get("cross")),
        norm_c=d.get("norm_c"))


def params_from_numpy(cfg: ModelConfig, arrays: dict,
                      device=None) -> tf.ModelParams:
    """``transformer.ModelParams`` from the reference's flattened params,
    on ``device`` (``cuda:0`` by default)."""
    t = _nest(arrays, resolve_device(device))
    blocks = tuple(_layer(cfg, spec, d) for spec, d in
                   zip(cfg.pattern, _seq(t["blocks"], len(cfg.pattern))))
    encoder = None
    if "encoder" in t:
        encoder = (_layer(cfg, LayerSpec("global"), t["encoder"]["0"]),
                   t["encoder"]["1"])
    tail = None
    if cfg.tail:
        tail = tuple(_layer(cfg, spec, d) for spec, d in
                     zip(cfg.tail, _seq(t["tail"], len(cfg.tail))))
    return tf.ModelParams(embed=t["embed"], blocks=blocks,
                          final_norm=t["final_norm"],
                          unembed=t.get("unembed"), encoder=encoder,
                          enc_proj=t.get("enc_proj"), tail=tail)


def decode_state_from_numpy(cfg: ModelConfig, arrays: dict,
                            device=None) -> zoo.DecodeState:
    """``zoo.DecodeState`` from the reference's flattened decode state, on
    ``device`` (``cuda:0`` by default)."""
    t = _nest(arrays, resolve_device(device))
    states = tuple(_build(_STATE[spec.kind], d) for spec, d in
                   zip(cfg.pattern, _seq(t["layer_states"],
                                         len(cfg.pattern))))
    cross_kv = None
    if "cross_kv" in t:
        cross_kv = tuple(_seq(t["cross_kv"], 2 * len(cfg.pattern)))
    tails = None
    if cfg.tail:
        tails = tuple(_build(_STATE[spec.kind], d) for spec, d in
                      zip(cfg.tail, _seq(t["tail_states"], len(cfg.tail))))
    return zoo.DecodeState(layer_states=states, position=t["position"],
                           cross_kv=cross_kv, tail_states=tails)


def train_state_from_numpy(cfg: ModelConfig, arrays: dict,
                           device=None) -> zoo.TrainState:
    """``zoo.TrainState`` from the reference's flattened train state
    (``params.*``, ``opt.master.*``, ``opt.m.*``, ``opt.v.*``,
    ``opt.step``), on ``device`` (``cuda:0`` by default)."""
    dev = resolve_device(device)

    def tree(prefix: str) -> tf.ModelParams:
        n = len(prefix)
        return params_from_numpy(cfg, {k[n:]: a for k, a in arrays.items()
                                       if k.startswith(prefix)}, dev)

    return zoo.TrainState(
        params=tree("params."),
        opt=adamw.OptState(master=tree("opt.master."), m=tree("opt.m."),
                           v=tree("opt.v."),
                           step=to_tensor(arrays["opt.step"], dev)))


def flatten(tree, prefix: str = "") -> dict:
    """{dotted path: tensor} of a tree of NamedTuples and tuples (or
    {dotted path: P} of a spec tree), with the reference's keys (``None``
    leaves left out)."""
    if tree is None:
        return {}
    if isinstance(tree, (torch.Tensor, P)):
        return {prefix: tree}
    names = tree._fields if hasattr(tree, "_fields") else range(len(tree))
    out = {}
    for name, sub in zip(names, tree):
        out.update(flatten(sub, f"{prefix}.{name}" if prefix else str(name)))
    return out


def shard_params(params, specs, mesh, rank: int):
    """Rank ``rank``'s shards of the whole params (or any tree laid out by
    ``specs``) on ``mesh``: copies, so the whole tree can be freed."""
    return parallel.shard_tree(params, specs,
                               *parallel.mesh_coords(mesh, rank))


def gather_params(params, specs, mesh):
    """The whole tree of this rank's shards ``params`` (collective: every
    rank of ``mesh`` calls it, and every rank gets the whole tree)."""
    return parallel.gather_tree(params, specs, parallel.MeshContext(mesh))


def shard_train_state(state: zoo.TrainState, specs, mesh,
                      rank: int) -> zoo.TrainState:
    """Rank ``rank``'s shards of a whole ``TrainState``: params, master, m
    and v laid out by the param ``specs``, the step replicated."""
    opt = state.opt
    return zoo.TrainState(
        shard_params(state.params, specs, mesh, rank),
        adamw.OptState(*(shard_params(t, specs, mesh, rank)
                         for t in (opt.master, opt.m, opt.v)),
                       step=opt.step.clone()))


def gather_train_state(state: zoo.TrainState, specs,
                       mesh) -> zoo.TrainState:
    """The whole ``TrainState`` of this rank's shards (collective)."""
    opt = state.opt
    return zoo.TrainState(
        gather_params(state.params, specs, mesh),
        adamw.OptState(*(gather_params(t, specs, mesh)
                         for t in (opt.master, opt.m, opt.v)),
                       step=opt.step.clone()))
