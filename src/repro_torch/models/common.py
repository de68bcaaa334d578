"""Shared model substrate: configs, norms, RoPE, dense layers, sharding
policy.

The port of ``repro.models.common``.  Parameters are plain ``NamedTuple``
trees of tensors and every layer is a function ``f(params, x, ...) -> y``.

``ShardingPolicy`` says how the model maps onto a ``("data", "model")``
``DeviceMesh`` (optionally with a leading ``"pod"`` axis), with the
reference's fields and canonical specs.  A spec is a ``P``: the
reference's ``PartitionSpec`` written as data, one entry per dim (``None``,
a mesh axis name, or a tuple of names).  The reference hands its specs to
GSPMD, which places each tensor and propagates the collectives; here a
rank holds the local shard its spec gives it, and the layers run
Megatron-style on those shards with the explicit collectives of
``models/parallel.py``.  ``NO_SHARDING`` (the default of every layer) is
one device: no spec is read and no collective runs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint


# ---------------------------------------------------------------------------
# Sharding policy
# ---------------------------------------------------------------------------

def _entry(e):
    """One spec entry as JAX keeps it: a one-name tuple is the name, an
    empty one None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec as data: one entry per dim of the tensor, each
    ``None`` (replicated), a mesh axis name or a tuple of names (sharded
    over their product, the first name major).  ``P()`` replicates a
    tensor of any rank.  Equal, entry for entry, to the reference's
    ``PartitionSpec`` of the same dims."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def entry_axes(e) -> tuple[str, ...]:
    """The mesh axes a spec entry shards its dim over, major first."""
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (a ``DeviceMesh`` or any object
    with ``mesh_dim_names`` and ``size(dim)``)."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(name)))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """How the model maps onto the mesh.

    dp: data-parallel axes (batch; also the FSDP shard axis for params/opt).
    tp: tensor-parallel axis (heads / FFN hidden / vocab / experts).
    fsdp: shard params & optimizer over dp too (ZeRO-3 style).
    sp: the reference keeps the saved residual stream sequence-sharded over
        tp between layers.  Carried for parity with the reference's policy
        (``act`` reads it) and read by no layer of the port: the port keeps
        the residual replicated over tp whatever it says (the same values;
        sequence parallelism is ROADMAP item 13g).
    mesh: the ``DeviceMesh``.  ``weight_gather``: gather FSDP weights
        before their matmuls (train and prefill).  The reference turns it
        off for decode, where a token's activations are KBs and the
        weights GBs: the decode layers then keep each FSDP weight sharded
        and move the activations instead (``parallel.dp_dense``).
    """

    dp: tuple[str, ...] = ()
    tp: str | None = None
    fsdp: bool = True
    sp: bool = True
    enabled: bool = False
    mesh: Any = None
    weight_gather: bool = True

    # canonical specs -------------------------------------------------------
    def batch(self) -> Any:
        return tuple(self.dp) if self.dp else None

    def act(self, seq_shard: bool = False) -> P:
        """[B, S, D] activations."""
        if seq_shard and self.sp and self.tp:
            return P(self.batch(), self.tp, None)
        return P(self.batch(), None, None)

    def heads(self) -> P:
        """[B, S, H, hd]."""
        return P(self.batch(), None, self.tp, None)

    def ffn(self) -> P:
        """[B, S, F]."""
        return P(self.batch(), None, self.tp)

    def vocab_logits(self) -> P:
        """[B, S, V]."""
        return P(self.batch(), None, self.tp)

    # param specs -----------------------------------------------------------
    def p_embed(self) -> P:          # (V, D)
        return P(self.tp, self._fs())

    def p_attn_qkv(self) -> P:       # (D, H, hd)
        return P(self._fs(), self.tp, None)

    def p_attn_o(self) -> P:         # (H, hd, D)
        return P(self.tp, None, self._fs())

    def p_mlp_in(self) -> P:         # (D, F)
        return P(self._fs(), self.tp)

    def p_mlp_out(self) -> P:        # (F, D)
        return P(self.tp, self._fs())

    def p_moe_in(self) -> P:         # (E, D, F)
        return P(self.tp, self._fs(), None)

    def p_moe_out(self) -> P:        # (E, F, D)
        return P(self.tp, None, self._fs())

    def p_vec(self) -> P:            # (D,) norms etc.
        return P(None)

    def _fs(self):
        return tuple(self.dp) if (self.fsdp and self.dp) else None

    # conditional TP: shard a dimension over tp only when divisible ---------
    def tp_size(self) -> int:
        if not (self.tp and self.mesh is not None):
            return 1
        return axis_size(self.mesh, self.tp)

    def shard_if(self, n: int):
        """tp axis name if n divides over it, else None (replicate)."""
        return self.tp if (self.tp and n % max(self.tp_size(), 1) == 0
                           and n >= self.tp_size()) else None

    @functools.cached_property
    def ctx(self):
        """This rank's ``parallel.MeshContext`` (its coordinates and the
        process group of each mesh axis), made on first use."""
        from .parallel import MeshContext
        return MeshContext(self.mesh, self.tp, self.dp)

    def gather_fsdp(self, w: torch.Tensor, spec: P, stored: P) -> torch.Tensor:
        """This rank's shard ``w`` (laid out as ``stored``) materialized as
        ``spec`` before its matmul: the FSDP (dp) shards all-gathered, and
        any other difference between the layouts resolved
        (``parallel.reshard``).  The backward reduce-scatters the weight's
        gradient over dp: the reference's ZeRO-3 flow.  The reference
        gathers only the weights GSPMD would otherwise partial-sum; the
        port holds local shards, so every dp-sharded weight is gathered
        before its use.  ``w`` unchanged without a mesh.  The decode
        layers (``weight_gather`` off) never call it: they contract with
        the dp shard where it lies (``parallel.dp_dense``)."""
        if not self.enabled:
            return w
        from .parallel import reshard
        return reshard(w, stored, spec, self.ctx)


NO_SHARDING = ShardingPolicy()


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One member of the repeating block pattern."""

    kind: str                 # "global" | "local" | "rglru" | "ssd"
    window: int | None = None # sliding window for "local"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int | None = None
    d_ff: int = 1024
    vocab_size: int = 1024
    pattern: tuple[LayerSpec, ...] = (LayerSpec("global"),)
    rope_theta: float = 10_000.0
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen1.5
    attn_softcap: float | None = None   # gemma2 (50.0)
    logit_softcap: float | None = None  # gemma2 (30.0)
    rms_offset: bool = False       # gemma-style (1+w) RMSNorm
    tie_embeddings: bool = True
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / recurrent
    ssm_state: int = 0             # mamba2 N
    ssm_head_dim: int = 64         # mamba2 P
    ssm_chunk: int = 64
    rglru_width: int = 0           # recurrentgemma recurrence width
    conv1d_width: int = 4
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 0        # stubbed conv frontend output length
    # vlm
    vision_tokens: int = 0         # stubbed ViT patch embedding count
    # layers not covered by the repeating pattern (e.g. recurrentgemma's
    # trailing 2 recurrent layers: 26 = 8x(R,R,A) + (R,R))
    tail: tuple[LayerSpec, ...] = ()
    # numerics
    dtype: torch.dtype = torch.bfloat16
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def num_blocks(self) -> int:
        n = len(self.pattern)
        body = self.num_layers - len(self.tail)
        assert body % n == 0, (self.num_layers, n, len(self.tail))
        return body // n


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float,
             offset: bool) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if offset else w.float()
    return (y * scale).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x: [..., S, H, hd]; positions:
    [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                 # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def padded_vocab(v: int) -> int:
    """The reference's padded vocabulary (a multiple of 2048 from 10,000
    words, else of 16); padded logit slots are masked to -1e9 in
    ``lm_logits``."""
    m = 2048 if v >= 10_000 else 16
    return -(-v // m) * m


def scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """``c`` as a 0-d tensor of ``x``'s dtype: JAX rounds a Python scalar
    to the array's dtype before it multiplies (weak typing), torch keeps
    it in double, so a bf16 ``x * c`` differs without this."""
    return torch.tensor(c, dtype=x.dtype, device=x.device)


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...d,df->...f", x, w.to(x.dtype))


def init_dense(shape, scale=None, dtype=torch.bfloat16, *,
               generator: torch.Generator) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 on the generator's device, cast to
    ``dtype`` (scale defaults to fan_in ** -0.5)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale).to(dtype)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a tree of NamedTuples and tuples (and the
    matching leaves of ``rest``); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def spec_map(fn, specs):
    """``fn`` over the ``P`` leaves of a spec tree (``None`` stays)."""
    if specs is None:
        return None
    if isinstance(specs, P):
        return fn(specs)
    out = [spec_map(fn, s) for s in specs]
    return type(specs)(*out) if hasattr(specs, "_fields") else tuple(out)


def map_with_specs(fn, tree, specs):
    """``fn(tensor, spec)`` over the tensors of ``tree`` and the ``P`` at
    the same place in ``specs`` (a spec tree of the same structure; a spec
    where the tree has ``None`` is skipped)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        if not isinstance(specs, P):
            raise ValueError(f"no spec for a tensor of shape "
                             f"{tuple(tree.shape)}: {specs!r}")
        return fn(tree, specs)
    out = [map_with_specs(fn, t, s) for t, s in zip(tree, specs)]
    return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)


def spec_leaves(tree, specs) -> list:
    """The spec of each tensor of ``tree``, in ``tree_leaves`` order."""
    out: list = []
    map_with_specs(lambda t, s: out.append(s), tree, specs)
    return out


def tree_leaves(tree) -> list:
    """The tensors of a tree of NamedTuples and tuples in field order
    (``None`` leaves skipped), as ``jax.tree.leaves`` orders them."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in tree_leaves(sub)]


def tree_unstack(tree, n: int) -> list:
    """The ``n`` per-block views of a stacked tree, from one ``unbind(0)``
    per leaf: its backward is one ``stack`` a leaf, where indexing block by
    block (``a[b]``) would build a zero gradient of the whole stacked leaf
    for every block."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda _, p, b=b: p[b], tree, parts) for b in range(n)]


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward instead of keeping its
    activations when autograd is recording (the reference's
    ``jax.checkpoint``); a plain call otherwise (prefill, decode)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def stack_blocks(make, n: int):
    """``make(0)``, ..., ``make(n - 1)`` (equal-shaped trees, made in that
    order) stacked along a new leading axis (per-slot layers into the
    ``(num_blocks, ...)`` layout).  Each tree is copied into the stacked
    leaves as it is made and then dropped, so the ``n`` trees and their
    stack are never alive together."""
    first = make(0)
    out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    for b in range(n):
        tree = first if b == 0 else make(b)
        for dst, src in zip(tree_leaves(out), tree_leaves(tree)):
            dst[b].copy_(src)
        first = tree = None
    return out
