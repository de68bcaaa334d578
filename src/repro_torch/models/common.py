"""Shared model substrate: configs, norms, RoPE, dense layers.

The port of ``repro.models.common``.  Parameters are plain ``NamedTuple``
trees of tensors and every layer is a function ``f(params, x, ...) -> y``.
The reference's ``ShardingPolicy`` has no counterpart here: its GSPMD
constraints mean nothing to one eager device, so no function takes a
policy.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint


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


def tree_stack(trees):
    """Stack equal-shaped trees along a new leading axis (per-slot layers
    into the ``(num_blocks, ...)`` layout)."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])
