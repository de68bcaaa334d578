"""Recurrent token mixers: RG-LRU (recurrentgemma) and Mamba2 SSD.

The port of ``repro.models.recurrent``.  Torch has no
``lax.associative_scan``: ``_assoc_scan`` is a Hillis-Steele prefix over
the sequence (log2 S rounds of whole-tensor ops), ``_lru_scan`` runs it
inside ``LRU_CHUNK`` chunks with a sequential carry between them, and the
SSD's inter-chunk recurrence is a loop over the chunks.  Decode is the
O(1)-state step (S = 1) and never reaches a scan.

RG-LRU (arXiv:2402.19427 §2.3):
    r_t = sigmoid(W_a x_t + b_a);  i_t = sigmoid(W_x x_t + b_x)
    a_t = a^(c*r_t)  with  a = sigmoid(Lambda),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Mamba2 SSD (arXiv:2405.21060), head-parallel scalar-decay SSM:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t ⊗ x_t        (N x P per head)
    y_t = C_t · h_t + D * x_t
evaluated chunkwise: an intra-chunk quadratic term plus the inter-chunk
state carry.

Under a ``ShardingPolicy`` (training over a mesh) the params are laid out
as ``param_specs`` says.  RG-LRU is diagonal in its R channels, so it runs
channel-parallel over tp: column-parallel ``w_in``, the conv, gates and
scan on this rank's channels, row-parallel ``w_out`` all-reduced (under
sequence parallelism, ``policy.seq``: the input all-gathered and the
output reduce-scattered along S, as every mixer of the port).

SSD is split over tp by ``ssd_layout``, the reference's ``shard_if`` of
its state (``ssd_plan`` says what each rank computes):

* heads (``H`` divides): this rank's heads of ``w_x``, ``w_dt`` and the
  per-head vectors, state (B, H / tp, P, N).  ``w_B`` and ``w_C`` (``N``
  columns, shared by every head) are all-gathered over tp and ``B``,
  ``C`` computed whole on every rank, so ``C . B`` needs no all-reduce.
* state (``H`` does not divide, ``N`` does): the core is linear in its
  ``N`` columns (``C . B``, the chunk states and ``C . h`` each sum over
  ``N`` or keep them apart), so each rank runs it on every head and its
  ``N / tp`` columns of ``w_B`` / ``w_C``, state (B, H, P, N / tp), and
  its partial ``y`` is reduce-scattered over tp along the ``H * P``
  channels (``parallel.tp_scatter_sum``; all-reduced where they do not
  divide).  ``w_x`` is all-gathered (the core reads every head).
* replicated (neither divides): the core whole on every rank, state
  (B, H, P, N), and this rank's channels of its ``y`` kept.

In each, where ``H * P`` divides over tp, the tail (the skip term
``D * x``, added once after the sum, the gate on this rank's ``w_z``
columns, the gated RMSNorm, whose sum of squares is all-reduced over tp,
and the row-parallel ``w_out``) runs on this rank's ``H * P / tp``
channels, which need not start at a head; else it runs whole.  Where a
rank computes a share, every input of that share replicated over tp (the
core's ``w_dt``, ``log_a``, ``dt_bias``, and ``w_B`` / ``w_C`` / ``w_x``
where their columns are not sharded; the channel tail's ``d_skip``)
enters by ``parallel.copy_in``, so that its gradient is summed over tp.

Decode over a mesh (a policy without ``weight_gather``) runs the same
split on this rank's shard of the state: the RG-LRU's ``h`` and ``conv``
on its channels, the SSD's ``h`` on its heads, its ``N`` columns or
whole.  The FSDP weights stay sharded (``parallel.dp_dense``): ``x``'s
projections come out in the weights' stored columns, and where the core
needs more (``B`` and ``C`` in the heads layout, ``x``'s channels in the
others) they are all-gathered over tp as activations.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import parallel
from .common import (NO_SHARDING, P, ModelConfig, ShardingPolicy, entry_axes,
                     init_dense, rms_norm)

RGLRU_C = 8.0
LRU_CHUNK = 512


# ---------------------------------------------------------------------------
# RG-LRU block (recurrentgemma): conv1d + gated linear recurrence
# ---------------------------------------------------------------------------

class RGLRUParams(NamedTuple):
    w_in: torch.Tensor        # (D, R)  input projection (to recurrence width)
    w_gate_a: torch.Tensor    # (R,) -> recurrence gate (diagonal, per channel)
    b_gate_a: torch.Tensor
    w_gate_x: torch.Tensor    # (R,)
    b_gate_x: torch.Tensor
    log_lambda: torch.Tensor  # (R,) recurrence decay parameter
    conv_w: torch.Tensor      # (W, R) depthwise causal conv
    conv_b: torch.Tensor      # (R,)
    w_out: torch.Tensor       # (R, D)


class RGLRUState(NamedTuple):
    h: torch.Tensor           # (B, R) recurrence state
    conv: torch.Tensor        # (B, W-1, R) conv tail


def init_rglru(cfg: ModelConfig, generator: torch.Generator) -> RGLRUParams:
    D, R, W = cfg.d_model, cfg.rglru_width, cfg.conv1d_width
    dev, g = generator.device, generator
    zeros = lambda: torch.zeros(R, dtype=torch.float32, device=dev)  # noqa: E731
    # Lambda init so a = sigmoid(Lambda) in [0.9, 0.999]
    a = torch.linspace(0.9, 0.999, R, dtype=torch.float32, device=dev)
    return RGLRUParams(
        w_in=init_dense((D, R), D ** -0.5, cfg.dtype, generator=g),
        w_gate_a=zeros(), b_gate_a=zeros(), w_gate_x=zeros(),
        b_gate_x=zeros(), log_lambda=torch.log(a / (1 - a)),
        conv_w=init_dense((W, R), W ** -0.5, cfg.dtype, generator=g),
        conv_b=torch.zeros(R, dtype=cfg.dtype, device=dev),
        w_out=init_dense((R, D), R ** -0.5, cfg.dtype, generator=g),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B,S,R), w: (W,R).  Returns y, new_tail."""
    W = w.shape[0]
    if tail is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S, :] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S, :] * w[i]
    return y + b, xp[:, -(W - 1):, :]


def _assoc_scan(a: torch.Tensor, b: torch.Tensor,
                dim: int = 1) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along ``dim`` from h = 0: the inclusive
    prefix of the pairs (a, b) under (al, bl) . (ar, br) = (al * ar,
    br + ar * bl), in log2(n) rounds."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_hi, a_lo = a.narrow(dim, d, n - d), a.narrow(dim, 0, n - d)
        b_hi, b_lo = b.narrow(dim, d, n - d), b.narrow(dim, 0, n - d)
        b = torch.cat([b.narrow(dim, 0, d), b_hi + a_hi * b_lo], dim)
        a = torch.cat([a.narrow(dim, 0, d), a_hi * a_lo], dim)
        d *= 2
    return b


def _lru_scan(a: torch.Tensor, bx: torch.Tensor,
              h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t.  Past 2 * LRU_CHUNK steps (when S is a
    multiple of it) the prefix runs inside each chunk and the last state
    carries to the next chunk sequentially: the same math, temporaries
    bounded by one chunk."""
    B, S, R = a.shape
    if h0 is not None:  # fold the initial state into step 0
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    if S <= 2 * LRU_CHUNK or S % LRU_CHUNK:
        return _assoc_scan(a, bx)
    hs = []
    h_in = torch.zeros((B, R), dtype=a.dtype, device=a.device)
    for s in range(0, S, LRU_CHUNK):
        a_i, b_i = a[:, s:s + LRU_CHUNK], bx[:, s:s + LRU_CHUNK]
        b_i = torch.cat([b_i[:, :1] + a_i[:, :1] * h_in[:, None],
                         b_i[:, 1:]], 1)
        h = _assoc_scan(a_i, b_i)
        hs.append(h)
        h_in = h[:, -1]
    return torch.cat(hs, dim=1)


def rglru_specs(cfg: ModelConfig, policy: ShardingPolicy) -> RGLRUParams:
    """The specs of one layer's ``RGLRUParams``: the R channels over tp."""
    tp = policy.tp
    return RGLRUParams(
        w_in=policy.p_mlp_in(), w_gate_a=P(tp), b_gate_a=P(tp),
        w_gate_x=P(tp), b_gate_x=P(tp), log_lambda=P(tp),
        conv_w=P(None, tp), conv_b=P(tp), w_out=policy.p_mlp_out())


def rglru(p: RGLRUParams, cfg: ModelConfig, x: torch.Tensor,
          state: RGLRUState | None = None, *,
          policy: ShardingPolicy = NO_SHARDING):
    """x: (B, S, D) -> (B, S, D), new_state.  Under a policy, this rank's
    channels (module docstring)."""
    split = decode = False
    in_proj = lambda a, w: torch.einsum(  # noqa: E731
        "bsd,dr->bsr", a, w.to(a.dtype))
    out_proj = lambda a, w: torch.einsum(  # noqa: E731
        "bsr,rd->bsd", a, w.to(a.dtype))
    if policy.enabled:
        sp, ctx = rglru_specs(cfg, policy), policy.ctx
        split = ctx.tp_size > 1
        decode = not policy.weight_gather
        if not decode:
            p = p._replace(
                w_in=policy.gather_fsdp(p.w_in, P(None, policy.tp), sp.w_in),
                w_out=policy.gather_fsdp(p.w_out, P(policy.tp, None),
                                         sp.w_out))
            x = parallel.seq_enter(x, ctx, seq=policy.seq, split=split)
    if decode:
        u = parallel.dp_dense(in_proj, x, p.w_in, ctx, contract_dim=-1)
    else:
        u = in_proj(x, p.w_in)
    u, conv_tail = _causal_conv(u, p.conv_w.to(u.dtype), p.conv_b.to(u.dtype),
                                state.conv if state is not None else None)
    uf = u.float()
    r = torch.sigmoid(uf * p.w_gate_a + p.b_gate_a)
    i = torch.sigmoid(uf * p.w_gate_x + p.b_gate_x)
    log_a = -RGLRU_C * r * F.softplus(p.log_lambda)     # log a_t <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    h = _lru_scan(a, gated, state.h if state is not None else None)
    if decode:
        y = parallel.dp_dense(out_proj, h.to(x.dtype), p.w_out, ctx,
                              out_dim=-1)
    else:
        y = out_proj(h.to(x.dtype), p.w_out)
    if policy.enabled:
        y = parallel.seq_leave(y, ctx, seq=policy.seq, split=split)
    return y, RGLRUState(h=h[:, -1], conv=conv_tail)


def init_rglru_state(cfg: ModelConfig, batch: int,
                     generator: torch.Generator | None = None,
                     device=None) -> RGLRUState:
    R, W = cfg.rglru_width, cfg.conv1d_width
    if generator is not None:
        dev = generator.device
        h = torch.randn((batch, R), generator=generator, dtype=torch.float32,
                        device=dev) * 0.1
    else:
        dev = resolve_device(device)
        h = torch.zeros((batch, R), dtype=torch.float32, device=dev)
    return RGLRUState(h=h, conv=torch.zeros((batch, W - 1, R),
                                            dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# Mamba2 SSD block
# ---------------------------------------------------------------------------

class SSDParams(NamedTuple):
    w_z: torch.Tensor       # (D, HP) gate projection
    w_x: torch.Tensor       # (D, HP) value projection
    w_B: torch.Tensor       # (D, N)
    w_C: torch.Tensor       # (D, N)
    w_dt: torch.Tensor      # (D, H)
    log_a: torch.Tensor     # (H,) per-head decay
    d_skip: torch.Tensor    # (H,)
    dt_bias: torch.Tensor   # (H,)
    norm_w: torch.Tensor    # (HP,) gated RMSNorm weight
    w_out: torch.Tensor     # (HP, D)


class SSDState(NamedTuple):
    h: torch.Tensor         # (B, H, P, N) SSM state


def ssd_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    P = cfg.ssm_head_dim
    H = (2 * cfg.d_model) // P       # expansion factor 2 (mamba2 default)
    return H, P, cfg.ssm_state


def init_ssd(cfg: ModelConfig, generator: torch.Generator) -> SSDParams:
    D = cfg.d_model
    H, P, N = ssd_dims(cfg)
    dev, g = generator.device, generator
    f32 = dict(dtype=torch.float32, device=dev)
    return SSDParams(
        w_z=init_dense((D, H * P), D ** -0.5, cfg.dtype, generator=g),
        w_x=init_dense((D, H * P), D ** -0.5, cfg.dtype, generator=g),
        w_B=init_dense((D, N), D ** -0.5, cfg.dtype, generator=g),
        w_C=init_dense((D, N), D ** -0.5, cfg.dtype, generator=g),
        w_dt=init_dense((D, H), D ** -0.5, cfg.dtype, generator=g),
        log_a=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        d_skip=torch.ones(H, **f32),
        dt_bias=torch.zeros(H, **f32),
        norm_w=torch.ones(H * P, **f32),
        w_out=init_dense((H * P, D), (H * P) ** -0.5, cfg.dtype, generator=g),
    )


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 h0: torch.Tensor | None):
    """SSD core.  xh: (B,S,H,P); dt: (B,S,H); A: (H,)<0; Bm/Cm: (B,S,N).

    Returns y: (B,S,H,P), h_last: (B,H,P,N)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc, c = S // chunk, chunk
    xc = xh.reshape(B, nc, c, H, P)
    dtc = dt.reshape(B, nc, c, H)
    Bc = Bm.reshape(B, nc, c, N)
    Cc = Cm.reshape(B, nc, c, N)

    da = dtc * A                                   # (B,nc,c,H) log-decay per step
    cum = torch.cumsum(da, dim=2)                  # within-chunk cumulative
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,c,c,H)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))
    # mask BEFORE exp: masked entries have diff > 0 and would overflow
    diff = torch.where(mask[None, None, :, :, None], diff, -30.0)
    L = torch.exp(diff)
    scores = torch.einsum("bxin,bxjn->bxij", Cc, Bc)         # (B,nc,c,c)
    W = scores[..., None] * L * dtc[:, :, None, :, :]        # (B,nc,c,c,H)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", W, xc)

    # chunk states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B,nc,c,H)
    states = torch.einsum("bxch,bxcn,bxchp->bxhpn",
                          dtc * decay_to_end, Bc, xc)        # (B,nc,H,P,N)
    # inter-chunk recurrence over nc, one chunk at a time
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,nc,H)
    h = (torch.zeros_like(states[:, 0]) if h0 is None else h0)
    h_prev = []
    for i in range(nc):
        h_prev.append(h)
        h = states[:, i] + chunk_decay[:, i, :, None, None] * h
    h_prev = torch.stack(h_prev, dim=1)                      # state entering chunk
    in_decay = torch.exp(cum)                                # decay from chunk start
    y_inter = torch.einsum("bxcn,bxch,bxhpn->bxchp", Cc, in_decay, h_prev)
    return (y_intra + y_inter).reshape(B, S, H, P), h


def ssd_specs(cfg: ModelConfig, policy: ShardingPolicy) -> SSDParams:
    """The specs of one layer's ``SSDParams``: heads (``H * P`` channels)
    over tp where they divide, else ``N``; the model dim over FSDP."""
    H, Pd, N = ssd_dims(cfg)
    fsd = policy._fs()
    return SSDParams(
        w_z=P(fsd, policy.shard_if(H * Pd)),
        w_x=P(fsd, policy.shard_if(H * Pd)),
        w_B=P(fsd, policy.shard_if(N)),
        w_C=P(fsd, policy.shard_if(N)),
        w_dt=P(fsd, policy.shard_if(H)),
        log_a=P(None), d_skip=P(None),
        dt_bias=P(None), norm_w=P(policy.shard_if(H * Pd)),
        w_out=P(policy.shard_if(H * Pd), fsd))


def ssd_layout(cfg: ModelConfig, policy: ShardingPolicy) -> str:
    """Which part of the SSD core a tp rank computes, by the reference's
    ``shard_if`` of the state: ``"heads"`` where ``H`` divides over tp,
    else ``"state"`` where ``N`` does, else ``"replicated"`` (module
    docstring)."""
    H, _, N = ssd_dims(cfg)
    if policy.shard_if(H) is not None:
        return "heads"
    return "state" if policy.shard_if(N) is not None else "replicated"


def ssd_state_spec(cfg: ModelConfig, policy: ShardingPolicy,
                   lead: tuple = ()) -> SSDState:
    """The ``P`` of one layer's ``SSDState`` (``lead``: a stacked state's
    block axis): batch over dp, then the heads over tp in the heads layout,
    ``N`` in the state layout, nothing in the replicated one."""
    layout = ssd_layout(cfg, policy)
    return SSDState(h=P(*lead, policy.batch(),
                        policy.tp if layout == "heads" else None, None,
                        policy.tp if layout == "state" else None))


class SSDPlan(NamedTuple):
    """How a rank runs one SSD layer under a policy (``ssd_plan``)."""

    layout: str     # ssd_layout
    split: bool     # tp > 1 and each rank's core a share of the whole
    chan: bool      # the tail on this rank's H * P / tp channels


def ssd_plan(cfg: ModelConfig, policy: ShardingPolicy) -> SSDPlan:
    """``split``: the core's gradient is this rank's share (its heads, its
    ``N`` columns, or, for a replicated core whose output only this
    rank's channels read, those channels), so the core's inputs replicated
    over tp enter it by ``copy_in``.  ``chan``: ``H * P`` divides over tp
    and the skip term, the gate, the gated norm and ``w_out`` run on this
    rank's channels, which need not start at a head."""
    H, Pd, _ = ssd_dims(cfg)
    layout, tp = ssd_layout(cfg, policy), policy.tp_size()
    chan = tp > 1 and policy.shard_if(H * Pd) is not None
    return SSDPlan(layout, tp > 1 and (layout == "state" or chan), chan)


def _ssd_local(p: SSDParams, cfg: ModelConfig, policy: ShardingPolicy,
               plan: SSDPlan) -> SSDParams:
    """This rank's view of ``p`` for a training step or a prefill, the
    FSDP shards gathered: the core's weights (its heads of ``w_x`` and
    ``w_dt`` and ``B``, ``C`` whole in the heads layout; its ``N`` columns
    of ``w_B``, ``w_C`` and ``w_x``, ``w_dt`` whole in the state layout;
    all of them whole in the replicated one), ``log_a`` and ``dt_bias``
    sliced to its heads where it has heads, and the tail's ``w_z`` columns
    and ``w_out`` rows of its channels under ``plan.chan`` (``d_skip`` and
    ``norm_w`` as stored: ``ssd`` cuts the skip term's channels)."""
    sp, ctx, tp = ssd_specs(cfg, policy), policy.ctx, policy.tp
    split, heads = plan.split, plan.layout == "heads"
    g = lambda w, stored, wanted: policy.gather_fsdp(  # noqa: E731
        w, wanted, stored)

    def whole(w, stored):        # every column, read by the core
        w = parallel.reshard(w, stored, P(None, None), ctx, partial=split)
        return parallel.copy_in(w, ctx) if split and \
            tp not in entry_axes(stored[1]) else w

    def vec(v):                  # replicated (H,) vectors read by the core
        v = parallel.copy_in(v, ctx) if split else v
        return parallel.tp_slice(v, 0, ctx) if split and heads else v

    ht = P(None, tp if split and heads else None)
    nt = P(None, tp if plan.layout == "state" and split else None)
    return SSDParams(
        w_z=g(p.w_z, sp.w_z, P(None, tp if plan.chan else None)),
        w_x=g(p.w_x, sp.w_x, ht) if heads else whole(p.w_x, sp.w_x),
        w_B=g(p.w_B, sp.w_B, nt) if nt[1] else whole(p.w_B, sp.w_B),
        w_C=g(p.w_C, sp.w_C, nt) if nt[1] else whole(p.w_C, sp.w_C),
        w_dt=g(p.w_dt, sp.w_dt, ht) if heads else whole(p.w_dt, sp.w_dt),
        log_a=vec(p.log_a), d_skip=p.d_skip, dt_bias=vec(p.dt_bias),
        norm_w=p.norm_w,
        w_out=g(p.w_out, sp.w_out, P(tp if plan.chan else None, None)))


def _gated_norm_split(w: torch.Tensor, g: torch.Tensor, eps: float,
                      width: int, ctx) -> torch.Tensor:
    """``rms_norm(w, g)`` over ``width`` channels of which this rank holds
    ``g``'s: the sum of squares all-reduced over tp."""
    gf = g.float()
    ss = parallel.reduce_out((gf * gf).sum(-1, keepdim=True), ctx)
    var = parallel.copy_in(ss, ctx) / width
    return (gf * torch.rsqrt(var + eps) * w.float()).to(g.dtype)


def _ssd_core(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bf: torch.Tensor, Cf: torch.Tensor, cfg: ModelConfig,
              h0: torch.Tensor | None, scan: bool):
    """The SSD core over the heads of ``xh`` (B, S, H, P) and the ``N``
    columns of ``Bf``, ``Cf``: chunkwise over the sequence (``scan``), else
    one recurrent step from ``h0``.  Returns y (B, S, H, P) in float32 and
    the last state (B, H, P, N)."""
    B, S, H, P_ = xh.shape
    if scan:
        chunk = min(cfg.ssm_chunk, S)
        pad = -S % chunk
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bf = F.pad(Bf, (0, 0, 0, pad))
            Cf = F.pad(Cf, (0, 0, 0, pad))
        y, h_last = _ssd_chunked(xh.float(), dt, A, Bf, Cf, chunk, None)
        return y[:, :S], h_last
    if h0 is None:
        h0 = torch.zeros((B, H, P_, Bf.shape[-1]), dtype=torch.float32,
                         device=xh.device)
    a_t = torch.exp(dt[:, 0] * A)                            # (B,H)
    h_last = (a_t[..., None, None] * h0
              + torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bf[:, 0],
                             xh[:, 0].float()))
    y = torch.einsum("bn,bhpn->bhp", Cf[:, 0], h_last)[:, None]
    return y, h_last


def ssd(p: SSDParams, cfg: ModelConfig, x: torch.Tensor,
        state: SSDState | None = None, *,
        policy: ShardingPolicy = NO_SHARDING):
    """Mamba2 mixer.  x: (B,S,D) -> (B,S,D), new_state.  Under a policy,
    this rank's part of it (``ssd_plan``; module docstring)."""
    H, Pd, N = ssd_dims(cfg)
    width = H * Pd
    proj = lambda a, w: torch.einsum(  # noqa: E731
        "bsd,di->bsi", a, w.to(a.dtype))
    plan, ctx = SSDPlan("replicated", False, False), None
    decode = policy.enabled and not policy.weight_gather
    stored, x_tail = p, x
    if policy.enabled:
        plan, ctx = ssd_plan(cfg, policy), policy.ctx
    heads = plan.layout == "heads"
    if decode:
        dd = lambda w: parallel.dp_dense(  # noqa: E731
            proj, x, w, ctx, contract_dim=-1)
        if plan.split and heads:
            p = p._replace(log_a=parallel.tp_slice(p.log_a, 0, ctx),
                           dt_bias=parallel.tp_slice(p.dt_bias, 0, ctx))
    elif policy.enabled:
        p = _ssd_local(p, cfg, policy, plan)
        x = parallel.seq_enter(x, ctx, seq=policy.seq, split=plan.split)
        # a replicated tail after a core of shares enters on its own
        x_tail = x if plan.chan or not plan.split else parallel.seq_enter(
            x_tail, ctx, seq=policy.seq, split=False)
    B, S, D = x.shape
    if decode:
        z, xh_st, Bm, Cm, dt = (dd(w) for w in (p.w_z, p.w_x, p.w_B, p.w_C,
                                                 p.w_dt))
        xh = xh_st
        if plan.chan and not heads:     # the core reads every channel
            xh = parallel.tp_gather(xh_st, 2, ctx)
        if plan.split and heads and policy.shard_if(N) is not None:
            Bm, Cm = (parallel.tp_gather(a, 2, ctx) for a in (Bm, Cm))
    else:
        z, xh, Bm, Cm, dt = (proj(a, w) for a, w in (
            (x_tail, p.w_z), (x, p.w_x), (x, p.w_B), (x, p.w_C), (x, p.w_dt)))
    Hc = dt.shape[-1]                   # the core's heads
    dt = F.softplus(dt.float() + p.dt_bias)                  # (B,S,Hc)
    A = -torch.exp(p.log_a)                                  # (Hc,) < 0
    y, h_last = _ssd_core(xh.reshape(B, S, Hc, Pd), dt, A, Bm.float(),
                          Cm.float(), cfg,
                          None if state is None else state.h,
                          state is None and S > 1)
    y = y.reshape(B, S, Hc * Pd)
    if plan.split and not heads:        # y and xh on the tail's channels
        if plan.layout == "state":      # the ranks' sums over their N
            y = (parallel.tp_scatter_sum(y, 2, ctx) if plan.chan
                 else parallel.reduce_out(y, ctx))
        else:                           # a replicated core
            y = parallel.tp_slice(y, 2, ctx)
        if decode:
            xh = xh_st
        elif plan.chan:
            xh = parallel.tp_slice(xh, 2, ctx)
        else:
            xh = proj(x_tail, policy.gather_fsdp(
                stored.w_x, P(None, None), ssd_specs(cfg, policy).w_x))
    skip = p.d_skip
    if plan.chan:                       # this rank's channels' skip
        skip = parallel.tp_slice(
            parallel.copy_in(skip, ctx).repeat_interleave(Pd), 0, ctx)
    else:
        skip = skip.repeat_interleave(Pd)
    y = y + skip * xh.float()
    # gated RMSNorm (mamba2)
    if plan.chan:
        y = _gated_norm_split(p.norm_w, y.to(x.dtype) * F.silu(z),
                              cfg.norm_eps, width, ctx)
    else:
        y = rms_norm(p.norm_w, y.to(x.dtype) * F.silu(z), cfg.norm_eps,
                     False)
    out_proj = lambda a, w: torch.einsum(  # noqa: E731
        "bsi,id->bsd", a, w.to(a.dtype))
    out = (parallel.dp_dense(out_proj, y, p.w_out, ctx, out_dim=-1)
           if decode else out_proj(y, p.w_out))
    if policy.enabled:
        out = parallel.seq_leave(out, ctx, seq=policy.seq, split=plan.chan)
    return out, SSDState(h=h_last)


def init_ssd_state(cfg: ModelConfig, batch: int,
                   generator: torch.Generator | None = None,
                   device=None) -> SSDState:
    H, P, N = ssd_dims(cfg)
    shape = (batch, H, P, N)
    if generator is not None:
        return SSDState(h=torch.randn(shape, generator=generator,
                                      dtype=torch.float32,
                                      device=generator.device) * 0.1)
    return SSDState(h=torch.zeros(shape, dtype=torch.float32,
                                  device=resolve_device(device)))
