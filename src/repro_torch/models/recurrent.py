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
output reduce-scattered along S, as every mixer of the port).  SSD
runs head-parallel when its heads divide over tp: this rank's heads of
``w_z``, ``w_x``, ``w_dt`` and ``w_out``, the per-head vectors sliced to
them, and the gated RMSNorm's sum of squares all-reduced over tp (it
spans every head).  ``w_B`` and ``w_C`` (``N`` columns, shared by every
head) are all-gathered over tp and ``B``, ``C`` computed whole on every
rank, so the ``C . B`` contraction needs no all-reduce; ROADMAP lists the
N-sharded version.  When the heads do not divide, SSD is replicated over
tp (``w_B`` and ``w_C`` still gathered); a channel split that cuts a head
(``H * P`` divides, ``H`` does not) raises.

Decode over a mesh (a policy without ``weight_gather``) runs the same
split on this rank's shard of the state: the RG-LRU's ``h`` and ``conv``
on its channels, the SSD's ``h`` on its heads.  The FSDP weights stay
sharded (``parallel.dp_dense``), and the SSD's ``B`` and ``C``, where
their ``N`` columns are sharded over tp, are all-gathered as activations.
A state the reference shards by ``N`` (heads that do not divide, ``N``
that does) is the N-sharded SSD of ROADMAP item 13h, and raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import parallel
from .common import (NO_SHARDING, P, ModelConfig, ShardingPolicy, init_dense,
                     rms_norm)

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


def _ssd_local(p: SSDParams, cfg: ModelConfig, policy: ShardingPolicy):
    """This rank's heads of ``p``, FSDP-gathered, ``w_B`` / ``w_C`` whole,
    and whether the heads are partitioned over tp."""
    H, Pd, N = ssd_dims(cfg)
    sp, ctx = ssd_specs(cfg, policy), policy.ctx
    th, thp = policy.shard_if(H), policy.shard_if(H * Pd)
    if thp is not None and th is None and ctx.tp_size > 1:
        raise NotImplementedError(
            f"SSD over tp = {ctx.tp_size}: its {H * Pd} channels divide and "
            f"its {H} heads do not, so a shard would cut a head; the "
            "channel-parallel SSD is a ROADMAP item")
    split = th is not None and ctx.tp_size > 1
    g = lambda w, stored, wanted: policy.gather_fsdp(  # noqa: E731
        w, wanted, stored)

    def whole(w, stored):        # N columns, read by every local head
        w = parallel.reshard(w, stored, P(None, None), ctx, partial=split)
        return parallel.copy_in(w, ctx) if split and \
            policy.shard_if(N) is None else w

    def heads(v):                # replicated (H,) vectors, local heads
        return parallel.tp_slice(parallel.copy_in(v, ctx), 0, ctx) \
            if split else v

    return SSDParams(
        w_z=g(p.w_z, sp.w_z, P(None, thp)), w_x=g(p.w_x, sp.w_x, P(None, thp)),
        w_B=whole(p.w_B, sp.w_B), w_C=whole(p.w_C, sp.w_C),
        w_dt=g(p.w_dt, sp.w_dt, P(None, th)), log_a=heads(p.log_a),
        d_skip=heads(p.d_skip), dt_bias=heads(p.dt_bias), norm_w=p.norm_w,
        w_out=g(p.w_out, sp.w_out, P(thp, None))), split


def _ssd_decode_local(p: SSDParams, cfg: ModelConfig,
                      policy: ShardingPolicy):
    """The decode step's view of this rank's ``SSDParams`` (the weights'
    FSDP shards as they lie, the per-head vectors sliced to its heads),
    whether the heads are partitioned over tp, and whether ``B`` and ``C``
    come out sharded over tp by ``N``."""
    H, Pd, N = ssd_dims(cfg)
    ctx = policy.ctx
    th, thp = policy.shard_if(H), policy.shard_if(H * Pd)
    if ctx.tp_size > 1 and th is None and (
            thp is not None or policy.shard_if(N) is not None):
        raise NotImplementedError(
            f"SSD decode over tp = {ctx.tp_size}: its {H} heads do not "
            "divide, and the reference then shards the state by N or cuts "
            "a head: the N-sharded SSD is ROADMAP item 13h")
    split = th is not None and ctx.tp_size > 1
    heads = (lambda v: parallel.tp_slice(v, 0, ctx)) if split else \
        (lambda v: v)
    return (p._replace(log_a=heads(p.log_a), d_skip=heads(p.d_skip),
                       dt_bias=heads(p.dt_bias)), split,
            split and policy.shard_if(N) is not None)


def _gated_norm_split(w: torch.Tensor, g: torch.Tensor, eps: float,
                      width: int, ctx) -> torch.Tensor:
    """``rms_norm(w, g)`` over ``width`` channels of which this rank holds
    ``g``'s: the sum of squares all-reduced over tp."""
    gf = g.float()
    ss = parallel.reduce_out((gf * gf).sum(-1, keepdim=True), ctx)
    var = parallel.copy_in(ss, ctx) / width
    return (gf * torch.rsqrt(var + eps) * w.float()).to(g.dtype)


def ssd(p: SSDParams, cfg: ModelConfig, x: torch.Tensor,
        state: SSDState | None = None, *,
        policy: ShardingPolicy = NO_SHARDING):
    """Mamba2 mixer.  x: (B,S,D) -> (B,S,D), new_state.  Under a policy,
    this rank's heads (module docstring)."""
    H, P, N = ssd_dims(cfg)
    width, split, decode = H * P, False, False
    proj = lambda a, w: torch.einsum(  # noqa: E731
        "bsd,di->bsi", a, w.to(a.dtype))
    if policy.enabled:
        decode = not policy.weight_gather
        if decode:
            p, split, n_split = _ssd_decode_local(p, cfg, policy)
            ctx = policy.ctx
            dd = lambda w: parallel.dp_dense(  # noqa: E731
                proj, x, w, ctx, contract_dim=-1)
        else:
            p, split = _ssd_local(p, cfg, policy)
            x = parallel.seq_enter(x, policy.ctx, seq=policy.seq,
                                   split=split)
        H = p.w_dt.shape[-1]
    B, S, D = x.shape
    if decode:
        z, xh, Bm, Cm, dt = (dd(w) for w in (p.w_z, p.w_x, p.w_B, p.w_C,
                                              p.w_dt))
        if n_split:     # N columns over tp: gather the activations
            Bm, Cm = (parallel.tp_gather(a, 2, ctx) for a in (Bm, Cm))
    else:
        z, xh, Bm, Cm, dt = (proj(x, w) for w in (p.w_z, p.w_x, p.w_B,
                                                  p.w_C, p.w_dt))
    xh = xh.reshape(B, S, H, P)
    dt = F.softplus(dt.float() + p.dt_bias)                  # (B,S,H)
    A = -torch.exp(p.log_a)                                  # (H,) < 0
    Bf, Cf = Bm.float(), Cm.float()

    if state is None and S > 1:
        chunk = min(cfg.ssm_chunk, S)
        pad = -S % chunk
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bf = F.pad(Bf, (0, 0, 0, pad))
            Cf = F.pad(Cf, (0, 0, 0, pad))
        y, h_last = _ssd_chunked(xh.float(), dt, A, Bf, Cf, chunk, None)
        y = y[:, :S]
    else:  # decode: single recurrent step
        h0 = state.h if state is not None else torch.zeros(
            (B, H, P, N), dtype=torch.float32, device=x.device)
        a_t = torch.exp(dt[:, 0] * A)                        # (B,H)
        h_last = (a_t[..., None, None] * h0
                  + torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bf[:, 0],
                                 xh[:, 0].float()))
        y = torch.einsum("bn,bhpn->bhp", Cf[:, 0], h_last)[:, None]
    y = y + p.d_skip[None, None, :, None] * xh[:, :S].float()
    y = y.reshape(B, S, H * P)
    # gated RMSNorm (mamba2)
    if split:
        y = _gated_norm_split(p.norm_w, y.to(x.dtype) * F.silu(z),
                              cfg.norm_eps, width, policy.ctx)
    else:
        y = rms_norm(p.norm_w, y.to(x.dtype) * F.silu(z), cfg.norm_eps,
                     False)
    out_proj = lambda a, w: torch.einsum(  # noqa: E731
        "bsi,id->bsd", a, w.to(a.dtype))
    out = (parallel.dp_dense(out_proj, y, p.w_out, policy.ctx, out_dim=-1)
           if decode else out_proj(y, p.w_out))
    if policy.enabled:
        out = parallel.seq_leave(out, policy.ctx, seq=policy.seq,
                                 split=split)
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
