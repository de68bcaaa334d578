"""The collectives a ``ShardingPolicy``'s placements imply, with autograd.

The reference writes GSPMD placements (``with_sharding_constraint`` and
the parameters' ``PartitionSpec``s) and XLA inserts the collectives.  The
port holds each rank's local shard and runs the layers Megatron-style on
it, so the collectives are explicit, each a ``torch.autograd.Function``
whose backward is its transpose:

* ``copy_in`` (tp): identity forward, all-reduce of the gradient over tp
  backward.  It marks a tensor replicated over tp (the layer input, or a
  replicated weight such as ``q_norm``) where a tp-partitioned
  computation starts reading it: each rank's gradient is then a partial
  sum.
* ``reduce_out`` (tp, or the dp axes for the loss): all-reduce forward,
  identity backward.  It ends a partitioned computation whose consumer is
  replicated (a row-parallel output, the vocab-parallel softmax sums).
* ``reshard`` (a weight from its stored spec to the spec its matmul
  wants): all-gather over the dims' axes, then this rank's slice.  The
  backward reduce-scatters the gradient (the reference's ZeRO-3 flow over
  dp, and the sum of the partial gradients over tp), or, for a consumer
  replicated over tp (``partial=False``), takes this rank's slice of the
  complete gradient.
* ``all_to_all`` (tp): block j of dim 0 to tp rank j, block j of the
  result from rank j (``all_to_all_single``); its own transpose, so the
  backward runs it on the gradient.  The expert-parallel MoE's dispatch
  and return.
* ``tp_slice`` / ``tp_gather``: this rank's block of a tensor replicated
  over tp (the backward pads the gradient with zeros), and the blocks of
  every tp rank put back together (the backward takes this rank's block).
* ``vocab_embed`` and ``vocab_cross_entropy``: the embedding lookup and
  the cross entropy over a vocabulary sharded over tp (masked lookup plus
  all-reduce; max, sum of exponentials and the gold logit all-reduced,
  the padded slots masked on their own shard).

Serving records no graph, and decode keeps its weights where they lie
(the reference's ``weight_gather=False``): ``dp_dense`` multiplies this
rank's batch rows by a weight sharded over the dp axes (FSDP) without
gathering the weight.  It all-gathers the rows over dp, multiplies them
by this rank's slice of the weight (the matching slice of the contracted
dim, or the whole rows into this rank's block of the output's dim) and
reduce-scatters the product back to the batch rows: activation bytes
move, never weight bytes.

An axis of size 1 runs no collective, so a ``(1, 1)`` mesh runs the same
arithmetic as one device.  A dim sharded over several axes (``("pod",
"data")``) is gathered over the minor axis first and reduce-scattered over
the major one first, matching the shard order JAX gives such a dim.
Gloo ranks (the CPU) move bf16 as float32; NCCL ranks move it as is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .common import P, entry_axes, map_with_specs


class MeshContext:
    """This rank's place on a ``DeviceMesh``: per axis its size, its
    coordinate and the process group of the ranks that differ from it only
    there; ``tp`` and ``dp`` name the policy's axes."""

    def __init__(self, mesh, tp: str | None = None, dp=()):
        self.names = tuple(mesh.mesh_dim_names)
        self.size = {a: int(mesh.size(i)) for i, a in enumerate(self.names)}
        self.coord = {a: int(mesh.get_local_rank(i))
                      for i, a in enumerate(self.names)}
        self.groups = {a: mesh.get_group(i) for i, a in enumerate(self.names)}
        self.tp = tp
        self.dp = tuple(dp)
        self.gloo = {a: dist.get_backend(g) == "gloo"
                     for a, g in self.groups.items()}

    @property
    def tp_size(self) -> int:
        return self.size[self.tp] if self.tp else 1

    @property
    def tp_rank(self) -> int:
        return self.coord[self.tp] if self.tp else 0

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp:
            n *= self.size[a]
        return n


def _wire(t: torch.Tensor, gloo: bool) -> torch.Tensor:
    """``t`` as it goes on the wire: contiguous, bf16 widened on gloo."""
    t = t.contiguous()
    return t.float() if gloo and t.dtype == torch.bfloat16 else t


def _all_gather(x: torch.Tensor, dim: int, axis: str,
                ctx: MeshContext) -> torch.Tensor:
    """The shards of ``x`` along ``dim`` from every rank of ``axis``,
    concatenated in coordinate order."""
    n = ctx.size[axis]
    xs = _wire(x.movedim(dim, 0), ctx.gloo[axis])
    out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                      dtype=xs.dtype, device=xs.device)
    dist.all_gather_into_tensor(out, xs, group=ctx.groups[axis])
    return out.to(x.dtype).movedim(0, dim)


def _reduce_scatter(g: torch.Tensor, dim: int, axis: str,
                    ctx: MeshContext) -> torch.Tensor:
    """The sum of ``g`` over the ranks of ``axis``, this rank's shard of it
    along ``dim``."""
    n = ctx.size[axis]
    gs = _wire(g.movedim(dim, 0), ctx.gloo[axis])
    out = torch.empty((gs.shape[0] // n,) + tuple(gs.shape[1:]),
                      dtype=gs.dtype, device=gs.device)
    dist.reduce_scatter_tensor(out, gs, group=ctx.groups[axis])
    return out.to(g.dtype).movedim(0, dim)


def _split(x: torch.Tensor, dim: int, axis: str,
           ctx: MeshContext) -> torch.Tensor:
    """This rank's shard of ``x`` along ``dim`` over ``axis``."""
    n = x.shape[dim] // ctx.size[axis]
    return x.narrow(dim, ctx.coord[axis] * n, n)


def all_reduce_(t: torch.Tensor, axes, ctx: MeshContext,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over every rank of each axis in turn (no
    autograd)."""
    for a in axes:
        if ctx.size[a] == 1:
            continue
        w = _wire(t, ctx.gloo[a])
        dist.all_reduce(w, op=op, group=ctx.groups[a])
        if w is not t:
            t.copy_(w)
    return t


def _live(axes, ctx: MeshContext) -> tuple[str, ...]:
    return tuple(a for a in axes if ctx.size[a] > 1)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axes, ctx):
        fctx.axes, fctx.ctx = axes, ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce_(g.clone(), fctx.axes, fctx.ctx), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axes, ctx):
        return all_reduce_(x.clone(), axes, ctx)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather of ``x`` along ``dim`` over ``axes`` (minor first); the
    backward reduce-scatters over the axes in ``partial`` and splits over
    the others (major first)."""

    @staticmethod
    def forward(fctx, x, dim, axes, partial, ctx):
        fctx.dim, fctx.axes, fctx.partial, fctx.ctx = dim, axes, partial, ctx
        for a in reversed(axes):
            x = _all_gather(x, dim, a, ctx)
        return x

    @staticmethod
    def backward(fctx, g):
        for a in fctx.axes:
            if a in fctx.partial:
                g = _reduce_scatter(g, fctx.dim, a, fctx.ctx)
            else:
                g = _split(g, fctx.dim, a, fctx.ctx).contiguous()
        return g, None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_to_all(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return _all_to_all(g, fctx.ctx), None


def _all_to_all(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    w = _wire(x, ctx.gloo[ctx.tp])
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=ctx.groups[ctx.tp])
    return out.to(x.dtype)


def copy_in(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """``x``, replicated over tp, entering a tp-partitioned computation."""
    axes = _live((ctx.tp,) if ctx.tp else (), ctx)
    return _CopyIn.apply(x, axes, ctx) if axes else x


def reduce_out(x: torch.Tensor, ctx: MeshContext, axes=None) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over tp (or ``axes``), for a
    replicated consumer."""
    axes = _live((ctx.tp,) if axes is None and ctx.tp else axes or (), ctx)
    return _ReduceOut.apply(x, axes, ctx) if axes else x


def tp_slice(x: torch.Tensor, dim: int, ctx: MeshContext) -> torch.Tensor:
    """This rank's tp shard of ``x`` along ``dim`` (autograd pads the
    gradient with zeros)."""
    return _split(x, dim, ctx.tp, ctx) if ctx.tp_size > 1 else x


def tp_gather(x: torch.Tensor, dim: int, ctx: MeshContext) -> torch.Tensor:
    """The tp ranks' blocks of ``x`` along ``dim``, concatenated in
    coordinate order (the inverse of ``tp_slice``: the backward takes this
    rank's block of the complete gradient)."""
    return _Gather.apply(x, dim, (ctx.tp,), (), ctx) if ctx.tp_size > 1 \
        else x


def all_to_all(x: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """``x``'s dim 0 cut into tp equal blocks, block j sent to tp rank j;
    block j of the result is what rank j sent this rank.  Nothing moves on
    a tp axis of size 1."""
    return _AllToAll.apply(x, ctx) if ctx.tp_size > 1 else x


def reshard(w: torch.Tensor, stored: P, wanted: P, ctx: MeshContext,
            partial: bool = True) -> torch.Tensor:
    """This rank's shard ``w`` of a tensor laid out as ``stored``, laid out
    as ``wanted``: each dim whose axes differ is all-gathered over the
    stored axes, then split over the wanted ones.  The gradient of a gather
    over dp is reduce-scattered (each dp rank saw its own batch); over tp
    it is reduce-scattered when the consumer is partitioned over tp
    (``partial``), else split."""
    nd = w.dim()
    stored = tuple(stored) + (None,) * (nd - len(stored))
    wanted = tuple(wanted) + (None,) * (nd - len(wanted))
    for dim, (s, t) in enumerate(zip(stored, wanted)):
        sa, ta = entry_axes(s), entry_axes(t)
        if sa == ta:
            continue
        live = _live(sa, ctx)
        if live:
            part = tuple(a for a in live if partial or a != ctx.tp)
            w = _Gather.apply(w, dim, live, part, ctx)
        for a in ta:
            if ctx.size[a] > 1:
                w = _split(w, dim, a, ctx)
    return w


def block_of(axes, ctx: MeshContext) -> tuple[int, int]:
    """(number of blocks, this rank's block) of a dim sharded over
    ``axes``, the first axis major."""
    n, k = 1, 0
    for a in axes:
        n, k = n * ctx.size[a], k * ctx.size[a] + ctx.coord[a]
    return n, k


def dp_rows(batch: dict, ctx: MeshContext) -> dict:
    """This rank's rows of a global batch: its block of the leading dim
    over the dp axes (every row when the policy has no dp)."""
    n, k = block_of(ctx.dp, ctx)
    return {key: v.narrow(0, k * (v.shape[0] // n), v.shape[0] // n)
            for key, v in batch.items()}


@torch.no_grad()
def dp_dense(op, x: torch.Tensor, w: torch.Tensor, ctx: MeshContext, *,
             contract_dim: int | None = None, out_dim: int | None = None,
             rows: int = 0) -> torch.Tensor:
    """``op(x, w)`` for ``x`` this rank's rows (dim ``rows``) of a batch
    sharded over the dp axes and ``w`` this rank's FSDP shard of a weight,
    the weight never gathered (module docstring).  The weight's dp-sharded
    dim is either contracted with ``x``'s dim ``contract_dim`` (the rows
    all-gathered over dp are cut to this rank's block of that dim, and the
    partial products, summed in float32, reduce-scattered back to the
    rows), or it is the output's dim ``out_dim`` (the gathered rows'
    product is this rank's block of that dim; zero-padded to the whole dim
    and reduce-scattered).  ``op(x, w)`` as it stands where no dp axis is
    larger than one."""
    axes = _live(ctx.dp, ctx)
    if not axes:
        return op(x, w)
    n, k = block_of(ctx.dp, ctx)
    for a in reversed(axes):
        x = _all_gather(x, rows, a, ctx)
    if contract_dim is not None:
        m = x.shape[contract_dim] // n
        x = x.narrow(contract_dim, k * m, m)
    y = op(x, w)
    dt = y.dtype
    if out_dim is not None:
        shape = list(y.shape)
        m, shape[out_dim] = shape[out_dim], shape[out_dim] * n
        z = y.new_zeros(shape)
        z.narrow(out_dim, k * m, m).copy_(y)
        y = z
    else:
        y = y.float()
    for a in axes:
        y = _reduce_scatter(y, rows, a, ctx)
    return y.to(dt)


def vocab_embed(w: torch.Tensor, tokens: torch.Tensor,
                ctx: MeshContext) -> torch.Tensor:
    """``w_full[tokens]`` from this rank's rows ``w`` of a table sharded
    over tp by rows: the rows this rank holds, zeros for the others, summed
    over tp."""
    if ctx.tp_size == 1:
        return w[tokens]
    n = w.shape[0]
    local = tokens.long() - ctx.tp_rank * n
    hit = (local >= 0) & (local < n)
    rows = w[local.clamp(0, n - 1)] * hit[..., None].to(w.dtype)
    return reduce_out(rows, ctx)


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        ctx: MeshContext) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]`` of float32 logits
    sharded over tp along the vocabulary (this rank's block of columns;
    padded slots already masked to -1e9): the max (no gradient, as the
    reference's ``stop_gradient``) and the sum of exponentials are
    all-reduced, and the gold logit is taken on the shard that owns it and
    all-reduced."""
    m = logits.max(dim=-1, keepdim=True).values.detach()
    all_reduce_(m, _live((ctx.tp,) if ctx.tp else (), ctx), ctx,
                dist.ReduceOp.MAX)
    sumexp = reduce_out(torch.exp(logits - m).sum(dim=-1), ctx)
    logz = torch.log(sumexp) + m[..., 0]
    n = logits.shape[-1]
    local = labels.long() - ctx.tp_rank * n if ctx.tp_size > 1 else \
        labels.long()
    hit = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_out(torch.where(hit, gold, torch.zeros_like(gold)), ctx)
    return logz - gold


# ---------------------------------------------------------------------------
# whole trees: a rank's shards of full tensors, and back
# ---------------------------------------------------------------------------

def mesh_coords(mesh, rank: int) -> tuple[dict, dict]:
    """(coordinate, size) per axis of global ``rank`` on ``mesh``."""
    grid = mesh.mesh
    where = (grid == rank).nonzero()
    if len(where) != 1:
        raise ValueError(f"rank {rank} is not on the mesh {grid.tolist()}")
    names = tuple(mesh.mesh_dim_names)
    return (dict(zip(names, where[0].tolist())),
            dict(zip(names, grid.shape)))


def local_shard(t: torch.Tensor, spec: P, coord: dict,
                size: dict) -> torch.Tensor:
    """The block of the full tensor ``t`` that the rank at ``coord`` holds
    under ``spec`` (a copy, so ``t`` can be freed).  Raises when a sharded
    dim does not divide over its axes."""
    for dim, e in enumerate(spec):
        axes = entry_axes(e)
        n, k = 1, 0
        for a in axes:
            n, k = n * size[a], k * size[a] + coord[a]
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does "
                             f"not divide over {axes} ({n} ranks)")
        m = t.shape[dim] // n
        t = t.narrow(dim, k * m, m)
    return t.clone()


def shard_tree(tree, specs, coord: dict, size: dict):
    """The shards of a tree of full tensors laid out by ``specs`` that the
    rank at ``coord`` holds (``local_shard`` leaf by leaf)."""
    return map_with_specs(lambda t, s: local_shard(t, s, coord, size),
                          tree, specs)


@torch.no_grad()
def gather_full(t: torch.Tensor, spec: P, ctx: MeshContext) -> torch.Tensor:
    """The full tensor of this rank's shard ``t`` laid out by ``spec``,
    all-gathered (every rank gets it); a new tensor even where nothing is
    gathered, so it never aliases state updated in place."""
    out = t
    for dim, e in enumerate(spec):
        for a in reversed(_live(entry_axes(e), ctx)):
            out = _all_gather(out, dim, a, ctx)
    return out.clone() if out is t else out.contiguous()


def gather_tree(tree, specs, ctx: MeshContext):
    """The full tensors of a tree of this rank's shards (collective: every
    rank of the mesh calls it)."""
    return map_with_specs(lambda t, s: gather_full(t, s, ctx), tree, specs)
