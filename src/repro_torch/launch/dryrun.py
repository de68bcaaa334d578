"""The dry run: each (arch x shape) cell's train, prefill or decode step on
a mesh of H100 cards, traced on fake tensors, with its memory a card, its
FLOPs, the bytes its ops move and its collective bytes by mesh axis.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for 512 forced TPU host devices and reads XLA's memory and cost
analysis and the HLO text.  PyTorch has neither, so this module reads a
*dispatch trace of fake tensors*, not HLO: it opens a ``fake`` process
group of ``chips * pods`` ranks in this one process (as rank 0, whose
collectives return at once), builds the production mesh
(``mesh.make_production_mesh``: (32, 8) at 256 cards) and the cell
(``specs.build_cell``: this rank's shards of the state and rows of the
batch), and runs one train step under ``FakeTensorMode`` (shapes and
dtypes, no memory, no card) and two more dispatch modes:

* ``torch.utils.flop_counter.FlopCounterMode``: the step's FLOPs;
* ``Trace``: each aten op's input and output bytes (``op_bytes``: the
  unfused traffic of eager PyTorch; views move none), each c10d
  collective with its op, mesh axis, dtype, shape, result bytes (the
  reference's convention) and source frame, and the bytes alive above
  the state: the most the forward held at once (its activations), and
  the step's peak with what was alive at it (the gradients made so far,
  the forward's tensors, and temporaries: the backward's, its
  recomputation included, and the optimizer's).

The probe (the reference's ``probe_costs``): one block and two blocks are
traced and every term is extrapolated to the full depth, ``c(1) + (NB - 1)
* (c(2) - c(1))``, each block being the same program.  The traces run at
``micro_batches = 1``, where the token-linear FLOPs and bytes are those of
the whole step.  The collectives are not all token-linear: every further
micro-batch gathers the FSDP shards again and reduce-scatters their
gradients again.  The reference adds that term analytically (``(U - 1)``
times the bf16 params times ``(dp - 1) / dp``, with dp = 16); here it is
taken from the trace itself, the all-gathers and reduce-scatters over the
mesh's dp axes counted ``U`` times (``regather_bytes`` is what that
adds).

The memory is not extrapolated: the step's peak moves with the depth
(the attention's transients at one block, the gradients before the
optimizer at full depth), so it is traced at full depth, on one
micro-batch's rows, with the float32 gradient accumulators added when
``U`` > 1 (as the reference compiles the full cell for its memory).
Parameter, gradient and optimizer bytes are exact, from the full-depth
shards of ``build_cell``.

Prefill and decode cells (``specs.serve_cell``) run their step once on
fake tensors of this rank's shards of the params, the decode state (the
caches holding ``S - 1`` tokens) and its rows of the inputs
(``trace_serve``): the memory is the params, the state (``cache_bytes``:
caches, recurrent states and their positions), the inputs and the step's
transients above them at full depth; the costs are the same 1- and
2-block probe, extrapolated (no micro-batches).  A decode step keeps its
FSDP weights sharded, so its collectives are activation-sized.
``configs.archs.skipped_cells()`` is reported as the reference reports
it.  ``run_config`` dry-runs a
configuration at a batch and sequence the card has run, so that the
memory model can be held against the card's measured peak.

Each LM record says whether its residual was sequence-sharded over tp
(``sp``, and ``sp_encoder`` for whisper's encoder; ``sequence_parallel``)
and, for a model with SSD layers, how they split over tp (``ssd_layout``:
heads, state or replicated).  ``--model 16`` builds the reference's own
(16, 16) pod instead of the port's (32, 8); ``--arch`` without
``--shape`` runs every cell of that arch.

The LDA cells (``run_lda_cell``, ``--lda``), the paper's own workload: for
each mode (1d, 2d, and both over the int16 byte wire) rank 0's
``DistributedLDA`` is built on the fake group with its host tiling real
(the partition tiles only this rank's shard), then one ``step`` is traced
on fake ``cuda`` tensors of its shard, its state and its uniforms
(``trace_lda_step``), so that ``ops.py`` takes the kernel route: K1, K2
and K4 are ``torch.library`` custom ops whose fake implementations give
their outputs and whose FLOP formulas are the kernels' shape reckonings.
Nothing is built and nothing launched.  What the cells model: the bytes a
card holds (phi, phi_sum, z, the tiles, K2's table, the uniforms, and the
step's transients, the ELL among them), the FLOPs, the op bytes of the
kernels' operands and of the plain PyTorch around them, and every
collective by the mesh axes of its group and by op.  What they cannot
see: the kernels' own traffic beyond their operands (K1's ELL and phi
row reads, K2's histogram flushes), and NCCL's choice of algorithm (the
bytes are the results', as the reference counts them).  What the step
met on fake tensors, and how each was handled:

* K2's segment table has a data-dependent length (``nonzero`` over the
  tiling): built on the host from the real tiling, with the library's
  segment length mirrored in ``kernels/phi_update/contract.py`` (no
  build), and put in the fake shard's cache;
* the K1 wrapper's shared-memory check and ``tiles_per_cta`` read the
  built library: they run in the op's CUDA body only;
* the ELL's live lengths (``ops.live_lengths``) are a reduction of
  static shape, and the theta -> ELL row blocks a loop over the shape:
  both trace as they are; the ELL's true live entries are not known, so
  K1's reckoning leaves their operations out;
* Python indexing, ``Tensor.copy_`` and a copying ``.contiguous()`` of a
  fake ``cuda`` tensor raise on a CPU-only build of torch (their bindings
  take a CUDA device guard): the iteration's code cuts with ``narrow`` /
  ``unbind`` and writes with ``updates.fill_block``;
* no ``.item()`` or host sync lies on the step: the uniforms are passed
  in, the stats stay tensors.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --chips 256 --out results/dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m --chips 256 --model 16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --lda --chips 256
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro_torch.configs.archs import ARCHS, SHAPES, cells, skipped_cells
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline
from repro_torch.launch import specs as specs_lib
from repro_torch.models import transformer as tf
from repro_torch.models import zoo
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw

_MODELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models")
_ROOT = os.path.dirname(os.path.dirname(_MODELS))
_HELPERS = ("parallel.py", "common.py")   # collective helpers, not callers
# the c10d ops the port issues, by the reference's (HLO) names
COLLECTIVES = {"allreduce": "all-reduce", "allgather_base": "all-gather",
               "reduce_scatter_base": "reduce-scatter",
               "alltoall_base": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def _source() -> str:
    """The innermost frame of the model code on the stack (``models/``, not
    its collective helpers), as file:line."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_MODELS) and \
                os.path.basename(name) not in _HELPERS:
            return f"{os.path.relpath(name, _ROOT)}:{f.f_lineno}"
        f = f.f_back
    return "?"


class Trace(TorchDispatchMode):
    """Reads every op a step dispatches (see the module docstring).
    ``axes``: {process group name: mesh axis}; ``held``: the tensors alive
    before the step (its state and batch), whose storages are not the
    step's even where a view or an in-place op returns them.  ``phase``
    ("forward" or "optimizer") labels what the caller runs outside the
    backward."""

    def __init__(self, axes: dict, held=()):
        super().__init__()
        self.axes = axes
        self.held = {t.untyped_storage()._cdata for t in held}
        self.phase = "forward"
        self.op_bytes = 0
        self.kernels: dict[str, int] = {}   # the port's custom ops called
        self.collectives: list[dict] = []
        self.live: dict[int, tuple[int, bool]] = {}   # storage: bytes, fwd
        self.current = self.forward = 0
        self.peak = self.saved = 0      # the most alive; of it the forward's
        self.at_peak: dict[int, tuple[int, bool]] = {}

    def _axis(self, args) -> str:
        from torch._C._distributed_c10d import ProcessGroup

        for a in args:
            if isinstance(a, torch.ScriptObject):
                with contextlib.suppress(RuntimeError):
                    return self.axes[ProcessGroup.unbox(a).group_name]
        raise ValueError("a collective over no group of the mesh")

    def _alloc(self, t: torch.Tensor, phase: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live or key in self.held:
            return
        n, fwd = st.nbytes(), phase == "forward"
        self.live[key] = (n, fwd)
        self.current += n
        self.forward += n * fwd
        weakref.finalize(st, self._free, key)
        self.saved = max(self.saved, self.forward)
        if self.current > self.peak:
            self.peak, self.at_peak = self.current, self.live.copy()

    def _free(self, key: int) -> None:
        n, fwd = self.live.pop(key)
        self.current -= n
        self.forward -= n * fwd

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in pytree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        if func.namespace == "c10d":
            res = ins[0]     # every c10d op here writes its first tensor
            self.collectives.append(dict(
                op=COLLECTIVES[func.__name__.split(".")[0].strip("_")],
                axis=self._axis(args), dtype=str(res.dtype)[6:],
                shape=list(res.shape), bytes=_nbytes(res),
                backward=_in_backward(), source=_source()))
            return out
        if func.namespace == "repro_torch":
            name = func.__name__.split(".")[0]
            self.kernels[name] = self.kernels.get(name, 0) + 1
        outs = [a for a in pytree_leaves(out) if isinstance(a, torch.Tensor)]
        if outs and not func.is_view:     # not a view, a size or a device
            self.op_bytes += sum(_nbytes(t) for t in ins + outs)
        phase = "backward" if _in_backward() else self.phase
        for t in outs:
            self._alloc(t, phase)
        return out

    def peak_split(self, grads) -> dict:
        """The peak's bytes by kind: the step's returned gradients alive
        then, the forward's other tensors (activations) and the rest
        (temporaries)."""
        mine = {g.untyped_storage()._cdata for g in grads}
        out = dict(gradients=0, activations=0, temporaries=0)
        for key, (n, fwd) in self.at_peak.items():
            out["gradients" if key in mine else "activations" if fwd
                else "temporaries"] += n
        return out

    def coll_bytes(self) -> dict:
        """{op: {axis: result bytes}}."""
        out: dict = {}
        for c in self.collectives:
            by_axis = out.setdefault(c["op"], {})
            by_axis[c["axis"]] = by_axis.get(c["axis"], 0) + c["bytes"]
        return out


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0; destroyed on exit.  Raises if a group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: a "
                           "process group is initialised already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_axes(mesh) -> dict:
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}


def trace_step(cell: specs_lib.Cell, mesh, micro: int = 1,
               rows: int | None = None) -> dict:
    """One train step of ``cell`` on fake tensors of its meta arguments at
    ``micro`` micro-batches, on the first ``rows`` of its batch (all when
    None): FLOPs, op bytes, collectives, and the peak bytes above the state
    with the activations among them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    state, batch = cell.args
    specs = tf.param_specs(cell.cfg, cell.policy)
    fake = FakeTensorMode()
    with fake:
        st = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype), state)
        b = {k: torch.zeros((rows or v.shape[0],) + tuple(v.shape[1:]),
                            dtype=v.dtype) for k, v in batch.items()}
    flops = FlopCounterMode(display=False)
    trace = Trace(_mesh_axes(mesh), tree_leaves(st) + list(b.values()))
    with fake, flops, trace:
        loss, grads = zoo.loss_and_grads(st.params, cell.cfg, b, micro,
                                         policy=cell.policy, specs=specs)
        trace.phase = "optimizer"
        adamw.apply(adamw.AdamWConfig(), grads, st.opt, st.params,
                    policy=cell.policy, specs=specs)
        split = trace.peak_split(tree_leaves(grads))
        del loss, grads
    return dict(flops=float(flops.get_total_flops()),
                op_bytes=float(trace.op_bytes), coll=trace.coll_bytes(),
                collectives=trace.collectives, peak=trace.peak,
                saved=trace.saved, **split)


def _tensors(tree) -> list:
    """The tensors of a step's arguments (trees and dicts of inputs)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return tree_leaves(tree)


def _fake_args(args):
    """Fake tensors of the meta tensors of a step's arguments."""
    if isinstance(args, dict):
        return {k: _fake_args(v) for k, v in args.items()}
    if isinstance(args, torch.Tensor):
        return torch.zeros(args.shape, dtype=args.dtype)
    return tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype), args) \
        if hasattr(args, "_fields") else type(args)(
            _fake_args(a) for a in args)


def trace_serve(cell: specs_lib.Cell, mesh) -> dict:
    """One prefill or decode step of ``cell`` on fake tensors of its meta
    arguments: FLOPs, op bytes, collectives, and the peak bytes above the
    arguments (the decode state is written in place: its storages are
    held)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    fake = FakeTensorMode()
    with fake:
        args = _fake_args(cell.args)
    flops = FlopCounterMode(display=False)
    trace = Trace(_mesh_axes(mesh), _tensors(args))
    with fake, flops, trace:
        out = cell.fn(*args)
        del out
    return dict(flops=float(flops.get_total_flops()),
                op_bytes=float(trace.op_bytes), coll=trace.coll_bytes(),
                collectives=trace.collectives, peak=trace.peak)


def serve_memory(cell: specs_lib.Cell, mesh, trace: bool = True) -> dict:
    """A card's bytes in a serving cell's step: its parameters, its decode
    state (``cache_bytes``; 0 for a prefill) and inputs, exact from its
    shards, and, traced at full depth, the step's transients above them
    and the peak."""
    nbytes = lambda tree: sum(_nbytes(a)  # noqa: E731
                              for a in _tensors(tree))
    params, *rest = cell.args
    state = rest[0] if cell.kind == "decode" else None
    out = dict(param_bytes=nbytes(params), cache_bytes=nbytes(state),
               batch_bytes=nbytes(rest[-1]))
    peak = 0
    if trace:
        peak = trace_serve(cell, mesh)["peak"]
        out["temp_bytes"] = peak
    out["peak_device_bytes"] = (out["param_bytes"] + out["cache_bytes"]
                                + out["batch_bytes"] + peak)
    return out


def probe_serve_costs(cfg, kind: str, B: int, S: int, mesh) -> dict:
    """The costs of ``cfg``'s prefill or decode step from its 1- and
    2-block traces, extrapolated to ``cfg.num_blocks``."""
    nb = cfg.num_blocks
    one, two = (trace_serve(specs_lib.serve_cell(at_depth(cfg, n), kind, B,
                                                 S, mesh), mesh)
                for n in (1, 2))
    return dict(flops=_extrap(one["flops"], two["flops"], nb),
                op_bytes=_extrap(one["op_bytes"], two["op_bytes"], nb),
                coll_bytes=_extrap(one["coll"], two["coll"], nb),
                regather_bytes=0, probe=dict(num_blocks=nb, micro=1, **{
                    name: {k: r[k] for k in ("flops", "op_bytes", "coll")}
                    for name, r in (("one", one), ("two", two))}))


def _grad_bytes(params, micro: int) -> int:
    """The gradients of ``params``: in the params' dtype, or float32
    accumulators over several micro-batches."""
    return sum(a.numel() * (4 if micro > 1 else a.element_size())
               for a in tree_leaves(params))


def _extrap(one, two, nb: int):
    """c(1) + (nb - 1) * (c(2) - c(1)), through nested dicts."""
    if isinstance(one, dict) or isinstance(two, dict):
        one, two = one or {}, two or {}
        return {k: _extrap(one.get(k), two.get(k), nb)
                for k in sorted(set(one) | set(two))}
    one, two = one or 0, two or 0
    return one + (nb - 1) * (two - one)


def at_depth(cfg, nb: int):
    """``cfg`` cut to ``nb`` repetitions of its block pattern."""
    return dataclasses.replace(
        cfg, num_layers=nb * len(cfg.pattern) + len(cfg.tail))


def probe_costs(cfg, B: int, S: int, mesh, micro: int = 1) -> dict:
    """The costs of ``cfg``'s train step from its 1- and 2-block traces,
    extrapolated to ``cfg.num_blocks`` (the module docstring)."""
    nb = cfg.num_blocks
    cells_ = [specs_lib.train_cell(at_depth(cfg, n), B, S, mesh, micro)
              for n in (1, 2)]
    one, two = (trace_step(c, mesh) for c in cells_)
    costs = dict(flops=_extrap(one["flops"], two["flops"], nb),
                 op_bytes=_extrap(one["op_bytes"], two["op_bytes"], nb),
                 coll_bytes=_extrap(one["coll"], two["coll"], nb),
                 regather_bytes=0)
    u = cells_[0].micro_batches
    if u > 1:      # every micro-batch gathers the FSDP shards again
        for op in ("all-gather", "reduce-scatter"):
            by_axis = costs["coll_bytes"].get(op, {})
            for axis in set(cells_[0].policy.dp) & set(by_axis):
                costs["regather_bytes"] += by_axis[axis] * (u - 1)
                by_axis[axis] *= u
    costs["probe"] = dict(num_blocks=nb, micro=u, **{
        name: {k: r[k] for k in ("flops", "op_bytes", "coll")}
        for name, r in (("one", one), ("two", two))})
    return costs


def memory(cell: specs_lib.Cell, mesh, trace: bool = True) -> dict:
    """A card's bytes in ``cell``'s step: its parameters, gradients,
    optimizer state and batch (exact, from its shards), and, traced at
    full depth on one micro-batch's rows (the peak moves with the depth:
    it is not extrapolated), the activations the forward holds at most,
    the temporaries alive at the step's peak, and the peak.  Over ``U`` >
    1 micro-batches the float32 gradient accumulators live through the
    step beside one micro-batch's peak."""
    state, batch = cell.args
    u = cell.micro_batches
    nbytes = lambda tree: sum(_nbytes(a)  # noqa: E731
                              for a in tree_leaves(tree))
    out = dict(param_bytes=nbytes(state.params),
               grad_bytes=_grad_bytes(state.params, u),
               opt_bytes=nbytes(state.opt),
               batch_bytes=nbytes(list(batch.values())))
    peak = 0
    if trace:
        res = trace_step(cell, mesh, rows=batch["tokens"].shape[0] // u)
        out.update(activation_bytes=res["saved"],
                   temp_bytes=res["temporaries"])
        peak = res["peak"] + (out["grad_bytes"] if u > 1 else 0)
    out["peak_device_bytes"] = (out["param_bytes"] + out["opt_bytes"]
                                + out["batch_bytes"] + peak)
    return out


def sequence_parallel(cell: specs_lib.Cell, S: int) -> dict:
    """Whether the cell's step keeps its residual sequence-sharded over tp
    (``ShardingPolicy.with_sequence``): ``sp`` for the decoder's stack
    over its ``S`` tokens and any VLM prefix, ``sp_encoder`` for an
    encoder's frames.  Decode never does."""
    if cell.kind == "decode":
        return dict(sp=False)
    cfg = cell.cfg
    out = dict(sp=cell.policy.with_sequence(S + cfg.vision_tokens).seq)
    if cfg.encoder_layers:
        out["sp_encoder"] = cell.policy.with_sequence(cfg.encoder_frames).seq
    return out


def _mesh_name(chips: int, pods: int, model: int | None = None) -> str:
    model = min(chips, mesh_lib.HOST_CARDS) if model is None else model
    return "x".join(str(n) for n in ((pods,) if pods > 1 else ())
                    + (chips // model, model))


def ssd_layout(cell: specs_lib.Cell) -> dict:
    """The SSD layout of a cell whose model has SSD layers
    (``recurrent.ssd_layout``: heads, state or replicated), else
    nothing."""
    from repro_torch.models import recurrent as rec_lib

    kinds = {s.kind for s in cell.cfg.pattern + cell.cfg.tail}
    if "ssd" not in kinds:
        return {}
    return dict(ssd_layout=rec_lib.ssd_layout(cell.cfg, cell.policy))


def run_cell(arch: str, shape: str, chips: int = 256, pods: int = 1,
             probe: bool = True, model: int | None = None) -> dict:
    """One cell on the production mesh of ``chips`` cards a pod, its
    model axis ``model`` wide (``mesh.make_production_mesh``; the module
    docstring): a record with ``memory``, ``fits_hbm`` and, when traced
    (``probe``), the memory's traced terms and ``costs``."""
    sh = SHAPES[shape]
    B, S = sh["global_batch"], sh["seq_len"]
    out = dict(arch=arch, shape=shape, mesh=_mesh_name(chips, pods, model),
               chips=chips * pods)
    with fake_group(chips * pods):
        mesh = mesh_lib.make_production_mesh(chips, pods, model)
        cell = specs_lib.build_cell(arch, shape, mesh)
        t0 = time.time()
        if cell.kind == "train":
            mem = memory(cell, mesh, trace=probe)
            costs = (probe_costs(cell.cfg, B, S, mesh,
                                 specs_lib.TRAIN_MICRO.get(arch, 1))
                     if probe else None)
        else:
            mem = serve_memory(cell, mesh, trace=probe)
            costs = (probe_serve_costs(cell.cfg, cell.kind, B, S, mesh)
                     if probe else None)
    out.update(status="ok", kind=cell.kind, **sequence_parallel(cell, S),
               **ssd_layout(cell), t_trace=round(time.time() - t0, 1),
               micro=cell.micro_batches, memory=mem,
               fits_hbm=bool(mem["peak_device_bytes"] <= mesh_lib.HBM_BYTES))
    if costs is not None:
        out["costs"] = costs
    return out


def run_config(cfg, batch: int, seq: int, mesh_shape: tuple) -> dict:
    """``cfg``'s train step at global ``batch`` x ``seq`` on a ("data",
    "model") mesh of ``mesh_shape``, recorded as ``run_cell`` records a
    cell: the dry run of a configuration a card has run."""
    world = mesh_shape[0] * mesh_shape[1]
    with fake_group(world):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
        cell = specs_lib.train_cell(cfg, batch, seq, mesh)
        mem = memory(cell, mesh)
        costs = probe_costs(cfg, batch, seq, mesh)
    return dict(arch=cfg.name, batch=batch, seq=seq,
                mesh="x".join(map(str, mesh_shape)), chips=world,
                status="ok", **sequence_parallel(cell, seq),
                **ssd_layout(cell), memory=mem,
                costs=costs,
                fits_hbm=bool(mem["peak_device_bytes"] <= mesh_lib.HBM_BYTES))


# (arch, layers (None: all), global batch, mesh) of the card's training
# runs at S = 4096: chip_smoke.py phase 25 and kernel_probe.py's four-card
# runs, whose measured peaks ``--card-runs`` sets its records beside
CARD_RUNS = (("qwen3-4b", None, 1, (1, 1)), ("qwen3-4b", None, 1, (1, 4)),
             ("qwen3-4b", None, 4, (1, 4)), ("qwen3-4b", None, 2, (2, 2)),
             ("qwen3-moe-30b-a3b", 6, 1, (1, 1)),
             ("qwen3-moe-30b-a3b", 16, 1, (1, 4)),
             ("qwen3-moe-30b-a3b", 16, 4, (1, 4)),
             ("qwen3-moe-30b-a3b", 16, 2, (2, 2)))
CARD_SEQ = 4096


def card_runs() -> list[dict]:
    """``run_config`` of every configuration of CARD_RUNS."""
    out = []
    for arch, layers, batch, shape in CARD_RUNS:
        cfg = ARCHS[arch]
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        out.append(dict(run_config(cfg, batch, CARD_SEQ, shape),
                        layers=cfg.num_layers))
    return out


# ---------------------------------------------------------------------------
# the LDA cells: the paper's own workload on the production mesh
# ---------------------------------------------------------------------------

# (V, mean document length) of the paper's Table 3 corpora
LDA_DATASETS = {"nytimes": (101_636, 332), "pubmed": (141_043, 92)}
# (mode, compressed_sync): the reference's four
LDA_MODES = (("1d", False), ("2d", False), ("1d_c16", True),
             ("2d_c16", True))


def lda_stand_in(dataset: str, n_dev: int):
    """The reference's stand-in corpus for ``dataset`` on ``n_dev`` cards:
    ``max(n_dev * 8, 4096)`` Zipf documents at the dataset's full V and
    mean length, seed 0 (the model-side arrays, phi's (V, K), are full
    size; the documents are cut so that the host tiles them quickly)."""
    from repro_torch.data import synthetic

    V, avg_len = LDA_DATASETS[dataset]
    return synthetic.zipf_corpus(num_docs=max(n_dev * 8, 4096), num_words=V,
                                 avg_doc_len=avg_len, seed=0)


def lda_config(num_topics: int = 1024, compressed: bool = False):
    """The reference's LDA cell config."""
    from repro_torch.core import trainer as lda_trainer

    return lda_trainer.LDAConfig(num_topics=num_topics, tile_tokens=256,
                                 tiles_per_step=16,
                                 compressed_sync=compressed)


def _fake_cuda(t: torch.Tensor) -> torch.Tensor:
    """A fake ``cuda`` tensor of ``t``'s shape and dtype (under a
    ``FakeTensorMode``): no card, no values."""
    return torch.empty(t.shape, dtype=t.dtype, device="cuda")


def trace_lda_step(dl) -> dict:
    """One ``DistributedLDA.step`` of this rank (``dl``, built on the host
    on a fake group) traced on fake ``cuda`` tensors of its shard, its
    state and its uniforms, so that ``ops.py`` takes the kernel route and
    K1, K2 and K4 are reached as custom ops: FLOPs (their reckonings
    included), op bytes, the collectives by the groups' axes and op, the
    kernels called, the peak bytes above the held tensors, and the held
    bytes by kind."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import trainer as lda_trainer
    from repro_torch.core import updates
    from repro_torch.kernels.phi_update import contract as phi_contract
    from repro_torch.kernels.phi_update import ops as phi_ops

    cfg, shard = dl.cfg, dl.shard
    K = cfg.num_topics
    n, t = shard.token_doc.shape
    # K2's table, built on the host from the real tiling (its length is
    # data: a fake tiling cannot give it); the segment length is the
    # library's build constant, mirrored in the kernel's contract
    seg = phi_ops.segment_table(shard.tile_word, shard.tile_first,
                                phi_contract.SEGMENT_TILES)
    fake = FakeTensorMode()
    with fake:
        fshard = dataclasses.replace(shard, **{
            f: _fake_cuda(getattr(shard, f)) for f in shard._TENSORS})
        fseg = _fake_cuda(seg)
        fshard._derived["phi_delta_segments"] = fseg
        state = lda_trainer.LDAState(
            z=torch.empty((n, t), dtype=cfg.topic_dtype, device="cuda"),
            phi_vk=torch.empty((shard.num_words, K), dtype=torch.int32,
                               device="cuda"),
            phi_sum=torch.empty((K,), dtype=torch.int32, device="cuda"),
            iteration=0)
        n_all = n + (-n % cfg.micro_chunks)
        uni = torch.empty((n_all, t, 2), dtype=torch.float32, device="cuda")
        heavy = None if dl.heavy_rows is None else _fake_cuda(dl.heavy_rows)
    tiles = [getattr(fshard, f) for f in shard._TENSORS]
    held = tiles + [fseg, state.z, state.phi_vk, state.phi_sum, uni] + (
        [heavy] if heavy is not None else [])
    axes = {}
    for group, names in ((dl.data_group, dl.plan.doc_axes),
                         (dl.model_group, dl.plan.word_axes),
                         (dl.all_group,
                          dl.plan.doc_axes + dl.plan.word_axes)):
        if group is not None:
            axes[group.group_name] = "+".join(names)
    flops = FlopCounterMode(display=False)
    trace = Trace(axes, held)
    real = dl.shard, dl.heavy_rows
    dl.shard, dl.heavy_rows = fshard, heavy
    try:
        with fake, flops, trace:
            out = dl.step(state, uni)
            del out
    finally:
        dl.shard, dl.heavy_rows = real
    P = min(cfg.ell_capacity or min(K, shard.max_doc_length), K)
    ell = updates.ell_dtype(K, shard.max_doc_length)
    size = lambda a: a.numel() * a.element_size()  # noqa: E731
    state_bytes = dict(
        phi=size(state.phi_vk), phi_sum=size(state.phi_sum),
        z=size(state.z), tiles=sum(size(a) for a in tiles),
        k2_tables=size(fseg), uniforms=size(uni),
        heavy_rows=0 if heavy is None else size(heavy),
        # the ELL lives through the sweep: it is among the transients
        ell=2 * shard.num_docs_local * P * torch.empty(
            (), dtype=ell).element_size())
    held_bytes = sum(v for k, v in state_bytes.items() if k != "ell")
    return dict(flops=float(flops.get_total_flops()),
                op_bytes=float(trace.op_bytes), coll=trace.coll_bytes(),
                collectives=trace.collectives, kernels=dict(trace.kernels),
                peak=trace.peak, state_bytes=state_bytes,
                peak_device_bytes=held_bytes + trace.peak)


def run_lda_cell(chips: int = 256, pods: int = 1, dataset: str = "nytimes",
                 num_topics: int = 1024, modes=LDA_MODES,
                 corpus=None) -> dict:
    """The paper's own workload on the production mesh of ``chips`` cards
    a pod, as the reference's ``run_lda_cell``: ``lda_modes`` on the
    reference's stand-in corpus (or ``corpus``)."""
    with fake_group(chips * pods):
        mesh = mesh_lib.make_production_mesh(chips, pods)
        if corpus is None:
            corpus = lda_stand_in(dataset, chips * pods)
        results = lda_modes(mesh, corpus, num_topics, modes)
    return dict(arch=f"lda-{dataset}-k{num_topics}",
                mesh=_mesh_name(chips, pods), chips=chips * pods,
                docs=corpus.num_docs, tokens=corpus.num_tokens,
                status="ok", modes=results)


def lda_modes(mesh, corpus, num_topics: int = 1024,
              modes=LDA_MODES) -> dict:
    """For each of ``modes`` (1d: the documents over every axis of
    ``mesh``; 2d: over the axes but "model", the vocabulary over "model";
    ``_c16``: the int16 byte wire) this rank's ``DistributedLDA`` of
    ``corpus`` under the reference's config, its step traced
    (``trace_lda_step``).  A record per mode: ``peak_device_bytes``,
    ``flops``, ``bytes`` (op bytes), ``coll_bytes`` ({op: {axes: bytes}}),
    ``state_bytes`` by kind, ``temp_bytes``, the ``launches`` of K1, K2
    and K4 in the step, the shard's tiles, documents and words, and
    ``t_trace`` (the host tiling excluded)."""
    from repro_torch.distributed.partition import DistributedLDA
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.phi_update import kernel as k24

    names = tuple(mesh.mesh_dim_names)
    results = {}
    for mode, comp in modes:
        base = mode.split("_")[0]
        doc_axes = (names if base == "1d"
                    else tuple(a for a in names if a != "model"))
        dl = DistributedLDA(lda_config(num_topics, comp), mesh, corpus,
                            mode=base, doc_axes=doc_axes,
                            word_axes=("model",) if base == "2d" else ())
        t0 = time.time()
        r = trace_lda_step(dl)
        results[mode] = dict(
            t_trace=round(time.time() - t0, 1),
            peak_device_bytes=r["peak_device_bytes"], flops=r["flops"],
            bytes=r["op_bytes"], coll_bytes=r["coll"],
            state_bytes=r["state_bytes"], temp_bytes=r["peak"],
            launches={f.__name__: r["kernels"].get(f.__name__, 0)
                      for f in (k1.lda_sample_tiles, k24.phi_delta_tiles,
                                k24.phi_update_tiles)},
            tiles=int(dl.shard.token_doc.shape[0]),
            tile_tokens=int(dl.shard.token_doc.shape[1]),
            docs_local=int(dl.shard.num_docs_local),
            words_local=int(dl.shard.num_words),
            heavy_rows=0 if dl.heavy_rows is None
            else int(dl.heavy_rows.numel()))
    return results


def lda_card_run() -> dict:
    """The dry run of the training ``chip_smoke.py`` runs on one card: the
    full NYTimes-shaped corpus (``nytimes_like(1.0)``) and
    ``lda_nytimes.CONFIG`` on a one-rank mesh, 1d; its peak is held
    against the card's measured peak of one iteration
    (``train_step_memory``)."""
    from repro_torch.configs import lda_nytimes
    from repro_torch.data.synthetic import nytimes_like
    from repro_torch.distributed.partition import DistributedLDA

    corpus = nytimes_like(1.0, seed=0)
    with fake_group(1):
        mesh = mesh_lib.make_production_mesh(1)
        t0 = time.time()
        dl = DistributedLDA(lda_nytimes.CONFIG, mesh, corpus, mode="1d",
                            doc_axes=tuple(mesh.mesh_dim_names),
                            word_axes=())
        t_build = time.time() - t0
        t0 = time.time()
        r = trace_lda_step(dl)
    r.pop("collectives")
    return dict(arch="lda-nytimes-card", docs=corpus.num_docs,
                tokens=corpus.num_tokens, status="ok",
                t_build=round(t_build, 1), t_trace=round(time.time() - t0, 1),
                **r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--chips", type=int, default=roofline.CHIPS,
                    help="cards a pod (the mesh is (chips // model, model))")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--model", type=int, default=None,
                    help="the model axis's width (default min(chips, 8); "
                         "16 gives the reference's (16, 16) pod)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--card-runs", action="store_true",
                    help="dry-run the configurations the card trained "
                         "(CARD_RUNS) instead of the cells")
    ap.add_argument("--lda", action="store_true",
                    help="the LDA cells (NYTimes and PubMed, K = 1024, four "
                         "modes) instead of the LM cells")
    ap.add_argument("--lda-card-run", action="store_true",
                    help="the one-rank NYTimes training chip_smoke.py runs "
                         "(the full corpus: minutes of host tiling)")
    args = ap.parse_args(argv)

    if args.card_runs:
        for r in card_runs():
            print(json.dumps(r), flush=True)
        return 0
    if args.lda_card_run:
        print(json.dumps(lda_card_run()), flush=True)
        return 0
    if args.lda:
        results = []
        for ds in LDA_DATASETS:
            try:
                r = run_lda_cell(args.chips, args.pods, ds)
            except Exception as e:  # noqa: BLE001 (a failed cell is a record)
                r = dict(arch=f"lda-{ds}", mesh=_mesh_name(args.chips,
                                                           args.pods),
                         status="fail", error=f"{type(e).__name__}: {e}",
                         tb=traceback.format_exc()[-2000:])
            print(json.dumps(r), flush=True)
            results.append(r)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        bad = [r for r in results if r["status"] == "fail"]
        print(f"\n{len(results)} LDA cells, {len(bad)} failures",
              file=sys.stderr)
        return 1 if bad else 0
    if args.all:
        todo = cells()
    elif args.shape:
        todo = [(args.arch, args.shape)]
    else:                                   # every cell of the arch
        todo = [c for c in cells() if c[0] == args.arch]
    results = []
    for arch, shape in todo:
        try:
            r = run_cell(arch, shape, args.chips, args.pods,
                         probe=not args.no_probe, model=args.model)
        except Exception as e:  # noqa: BLE001 (a failed cell is a record)
            r = dict(arch=arch, shape=shape,
                     mesh=_mesh_name(args.chips, args.pods, args.model),
                     status="fail",
                     error=f"{type(e).__name__}: {e}",
                     tb=traceback.format_exc()[-2000:])
        print(json.dumps(r), flush=True)
        results.append(r)

    for a, sh, why in skipped_cells():
        if args.all or (a == args.arch and args.shape in (None, sh)):
            results.append(dict(arch=a, shape=sh, status="skip", reason=why))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r.get("status") == "fail"]
    print(f"\n{len(results)} cells, {len(bad)} failures", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
