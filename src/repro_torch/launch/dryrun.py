"""The dry run: each (arch x shape) cell's train step on a mesh of H100
cards, traced on fake tensors, with its memory a card, its FLOPs, the bytes
its ops move and its collective bytes by mesh axis.

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

Prefill and decode cells are ``status: "skip"`` with ``build_cell``'s
message (ROADMAP item 13f), and ``configs.archs.skipped_cells()`` is
reported as the reference reports it.  ``run_config`` dry-runs a
configuration at a batch and sequence the card has run, so that the
memory model can be held against the card's measured peak.

Out of scope: ``run_lda_cell``, the reference's LDA cells (ROADMAP item
13i).  The LDA trainer's host-side partition tiles a real corpus, and its
CUDA kernels do not run on fake tensors; the four-card LDA runs of
``chip_smoke.py`` stand in for it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --chips 256 --out results/dryrun.json
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


def _mesh_name(chips: int, pods: int) -> str:
    model = min(chips, mesh_lib.HOST_CARDS)
    return "x".join(str(n) for n in ((pods,) if pods > 1 else ())
                    + (chips // model, model))


def run_cell(arch: str, shape: str, chips: int = 256, pods: int = 1,
             probe: bool = True) -> dict:
    """One cell on the production mesh of ``chips`` cards a pod (the
    module docstring): a record with ``memory``, ``fits_hbm`` and, when
    traced (``probe``), the memory's traced terms and ``costs``; prefill
    and decode cells are skips."""
    sh = SHAPES[shape]
    out = dict(arch=arch, shape=shape, mesh=_mesh_name(chips, pods),
               chips=chips * pods)
    with fake_group(chips * pods):
        mesh = mesh_lib.make_production_mesh(chips, pods)
        try:
            cell = specs_lib.build_cell(arch, shape, mesh)
        except NotImplementedError as exc:
            return dict(out, status="skip", reason=str(exc))
        t0 = time.time()
        mem = memory(cell, mesh, trace=probe)
        costs = (probe_costs(cell.cfg, sh["global_batch"], sh["seq_len"],
                             mesh, specs_lib.TRAIN_MICRO.get(arch, 1))
                 if probe else None)
    out.update(status="ok", t_trace=round(time.time() - t0, 1),
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
        mem = memory(specs_lib.train_cell(cfg, batch, seq, mesh), mesh)
        costs = probe_costs(cfg, batch, seq, mesh)
    return dict(arch=cfg.name, batch=batch, seq=seq,
                mesh="x".join(map(str, mesh_shape)), chips=world,
                status="ok", memory=mem, costs=costs,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--chips", type=int, default=roofline.CHIPS,
                    help="cards a pod (the mesh is (chips // 8, 8))")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--card-runs", action="store_true",
                    help="dry-run the configurations the card trained "
                         "(CARD_RUNS) instead of the cells")
    args = ap.parse_args(argv)

    if args.card_runs:
        for r in card_runs():
            print(json.dumps(r), flush=True)
        return 0
    todo = cells() if args.all else [(args.arch, args.shape)]
    results = []
    for arch, shape in todo:
        try:
            r = run_cell(arch, shape, args.chips, args.pods,
                         probe=not args.no_probe)
        except Exception as e:  # noqa: BLE001 (a failed cell is a record)
            r = dict(arch=arch, shape=shape,
                     mesh=_mesh_name(args.chips, args.pods), status="fail",
                     error=f"{type(e).__name__}: {e}",
                     tb=traceback.format_exc()[-2000:])
        print(json.dumps(r), flush=True)
        results.append(r)

    for a, sh, why in skipped_cells():
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
