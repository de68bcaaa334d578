"""collective-contract checker (CC001-CC005), pointed at the port.

Every ``torch.distributed`` call in the port must run over the group its
contract names and carry the wire type its contract names; a mismatch is
invisible on one rank (the CPU tests run small gloo groups where every
group exists) and shows only at scale.  The contract is pinned two ways:

*  **Declared** (AST): ``SCOPE_CONTRACTS`` lists, per module, the dotted
   scopes allowed to issue collectives, the group expressions each may
   name (``group=``, or a point-to-point call's peer) and the element types
   its tensors may have on the wire.  A collective in an undeclared scope
   is CC002; a group token outside the declared set is CC001.
*  **Executed**: the training step, the likelihood and both sync wires run
   on the CPU against a recording stand-in for ``torch.distributed`` whose
   groups are tagged data / model / world.  Every recorded call must come
   from a declared scope with a declared wire type and no int16 on any wire
   (fault F4: gloo and NCCL take none) (CC004), and phi-sized deltas must
   travel over the data group, theta partials and phi_sum over the model
   group (CC001).  CC003 round-trips the all2all routing
   (``plan_token_routing`` / ``route_buckets``) over a shard-count x batch
   matrix; CC005 holds the byte accounting to what moves: the int16 byte
   wire sends 2 (G - 1) / G x 2 bytes an entry a rank, ``psum_gather_bytes``
   is a ring all-reduce of the partials ``_rows_psum`` gathers, and the
   plan's id and row bytes are the buckets ``_rows_routed`` sends between
   shards (CPU shards, rows checked against the dense gather).

Rules
-----
CC001  a collective names a group outside its declared set, or a tensor
       travels over the wrong group
CC002  collective issued from an undeclared scope
CC003  routing round-trip loses/corrupts tokens or violates capacity
CC004  a wire type outside the contract (int16 on a wire: F4)
CC005  comm-byte accounting disagrees with the bytes that move
"""
from __future__ import annotations

import ast
import sys
import threading
from pathlib import Path

import numpy as np
import torch

from .astutil import ScopedVisitor, dotted, leaf_name
from .report import Finding

CHECKER = "collective-contract"

# torch.distributed calls that move data or build groups
COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "reduce", "gather", "scatter", "send", "recv", "isend",
    "irecv", "barrier", "new_group", "all_gather_object",
    "broadcast_object_list",
})
_GROUP_ARGS = ("group", "dst", "src")

_SYNC = "src/repro_torch/core/sync.py"
_PARTITION = "src/repro_torch/distributed/partition.py"

# module -> {dotted scope: (group tokens it may name, wire types)}.  A
# pass-through helper names its ``group`` parameter; the executed check
# holds its callers to the right group.
SCOPE_CONTRACTS: dict[str, dict[str, tuple[frozenset, frozenset]]] = {
    _SYNC: {
        "all_gather_bytes": (frozenset({"group"}), frozenset({"uint8"})),
        "maybe_all_reduce": (frozenset({"group"}),
                             frozenset({"int32", "float32"})),
        "sync_phi_delta": (frozenset({"data_group"}), frozenset({"int32"})),
        "compressed_sync_phi": (frozenset({"data_group"}),
                                frozenset({"uint8", "int32"})),
    },
    _PARTITION: {
        "axes_group": (frozenset({"ranks"}), frozenset()),
        "DistributedLDA._publish": (frozenset({"ranks"}),
                                    frozenset({"int32"})),
        "DistributedLDA._publish.blocks": (frozenset({"src"}),
                                           frozenset({"int32"})),
    },
    "src/repro_torch/core/trainer.py": {},
    "src/repro_torch/train/driver.py": {},
    "src/repro_torch/serve/engine.py": {},   # host engine: no collectives
    "src/repro_torch/serve/infer.py": {},    # sharded serving: copies only
}


# --------------------------------------------------------------------------
# AST pass: CC001 (group token) / CC002 (scope)
# --------------------------------------------------------------------------

def _tokens(node: ast.AST) -> set[str]:
    """Names reachable from a group expression: ``self.data_group`` gives
    ``data_group``, ``ranks[0]`` gives ``ranks``."""
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    out.discard("self")
    return out


class _CollectiveVisitor(ScopedVisitor):
    def __init__(self, rel: str, contracts: dict):
        super().__init__()
        self.rel = rel
        self.contracts = contracts
        self.findings: list[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func) or ""
        leaf = leaf_name(node.func)
        if leaf in COLLECTIVES and name.startswith(("dist.",
                                                    "torch.distributed.")):
            self._check(node, leaf)
        self.generic_visit(node)

    def _check(self, node: ast.Call, leaf: str) -> None:
        scope = self.scope or "<module>"
        if scope not in self.contracts:
            self.findings.append(Finding(
                CHECKER, "CC002", self.rel, node.lineno,
                f"collective {leaf}() in undeclared scope — add the scope "
                "to SCOPE_CONTRACTS with its group and wire type",
                scope=scope))
            return
        allowed = self.contracts[scope][0]
        group = [kw.value for kw in node.keywords if kw.arg in _GROUP_ARGS]
        if leaf == "new_group" and node.args:
            group.append(node.args[0])
        if not group:
            self.findings.append(Finding(
                CHECKER, "CC001", self.rel, node.lineno,
                f"collective {leaf}() names no group — the default group "
                "is every rank, not the data or model group", scope=scope))
            return
        for tok in sorted(set().union(*map(_tokens, group)) - allowed):
            self.findings.append(Finding(
                CHECKER, "CC001", self.rel, node.lineno,
                f"collective {leaf}() names {tok!r}, outside the declared "
                f"groups {sorted(allowed)} for this scope", scope=scope))


def scan_module(path: Path, rel: str, contracts: dict) -> list[Finding]:
    try:
        tree = ast.parse(Path(path).read_text(), filename=str(path))
    except SyntaxError as exc:
        return [Finding(CHECKER, "CC002", rel, exc.lineno or 0,
                        f"unparseable module: {exc.msg}", scope="<module>")]
    v = _CollectiveVisitor(rel, contracts)
    v.visit(tree)
    return v.findings


# --------------------------------------------------------------------------
# executed: a recording torch.distributed on the CPU
# --------------------------------------------------------------------------

class Group:
    """A stand-in process group: its role (data / model / world)."""

    def __init__(self, role: str):
        self.role = role

    def __repr__(self):
        return f"Group({self.role!r})"


class SimDist:
    """``torch.distributed`` for ``size`` ranks run as threads of this
    process (``run``): each collective hands its tensors over through
    shared slots between two barriers and returns what a real group would.
    Rank 0's calls are recorded: the port scope that made it, the call,
    the group's role, the tensors' types and sizes, and the bytes the rank
    sends (a ring all-reduce 2 (G - 1) / G of its tensor, an all-to-all
    (G - 1) / G, an all-gather (G - 1) x its part)."""

    class _Done:
        def wait(self):
            return None

    def __init__(self, size: int = 1):
        self.size = size
        self.calls: list[dict] = []
        self._barrier = threading.Barrier(size)
        self._slots: list = [None] * size
        self._local = threading.local()

    def _rank(self) -> int:
        return getattr(self._local, "rank", 0)

    def _exchange(self, t):
        self._slots[self._rank()] = t.clone()
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()
        return got

    def _record(self, call, group, t, sent):
        if self._rank() != 0:
            return
        frame = sys._getframe(2)
        self.calls.append(dict(
            scope=frame.f_code.co_qualname.replace(".<locals>", ""),
            file=frame.f_code.co_filename, call=call,
            role=getattr(group, "role", "world"),
            dtype=str(t.dtype).replace("torch.", ""), numel=t.numel(),
            sent=sent))

    def get_world_size(self, group=None):
        return self.size

    def all_reduce(self, x, group=None, async_op=False):
        G = self.size
        self._record("all_reduce", group, x,
                     2 * (G - 1) * x.numel() * x.element_size() // G)
        got = self._exchange(x)
        x.copy_(sum(got[1:], got[0]))
        return self._Done()

    def all_to_all_single(self, out, inp, group=None, async_op=False):
        G, r = self.size, self._rank()
        self._record("all_to_all_single", group, inp,
                     (G - 1) * inp.numel() * inp.element_size() // G)
        got = self._exchange(inp)
        out.view(G, -1).copy_(torch.stack([g.view(G, -1)[r] for g in got]))
        return self._Done()

    def all_gather_into_tensor(self, out, inp, group=None, async_op=False):
        G = self.size
        self._record("all_gather_into_tensor", group, inp,
                     (G - 1) * inp.numel() * inp.element_size())
        got = self._exchange(inp)
        out.view(G, -1).copy_(torch.stack([g.reshape(-1) for g in got]))
        return self._Done()

    def run(self, fn):
        """``[fn(rank) for rank in range(size)]``, each rank a thread."""
        out, errors = [None] * self.size, []

        def rank_main(r):
            self._local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as exc:   # reported after the join
                errors.append(exc)
                self._barrier.abort()

        threads = [threading.Thread(target=rank_main, args=(r,))
                   for r in range(self.size)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        if any(th.is_alive() for th in threads):
            self._barrier.abort()
            raise RuntimeError("a simulated rank did not finish in 60 s")
        if errors:
            raise errors[0]
        return out


def _with_dist(fake, fn):
    """Run ``fn`` with ``fake`` as the ``dist`` of the port's modules that
    call collectives."""
    from repro_torch.core import sync
    from repro_torch.distributed import partition

    mods = (sync, partition)
    real = [m.dist for m in mods]
    for m in mods:
        m.dist = fake
    try:
        return fn()
    finally:
        for m, r in zip(mods, real):
            m.dist = r


def _rel(path: str) -> str:
    p = Path(path).as_posix()
    i = p.rfind("src/repro_torch/")
    return p[i:] if i >= 0 else p


def check_recorded(calls: list[dict], V: int = 0, K: int = 0, D: int = 0
                   ) -> list[Finding]:
    """CC004 / CC001 over the calls a run recorded: declared scope and wire
    type, no int16 on a wire and, given the run's (V, K, D), phi deltas over
    the data group, theta partials and phi_sum over the model group."""
    findings: list[Finding] = []
    want = {V * K: "data", D * K: "model", K: "model"} if K else {}
    for c in calls:
        rel, scope, dt = _rel(c["file"]), c["scope"], c["dtype"]
        contract = SCOPE_CONTRACTS.get(rel, {}).get(scope)
        where = f"{c['call']} over the {c['role']} group"
        if contract is None:
            findings.append(Finding(
                CHECKER, "CC002", rel, 0, f"{where} ran from an undeclared "
                "scope", scope=scope))
            continue
        if dt in ("int16", "uint16", "int8"):
            findings.append(Finding(
                CHECKER, "CC004", rel, 0, f"{where} carries {dt}: gloo and "
                "NCCL take no 16-bit integer (F4) — send its uint8 view",
                scope=scope))
        elif dt not in contract[1]:
            findings.append(Finding(
                CHECKER, "CC004", rel, 0, f"{where} carries {dt}, outside "
                f"the declared wire {sorted(contract[1])}", scope=scope))
        role = want.get(c["numel"])
        if (dt == "int32" and c["call"] == "all_reduce" and role
                and c["role"] != role):
            findings.append(Finding(
                CHECKER, "CC001", rel, 0, f"an int32 tensor of {c['numel']}"
                f" entries (phi: {V * K}, theta: {D * K}, phi_sum: {K}) went "
                f"over the {c['role']} group, not the {role} group",
                scope=scope))
    return findings


def check_training_wires() -> list[Finding]:
    """Executed CC001/CC004: one ``lda_iteration`` on each sync wire (heavy
    rows on the compressed one) and one ``log_likelihood``, with a data and
    a model group, and ``partition._all_gather`` of int16, all through
    ``SimDist`` (one rank)."""
    from repro_torch.core import trainer
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.data.synthetic import lda_corpus
    from repro_torch.distributed import partition

    corpus = lda_corpus(num_docs=12, num_words=40, num_topics=4,
                        avg_doc_len=20, seed=3)
    shard = tile_corpus(corpus, 1, 16)[0]
    V, D, K = corpus.num_words, shard.num_docs_local, 8
    groups = dict(data_group=Group("data"), model_group=Group("model"))
    findings: list[Finding] = []
    for compressed in (False, True):
        cfg = trainer.resolve_config(trainer.LDAConfig(
            num_topics=K, tile_tokens=16, compressed_sync=compressed), corpus)
        sim = SimDist()

        def step(rank):
            st = trainer.init_state(cfg, shard)
            st, _ = trainer.lda_iteration(
                cfg, shard, st, heavy_rows=torch.tensor([0, 1]), **groups)
            trainer.log_likelihood(cfg, shard, st, **groups)
            partition._all_gather(torch.zeros(3, dtype=torch.int16),
                                  Group("world"))
        _with_dist(sim, lambda: sim.run(step))
        if compressed and not any(c["call"] == "all_to_all_single"
                                  for c in sim.calls):
            findings.append(Finding(
                CHECKER, "CC004", _SYNC, 0, "compressed_sync=True ran no "
                "byte-wire all_to_all_single", scope="compressed_sync_phi"))
        findings.extend(check_recorded(sim.calls, V, K, D))
    return findings


def check_byte_wire(counts=(2, 4), sync_fn=None) -> list[Finding]:
    """CC005 + exactness of the int16 byte wire, G ranks as threads, each
    with its own delta: each rank sends 2 (G - 1) / G x 2 bytes an entry of
    the padded delta (a reduce-scatter and an all-gather of int16 as
    uint8), and every rank gets the int32 sum, an entry past int16 exact
    through the heavy rows.  ``sync_fn`` is injectable for the planted
    tests."""
    from repro_torch.core import sync

    sync_fn = sync_fn or sync.compressed_sync_phi
    findings: list[Finding] = []
    heavy = torch.tensor([2], dtype=torch.int32)

    def delta_of(r):
        d = (torch.arange(-35, 35, dtype=torch.int32).view(7, 10) * 7
             + 100 * r)
        d[2, 3] = 20000            # summed over ranks past 2^15: heavy
        return d

    for G in counts:
        sim = SimDist(G)
        outs = _with_dist(sim, lambda: sim.run(
            lambda r: sync_fn(delta_of(r), Group("data"), heavy)))
        total = sum(delta_of(r) for r in range(G))
        n = total.numel()
        padded = -(-n // G) * G
        wire = sum(c["sent"] for c in sim.calls
                   if c["call"] != "all_reduce")
        want = 2 * (G - 1) * padded * 2 // G
        scope = f"byte-wire:G{G}"
        findings.extend(check_recorded(sim.calls))
        if wire != want:
            findings.append(Finding(
                CHECKER, "CC005", _SYNC, 0, f"the int16 byte wire sends "
                f"{wire} bytes a rank; 2 (G - 1) / G x 2 bytes an entry "
                f"of {padded} is {want}", scope=scope))
        if not all(torch.equal(o, total) for o in outs):
            findings.append(Finding(
                CHECKER, "CC005", _SYNC, 0, "the byte wire's result is not "
                f"the int32 sum over the {G} ranks on every rank",
                scope=scope))
    return findings


# --------------------------------------------------------------------------
# CC003: executed routing round-trip
# --------------------------------------------------------------------------

_ROUTE_SHARDS = (1, 2, 3, 4, 8)
_ROUTE_BATCHES = ((1, 8), (4, 16), (5, 12), (8, 32))


def check_route_roundtrip(route_fn=None, shard_counts=_ROUTE_SHARDS,
                          batches=_ROUTE_BATCHES) -> list[Finding]:
    """CC003: ``route_buckets`` must deliver every real token exactly once,
    into its owner's bucket, within the capacity ``plan_token_routing``
    fixed — executed over the reference's shard-count x batch matrix.
    ``route_fn`` is injectable so the planted tests can feed a lossy
    router through the same harness."""
    from repro_torch.distributed import partition

    route_fn = route_fn or partition.route_buckets
    findings: list[Finding] = []
    rng = np.random.default_rng(7)
    V, K = 64, 16
    for S in shard_counts:
        shard_of = rng.integers(0, S, V).astype(np.int32)
        shard_of[: V // 2] = rng.integers(0, max(1, S // 2), V // 2)
        for B, L in batches:
            scope = f"route:S{S}:B{B}x{L}"

            def fail(msg, scope=scope):
                findings.append(Finding(CHECKER, "CC003", _PARTITION, 0, msg,
                                        scope=scope))
            tokens = rng.integers(0, V, (B, L)).astype(np.int32)
            lens = rng.integers(0, L + 1, B)
            lens[0] = L
            mask = np.arange(L)[None, :] < lens[:, None]
            plan = partition.plan_token_routing(shard_of, tokens, mask, S, K)
            starts, per = partition.doc_slice_bounds(B, S)
            if not 1 <= plan.capacity <= per * L:
                fail(f"planned capacity {plan.capacity} outside [1, "
                     f"slice_tokens={per * L}]")
                continue
            for s in range(S):
                sl = slice(int(starts[s]), int(starts[s]) + per)
                tok = tokens[sl].reshape(-1)
                msk = mask[sl].reshape(-1)
                T = tok.size
                owner = np.where(msk, shard_of[tok], S).astype(np.int32)
                bucket = np.bincount(owner[msk], minlength=S)
                if int(bucket.max(initial=0)) > plan.capacity:
                    fail(f"shard {s}: max bucket {int(bucket.max())} exceeds "
                         f"planned capacity {plan.capacity}")
                payload = np.arange(T, dtype=np.int32) + 1000
                send, src = (x.numpy() for x in route_fn(
                    torch.from_numpy(owner), torch.from_numpy(payload), S,
                    plan.capacity))
                filled = src < T
                got = np.sort(src[filled])
                want = np.sort(np.nonzero(msk)[0])
                if not np.array_equal(got, want):
                    fail(f"shard {s}: lossy routing — {got.size} slots "
                         f"filled for {want.size} real tokens")
                    continue
                if not np.array_equal(send[filled], payload[src[filled]]):
                    fail(f"shard {s}: payload corrupted in transit")
                row_owner = np.broadcast_to(
                    np.arange(S, dtype=np.int32)[:, None], send.shape)
                if not np.array_equal(row_owner[filled], owner[src[filled]]):
                    fail(f"shard {s}: slot landed in the wrong owner bucket")
    return findings


# --------------------------------------------------------------------------
# CC005: serving bytes against what the row assemblies move
# --------------------------------------------------------------------------

_INFER = "src/repro_torch/serve/infer.py"
_SERVE_GEOM = dict(S=4, V=40, K=16, B=6, L=10)


class _Block:
    """A phi block that records each gather from it (the ids it is sent
    and the rows it sends back)."""

    def __init__(self, rows, owner: int, log: list):
        self.rows, self.owner, self.log = rows, owner, log

    @property
    def device(self):
        return self.rows.device

    def __getitem__(self, ids):
        out = self.rows[ids]
        self.log.append((self.owner, ids.numel(), out.numel()
                         * out.element_size()))
        return out


def check_serving_bytes(overrides: dict | None = None) -> list[Finding]:
    """CC005 on CPU shards: ``psum_gather_bytes`` must be a ring all-reduce
    (2 (S - 1) x) of the (B, L, K) int32 partial each shard's gather in
    ``_rows_psum`` makes, and the plan's id and row bytes the (C,) int32
    buckets and (C, K) int32 rows ``_rows_routed`` exchanges between
    different shards, C the plan's capacity (the plan's per-document
    result gather, the reference's all-gather, bounds the port's copies of
    each slice's results to the lead).  Both assemblies must return the
    dense gather's rows.  ``overrides`` may replace geometry keys or plant
    stale plan numbers (``a2a_bytes`` / ``psum_bytes``)."""
    import dataclasses
    import types

    from repro_torch.distributed import partition
    from repro_torch.serve import infer
    from repro_torch.serve.snapshot import shard_snapshot, snapshot_from_numpy

    g = dict(_SERVE_GEOM)
    g.update(overrides or {})
    S, V, K, B, L = g["S"], g["V"], g["K"], g["B"], g["L"]
    rng = np.random.default_rng(3)
    phi = rng.integers(0, 5, (V, K)).astype(np.int32)
    snap = snapshot_from_numpy(phi, phi.sum(0).astype(np.int32), 0.1, 0.01,
                               V, device="cpu")
    sh = shard_snapshot(snap, S, devices=("cpu",) * S)
    tokens = rng.integers(0, V, (B, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, B)
    mask = np.arange(L)[None, :] < lens[:, None]
    plan = partition.plan_token_routing(sh.host_word_shard_of, tokens, mask,
                                        S, K)
    plan = dataclasses.replace(plan, a2a_bytes=g.get("a2a_bytes",
                                                     plan.a2a_bytes),
                               psum_bytes=g.get("psum_bytes",
                                                plan.psum_bytes))
    findings: list[Finding] = []

    def fail(msg, comm):
        findings.append(Finding(CHECKER, "CC005", _INFER, 0, msg,
                                scope=f"serve:{comm}:bytes"))

    tok = torch.from_numpy(tokens).long()
    msk = torch.from_numpy(mask)
    dense = torch.from_numpy(phi)[tok] * msk[..., None]
    log: list = []
    fake = types.SimpleNamespace(
        phi_blocks=[_Block(b, o, log) for o, b in enumerate(sh.phi_blocks)],
        replicas=sh.replicas, device=sh.device, num_shards=S, num_topics=K)

    rows = infer._rows_psum(fake, tok)
    if not torch.equal(rows * msk[..., None], dense):
        fail("_rows_psum's rows differ from the dense gather", "psum")
    partial = {nbytes for _, _, nbytes in log}
    if partial != {B * L * K * 4} or \
            plan.psum_bytes != 2 * (S - 1) * B * L * K * 4:
        fail(f"psum_bytes {plan.psum_bytes} is not a ring all-reduce of "
             f"the {sorted(partial)} B partials _rows_psum gathers "
             f"(2 (S - 1) x)", "psum")

    moved, starts_per = 0, partition.doc_slice_bounds(B, S)
    starts, per = starts_per
    for s, rep in enumerate(sh.replicas):
        sl = slice(int(starts[s]), int(starts[s]) + per)
        log.clear()
        got = infer._rows_routed(fake, rep, tok[sl], msk[sl], plan.capacity)
        if not torch.equal(got, dense[sl]):
            fail(f"slice {s}: _rows_routed's rows differ from the dense "
                 "gather", "all2all")
        moved += sum(4 * n_ids + nbytes for owner, n_ids, nbytes in log
                     if owner != s)
    off = S * (S - 1)
    results = 4 * off * (per * K + 2 * per)
    if moved != plan.a2a_bytes - results:
        fail(f"the buckets and rows _rows_routed moves between shards, "
             f"{moved} B, are not the plan's {plan.a2a_bytes - results} B "
             "of ids and rows", "all2all")
    if (S - 1) * per * (K + 2) * 4 > results:
        fail("the slices' results copied to the lead exceed the plan's "
             "result gather", "all2all")
    return findings


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def run(root: Path) -> list[Finding]:
    findings: list[Finding] = []
    for rel, contracts in SCOPE_CONTRACTS.items():
        path = Path(root) / rel
        if path.exists():
            findings.extend(scan_module(path, rel, contracts))
    findings.extend(check_training_wires())
    findings.extend(check_byte_wire())
    findings.extend(check_route_roundtrip())
    findings.extend(check_serving_bytes())
    return findings
