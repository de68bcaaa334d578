"""dtype-flow checker (DT001-DT004), pointed at the port.

C7 stores topic assignments and the ELL in int16 and syncs count deltas
as int16 bytes — narrow integer widths are a deliberate bandwidth choice,
which makes silent wraparound the likeliest way the port corrupts counts at
paper scale while staying green on toy tests.  This pass walks the Python
side of ``src/repro_torch/core`` and ``src/repro_torch/kernels`` at the
AST level and pins every narrow-width decision to an **executed witness**
at Table-3 ``FULL`` geometry of both configs (NYTimes, PubMed):

*  every narrowing or dynamic-width cast — ``.to(torch.int16)``,
   ``.short()``, ``.to(cfg.topic_dtype)``, a ``uint8`` view of the byte
   wire, a constructor with ``dtype=torch.int16`` — must be a declared
   site (``DECLARED``) whose witness proves the values fit (DT001);
*  chained casts that lose width mid-chain are flat errors (DT002);
*  flattened index arithmetic (``a * B + c`` not widened to int64 first,
   index arithmetic inside a subscript) must be declared against a bound
   witness at full corpus scale (DT003);
*  count scatters (``index_add_``, ``scatter_add_``) must accumulate in
   integers — float32 is exact only to 2^24, below both corpora's token
   counts (DT004).

One witness reads the CUDA sources: every flat offset a ``.cu`` kernel
forms into device memory either is formed in int64 or stays under 2^31 at
``FULL`` dims.  The witnesses run unconditionally and keep clearing the
real tree only while the guards they probe (``LDAConfig``'s topic-dtype
check, ``updates.ell_dtype``, the heavy-row int32 sync) stay wired.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from .astutil import ScopedVisitor, dotted, leaf_name
from .report import Finding

CHECKER = "dtype-flow"

TARGET_DIRS = ("src/repro_torch/core", "src/repro_torch/kernels")
# kernels/*/contract.py compute launch geometry in Python ints (no fixed
# width): analysis metadata, not a path any tensor takes
SKIP_NAMES = ("contract.py",)

_WIDTH = {
    "int8": 8, "int16": 16, "int32": 32, "int64": 64,
    "uint8": 8, "uint16": 16, "uint32": 32, "uint64": 64,
    "float16": 16, "bfloat16": 16, "float32": 32, "float64": 64,
    "short": 16, "int": 32, "long": 64, "half": 16, "float": 32,
    "double": 64,
}
_ALIAS = {"short": "int16", "int": "int32", "long": "int64",
          "half": "float16", "float": "float32", "double": "float64"}
_NARROW = {"int8", "int16", "uint8", "uint16"}
_INTS = {t for t in _WIDTH if t.startswith(("int", "uint"))}
# Tensor methods that cast: x.short() etc.
_CAST_METHODS = {"short": "int16", "char": "int8", "byte": "uint8",
                 "int": "int32", "long": "int64"}
_CTORS = {"zeros", "ones", "full", "empty", "tensor", "as_tensor", "arange",
          "zeros_like", "ones_like", "full_like", "empty_like"}
_SCATTERS = {"index_add_", "scatter_add_", "index_put_"}


@dataclasses.dataclass(frozen=True)
class Event:
    """One AST-level dtype event, pre-declaration-filtering."""
    code: str
    line: int
    scope: str
    message: str


# (module, dotted scope, rule) -> witness id.  An event at a declared site
# is vouched for by its witness; anywhere else it is a finding.
# Declarations that no longer match any event are reported too.
DECLARED: dict[tuple[str, str, str], str] = {
    # topic ids: values in [0, K); LDAConfig.__post_init__ guarantees K-1
    # fits topic_dtype, updates.ell_dtype picks int16 only where K and the
    # longest document fit
    ("src/repro_torch/core/trainer.py", "init_state", "DT001"):
        "topic-id-fits-dtype",
    ("src/repro_torch/core/trainer.py", "state_from_numpy", "DT001"):
        "topic-id-fits-dtype",
    ("src/repro_torch/core/updates.py", "ell_topk", "DT001"):
        "topic-id-fits-dtype",
    ("src/repro_torch/core/sampler.py", "sample_tiles", "DT001"):
        "topic-id-fits-dtype",
    ("src/repro_torch/core/dense_sampler.py", "sample_tiles_dense", "DT001"):
        "topic-id-fits-dtype",
    ("src/repro_torch/kernels/lda_sample/ops.py", "lda_sample", "DT001"):
        "topic-id-fits-dtype",
    ("src/repro_torch/kernels/phi_update/ops.py", "_args", "DT001"):
        "topic-id-fits-dtype",
    # the ELL (counts and topics) in updates.ell_dtype: int16 only where K
    # and the longest document fit
    ("src/repro_torch/core/updates.py", "ell_topk", "DT001"):
        "ell-fits-dtype",
    # the int16 byte wire (the delta cast to int16, its uint8 views):
    # exact below the flux bound, int32 heavy-row path above it — the
    # witness executes both
    ("src/repro_torch/core/sync.py", "compressed_sync_phi", "DT001"):
        "compressed-flux-int32-path",
    ("src/repro_torch/core/sync.py", "compressed_sync_phi.finish", "DT001"):
        "compressed-flux-int32-path",
    # two-level search flattening: b_idx * B + in_b == k < K
    ("src/repro_torch/core/sampler.py", "_blocked_search_rows", "DT003"):
        "index-topic-bound",
    ("src/repro_torch/kernels/fold_in/ref.py", "fold_in_docs_ref.sweep",
     "DT003"): "index-topic-bound",
    # host tiling (int64 numpy) and micro-chunk slices m*nc:(m+1)*nc, whose
    # largest index is the padded tile count; the pad of word ids is zeros
    ("src/repro_torch/core/corpus.py", "tile_shard", "DT003"):
        "index-tile-bound",
    ("src/repro_torch/kernels/phi_update/ops.py",
     "shard_chunk_segments.build", "DT003"): "index-tile-bound",
    ("src/repro_torch/kernels/phi_update/ops.py",
     "shard_chunk_segments.build", "DT001"): "index-tile-bound",
}


# --------------------------------------------------------------------------
# AST pass
# --------------------------------------------------------------------------

def _widened(node: ast.AST) -> bool:
    """``x.long()``, ``x.to(torch.int64)``, ``torch.int64``-typed calls:
    an operand formed in int64."""
    if not isinstance(node, ast.Call) or not isinstance(node.func,
                                                       ast.Attribute):
        return False
    if node.func.attr == "long":
        return True
    if node.func.attr == "to":
        args = list(node.args) + [kw.value for kw in node.keywords]
        return any((dotted(a) or "").endswith("int64") for a in args)
    return False


class _DtypeVisitor(ScopedVisitor):
    def __init__(self) -> None:
        super().__init__()
        self._envs: list[dict[str, tuple[str, str]]] = [{}]
        self.events: list[Event] = []

    def _push(self, name: str, node: ast.AST) -> None:
        self._envs.append(dict(self._envs[-1]))
        super()._push(name, node)
        self._envs.pop()

    @property
    def _env(self) -> dict[str, tuple[str, str]]:
        return self._envs[-1]

    def _emit(self, code: str, node: ast.AST, message: str) -> None:
        self.events.append(Event(code, getattr(node, "lineno", 0),
                                 self.scope or "<module>", message))

    # -- dtype token resolution -------------------------------------------
    def _dtype_token(self, node: ast.AST) -> str | None:
        """'int16' etc. for static dtypes (``torch.int16``), 'dynamic' for
        inherited widths (``x.dtype``, ``cfg.topic_dtype``, a ``dtype``
        parameter), None for anything else (a device, a tensor)."""
        if isinstance(node, ast.Attribute):
            base = dotted(node.value) or ""
            if node.attr in _WIDTH and base.split(".")[0] in ("torch", "np",
                                                             "numpy"):
                return _ALIAS.get(node.attr, node.attr)
            if node.attr.lower().endswith("dtype"):
                return "dynamic"
            return None
        if isinstance(node, ast.Name):
            if node.id.lower().endswith("dtype"):
                return "dynamic"
            kind_tok = self._env.get(node.id)
            if kind_tok and kind_tok[0] == "dtype":
                return kind_tok[1]
            return None
        if isinstance(node, ast.IfExp):
            a = self._dtype_token(node.body)
            b = self._dtype_token(node.orelse)
            return a if a == b else None
        return None

    def _call_dtype(self, node: ast.Call) -> str | None:
        """The dtype a call asks for by a ``dtype=`` keyword."""
        for kw in node.keywords:
            if kw.arg == "dtype":
                return self._dtype_token(kw.value)
        return None

    def _array_dtype(self, node: ast.AST) -> str | None:
        """dtype token of a ``torch.zeros/full/...(..., dtype=)`` call."""
        if isinstance(node, ast.Call) and leaf_name(node.func) in _CTORS:
            return self._call_dtype(node)
        return None

    # -- alias tracking ----------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            tok = self._dtype_token(node.value)
            if tok and tok != "dynamic":
                self._env[name] = ("dtype", tok)
            else:
                arr = self._array_dtype(node.value)
                if arr:
                    self._env[name] = ("array", arr)
                else:
                    self._env.pop(name, None)
        self.generic_visit(node)

    # -- events ------------------------------------------------------------
    def _cast_token(self, node: ast.Call) -> str | None:
        """The width a cast call asks for: ``.to(dtype)``, ``.view(dtype)``,
        ``.short()``..., or a constructor's ``dtype=``."""
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in ("to", "view", "type") and (node.args
                                                     or node.keywords):
                for a in node.args:
                    tok = self._dtype_token(a)
                    if tok:
                        return tok
                return self._call_dtype(node)
            if f.attr in _CAST_METHODS and not node.args:
                return _CAST_METHODS[f.attr]
        if leaf_name(f) in _CTORS:
            # a constructor narrows only into a static narrow type; one of
            # another tensor's dtype (zeros like it) casts no value
            tok = self._call_dtype(node)
            return None if tok == "dynamic" else tok
        return None

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        tok = self._cast_token(node)
        if tok in _NARROW:
            self._emit("DT001", node,
                       f"narrowing to {tok} — values outside {tok} range "
                       "wrap silently; needs a declared range witness")
        elif tok == "dynamic":
            self._emit("DT001", node,
                       f"dynamic-width cast ({ast.unparse(node)[:60]}) "
                       "inherits int16 under the default topic_dtype; needs "
                       "a declared range witness")
        if (tok in _INTS and isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Call)):
            tok0 = self._cast_token(f.value)
            if tok0 in _INTS and _WIDTH[tok] < _WIDTH[tok0]:
                self._emit("DT002", node,
                           f"cast chain to {tok0} then {tok} silently drops "
                           f"{_WIDTH[tok0] - _WIDTH[tok]} bits — cast once "
                           "at the final width")
        if isinstance(f, ast.Attribute) and f.attr in _SCATTERS:
            self._check_scatter(node, f.value)
        self.generic_visit(node)

    def _check_scatter(self, node: ast.Call, acc: ast.AST) -> None:
        tok = self._array_dtype(acc)
        if tok is None and isinstance(acc, ast.Name):
            kind_tok = self._env.get(acc.id)
            if kind_tok and kind_tok[0] == "array":
                tok = kind_tok[1]
        if tok and tok.startswith(("float", "bfloat")):
            self._emit("DT004", node,
                       f"count scatter accumulates in {tok}: exact only to "
                       "2^24, below both Table-3 corpora's token counts — "
                       "accumulate in int32 and cast at the end")

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if (isinstance(node.op, ast.Add)
                and isinstance(node.left, ast.BinOp)
                and isinstance(node.left.op, ast.Mult)
                and not any(_widened(x) or isinstance(x, (ast.List,
                                                          ast.Tuple))
                            for x in (node.left.left, node.left.right))):
            self._emit("DT003", node,
                       f"flattened index {ast.unparse(node)!r} not formed in "
                       "int64 — int32 products overflow at 2^31; needs a "
                       "declared bound witness at Table-3 scale")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        for sub in ast.walk(node.slice):
            if (isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mult)
                    and not any(_widened(x) for x in (sub.left, sub.right))):
                self._emit("DT003", node,
                           "index arithmetic inside subscript "
                           f"{ast.unparse(node.slice)!r}; needs a declared "
                           "bound witness at Table-3 scale")
                break
        self.generic_visit(node)


def scan_source(source: str) -> list[Event]:
    v = _DtypeVisitor()
    v.visit(ast.parse(source))
    return v.events


def scan_module(path: Path) -> list[Event]:
    return scan_source(Path(path).read_text())


def apply_declarations(events: list[Event], rel: str,
                       declared: dict | None = None) -> \
        tuple[list[Finding], set[tuple[str, str, str]]]:
    """Events -> findings: DT002/DT004 always fire; DT001/DT003 only at
    undeclared sites.  Returns (findings, matched declaration keys)."""
    declared = DECLARED if declared is None else declared
    findings: list[Finding] = []
    matched: set[tuple[str, str, str]] = set()
    for ev in events:
        key = (rel, ev.scope, ev.code)
        if ev.code in ("DT001", "DT003") and key in declared:
            matched.add(key)
            continue
        findings.append(Finding(CHECKER, ev.code, rel, ev.line, ev.message,
                                scope=ev.scope))
    return findings, matched


# --------------------------------------------------------------------------
# executed witnesses (Table-3 geometry, ``analysis.contracts``)
# --------------------------------------------------------------------------

def _corpora():
    from .contracts import CORPORA, table3_geometry
    return [table3_geometry(name) for name in CORPORA]


def _w_topic_fits() -> list[str]:
    """Topic ids fit topic_dtype for the shipped configs, and LDAConfig
    *rejects* a K that would not (the guard every topic-id cast leans
    on)."""
    import importlib

    import torch

    from repro_torch.core.trainer import LDAConfig

    probs = []
    for g in _corpora():
        cfg = importlib.import_module(f"repro_torch.configs.lda_{g.name}"
                                      ).CONFIG
        mx = int(torch.iinfo(cfg.topic_dtype).max)
        if cfg.num_topics - 1 > mx:
            probs.append(f"{g.name}: K-1={cfg.num_topics - 1} exceeds "
                         f"topic_dtype max {mx}")
    try:
        LDAConfig(num_topics=(1 << 15) + 1)
        probs.append("LDAConfig accepts num_topics=32769 with the int16 "
                     "default topic_dtype — init_state would wrap topic ids "
                     "silently")
    except ValueError:
        pass
    try:
        LDAConfig(num_topics=(1 << 15) + 1, topic_dtype=torch.int32)
    except ValueError as exc:
        probs.append(f"int32 escape hatch rejected: {exc}")
    return probs


def _w_ell_fits() -> list[str]:
    """The ELL type ``updates.ell_dtype`` picks holds every topic id and
    every count (a count is at most the document's length) at ``FULL``
    scale of both configs, and it picks int32 where they would not fit."""
    import torch

    from repro_torch.core.updates import ell_dtype

    probs = []
    for g in _corpora():
        dt = ell_dtype(g.num_topics, g.max_doc_length)
        mx = int(torch.iinfo(dt).max)
        if max(g.num_topics - 1, g.max_doc_length) > mx:
            probs.append(f"{g.name}: ELL {dt} cannot hold K-1="
                         f"{g.num_topics - 1} / the longest document "
                         f"{g.max_doc_length}")
    for K, length in ((1024, 1 << 15), ((1 << 15) + 1, 10)):
        if ell_dtype(K, length) != torch.int32:
            probs.append(f"ell_dtype(K={K}, longest={length}) is not int32 "
                         "— the ELL would wrap")
    return probs


class _OneRank:
    """``torch.distributed`` as one rank sees a group of one: each
    collective leaves its input where a real one would put the result."""

    class _Done:
        def wait(self):
            return None

    def get_world_size(self, group=None):
        return 1

    def all_to_all_single(self, out, inp, group=None, async_op=False):
        out.copy_(inp)
        return self._Done()

    def all_gather_into_tensor(self, out, inp, group=None, async_op=False):
        out.copy_(inp)
        return self._Done()

    def all_reduce(self, x, group=None, async_op=False):
        return self._Done()


def _w_compressed_flux() -> list[str]:
    """Execute the int16 byte wire of ``sync.compressed_sync_phi`` on a
    group of one: a planted per-entry flux of 40000 (> 2^15) must wrap on
    the plain path — that wrap is *why* the heavy-row path exists — and
    come back exact through ``heavy_rows``; the trainer must thread heavy
    rows in."""
    import inspect

    import torch

    from repro_torch.core import sync
    from repro_torch.core import trainer as core_trainer
    from repro_torch.distributed import partition

    probs = []
    if partition.INT16_FLUX_BOUND != 1 << 15:
        probs.append("INT16_FLUX_BOUND moved off 2^15 — the exactness "
                     "argument in sync.compressed_sync_phi no longer holds")
    delta = torch.zeros((4, 3), dtype=torch.int32)
    delta[1, 2], delta[2, 0] = 40000, -30000
    real, group = sync.dist, object()      # any group: _OneRank's
    sync.dist = _OneRank()
    try:
        wrapped = sync.compressed_sync_phi(delta.clone(), group)
        exact = sync.compressed_sync_phi(
            delta.clone(), group, torch.tensor([1, 2], dtype=torch.int32))
    finally:
        sync.dist = real
    if int(wrapped[1, 2]) == 40000:
        probs.append("planted 40000 delta survived the plain int16 path — "
                     "the wrap this witness guards against did not "
                     "reproduce; witness is stale")
    if not torch.equal(exact, delta) or exact.dtype != torch.int32:
        probs.append(f"heavy-row int32 correction not exact: entry (1,2) "
                     f"came back {int(exact[1, 2])}, want 40000")
    if "heavy_rows" not in inspect.signature(
            core_trainer.lda_iteration).parameters:
        probs.append("lda_iteration has no heavy_rows parameter — the "
                     "heavy-word int32 path is not wired into training")
    if not hasattr(partition, "heavy_word_rows"):
        probs.append("partition.heavy_word_rows missing — DistributedLDA "
                     "cannot derive the int32-sync rows")
    return probs


def _w_index_topic() -> list[str]:
    """b_idx * B + in_b reconstructs k exactly and stays under int32 and
    topic_dtype bounds at the shipped K."""
    from repro_torch.core import sampler

    probs = []
    for g in _corpora():
        K = g.num_topics
        Bb = sampler.pick_search_block(K)
        bound = (-(-K // Bb) - 1) * Bb + (Bb - 1)
        if bound >= 1 << 31:
            probs.append(f"{g.name}: flattened search index bound {bound} "
                         "overflows int32")
        if (-(-K // Bb) - 1) * Bb + (K - 1) % Bb != K - 1:
            probs.append(f"{g.name}: block decomposition does not "
                         f"reconstruct k=K-1 (K={K}, B={Bb})")
    return probs


def _w_index_tile() -> list[str]:
    """Tile and slot indices (the tiling's ``tile * t + slot``, micro-chunk
    slices) stay under 2^31 at ``FULL`` scale, with one short tile per word
    as worst-case padding."""
    probs = []
    for g in _corpora():
        t = g.tile_tokens
        n_tiles = -(-g.num_tokens // t) + g.num_words
        if n_tiles * t >= 1 << 31:
            probs.append(f"{g.name}: {n_tiles} tiles x {t} slots overflow "
                         "the int32 slot index")
    return probs


def _w_count_scatter() -> list[str]:
    """Count accumulators are int32 (F3: torch widens an integer sum to
    int64 unless told; float32 is exact only to 2^24 < both corpora's T)
    and int32 still covers the Table-3 token counts."""
    import torch

    from repro_torch.core import updates

    probs = []
    z = torch.tensor([[1, 2, 3]], dtype=torch.int16)
    mask = torch.ones((1, 3), dtype=torch.bool)
    outs = dict(
        phi_from_z=updates.phi_from_z(z, torch.tensor([0], dtype=torch.int32),
                                      mask, 2, 4),
        theta_from_z=updates.theta_from_z(
            z, torch.zeros((1, 3), dtype=torch.int32), mask, 2, 4),
        phi_totals=updates.phi_totals(torch.ones((2, 4), dtype=torch.int32)))
    for name, out in outs.items():
        if out.dtype != torch.int32:
            probs.append(f"updates.{name} accumulates counts in {out.dtype}"
                         " — the counts must stay int32")
    for g in _corpora():
        if g.num_tokens >= 1 << 31:
            probs.append(f"{g.name}: T={g.num_tokens} no longer fits the "
                         "int32 count accumulators")
        if g.num_tokens <= 1 << 24:
            probs.append(f"{g.name}: T={g.num_tokens} under 2^24; DT004's "
                         "premise needs revisiting")
    return probs


class _Recorder:
    """Stands in for a count array: records the flat index it is given."""

    def index_add_(self, dim, index, source):
        self.index = index
        return self


def _w_flat_index_int64() -> list[str]:
    """``updates._scatter_counts`` forms the flat index row * K + topic in
    int64: executed at the largest (doc, topic) of each ``FULL`` theta
    (PubMed's D * K passes 2^31) and (word, topic) of its phi."""
    import torch

    from repro_torch.core import updates

    probs = []
    for g in _corpora():
        K = g.num_topics
        for what, rows in (("theta", g.num_docs), ("phi", g.num_words)):
            rec = _Recorder()
            updates._scatter_counts(
                torch.tensor([rows - 1], dtype=torch.int32),
                torch.tensor([K - 1], dtype=torch.int16),
                torch.ones(1, dtype=torch.bool), rows, K, out=rec)
            want = rows * K - 1
            if rec.index.dtype != torch.int64 or int(rec.index[0]) != want:
                probs.append(f"{g.name} {what}: flat index of ({rows - 1}, "
                             f"{K - 1}) came out {int(rec.index[0])} "
                             f"({rec.index.dtype}), want {want} in int64")
    return probs


# Flat offsets the CUDA kernels form into device memory, as written in
# the source, with the largest value each takes: the dims are the largest
# of both configs at ``FULL`` scale (tiles T/t + V, docs, words) and of the
# serving buckets (B <= 32 docs, L <= 256, 12 sweeps).  An offset formed in
# int64 passes whatever its bound; any other must stay under 2^31.
CUDA_SOURCES = {
    "lda_sample": "src/repro_torch/kernels/lda_sample/csrc/lda_sample.cu",
    "phi_update": "src/repro_torch/kernels/phi_update/csrc/phi_update.cu",
    "fold_in": "src/repro_torch/kernels/fold_in/csrc/fold_in.cu",
}
# a product of an index and one of these dims, read off the source
_CU_PRODUCT = re.compile(
    r"(\(int64_t\)\s*|\(size_t\)\s*)?(\(?[A-Za-z_][\w.]*(?:\s*\*\s*"
    r"[A-Za-z_][\w.]*)*\)?)\s*\*\s*(K|L|P|t|n_sweeps)\b")


def cuda_offset_bounds(dims: dict) -> dict[str, dict[str, int]]:
    """kernel -> {the offset's text in the source: its largest value}."""
    D, V, T, K = dims["docs"], dims["words"], dims["slots"], dims["K"]
    P, t, B, L, S = dims["P"], dims["t"], dims["B"], dims["L"], dims["S"]
    return {
        "lda_sample": {
            "(int64_t)run.w * P": D * P,            # the ELL row
            "(int64_t)tile * t": T,                 # a tile's first slot
            "(int64_t)word * K": V * K,             # a phi row
            "d * P": D * P,                         # d is int64_t
        },
        "phi_update": {
            "(int64_t)seg.x * t": T,                # a segment's slots
            "(int64_t)seg.y * t": T,
            "(int64_t)seg.z * K": V * K,            # its word's phi row
            "(int64_t)w * K": V * K,                # a row to zero
            "(size_t)warp * K": 8 * K,              # shared histograms
            "(size_t)V * K": V * K,                 # K2's memset
        },
        "fold_in": {
            "((int64_t)b * L + l0) * K": B * L * K,  # the doc's rows
            "(int64_t)b * L": B * L,                # z0, mask, z out
            "(int64_t)i * K": L * K,                # a token's row
            "(((int64_t)b * n_sweeps + sweep) * L + l0) * 2": B * S * L * 2,
            "(int64_t)b * K": B * K,                # theta out
            "buf * K": 2 * K,                       # shared: two buffers
            "(buf ^ 1) * K": 2 * K,
        },
    }


def _cu_products(source: str) -> list[tuple[int, str, bool, str]]:
    """(line, text, widened, the line's code) of each product of an index
    and a dim in ``source``'s code (comments dropped)."""
    out = []
    for no, line in enumerate(source.splitlines(), 1):
        code = line.split("//")[0]
        for m in _CU_PRODUCT.finditer(code):
            out.append((no, m.group(0).strip(), m.group(1) is not None,
                        " ".join(code.split())))
    return out


def check_cuda_offsets(sources: dict[str, str], bounds: dict,
                       int64_names: dict[str, set[str]]) -> list[str]:
    """Each declared offset must appear in its source and, unless formed
    in int64, stay under 2^31; a product of an index and a device-memory
    dim that is neither declared, widened, nor an int64 variable is
    reported (an offset the table does not vouch for)."""
    probs = []
    for kernel, src in sources.items():
        declared = bounds[kernel]
        flat = " ".join(src.split())
        for text, bound in declared.items():
            if text not in flat:
                probs.append(f"{kernel}: declared offset {text!r} is not in "
                             "the source — the code moved; update the table")
                continue
            left = text.split("*")[0].strip().lstrip("(")
            wide = ("int64_t" in text or "size_t" in text
                    or left in int64_names[kernel])
            if not wide and bound >= 1 << 31:
                probs.append(f"{kernel}: offset {text!r} reaches {bound} at "
                             "FULL dims in int32 arithmetic — form it in "
                             "int64")
        for no, text, widened, code in _cu_products(src):
            base = text.lstrip("(").split("*")[0].strip().split(".")[-1]
            if widened or base in int64_names[kernel] or base.isdigit():
                continue
            # declared: a declared offset on this line holds the product
            if not any(text in d and d in code for d in declared):
                probs.append(f"{kernel}:{no}: product {text!r} is neither "
                             "formed in int64 nor declared with its bound")
    return probs


def _int64_names(source: str) -> set[str]:
    """Variables the source declares as ``int64_t`` or ``size_t``."""
    return set(re.findall(r"\b(?:int64_t|size_t)\s+([A-Za-z_]\w*)\s*[=;,)]",
                          source))


def _w_cuda_offsets(root: Path) -> list[str]:
    """Every flat device-memory offset of K1-K4 at ``FULL`` dims of both
    configs either fits int32 or is formed in int64."""
    gs = _corpora()
    dims = dict(docs=max(g.num_docs for g in gs),
                words=max(g.num_words for g in gs),
                slots=max((-(-g.num_tokens // g.tile_tokens) + g.num_words)
                          * g.tile_tokens for g in gs),
                K=max(g.num_topics for g in gs),
                P=max(g.ell_capacity for g in gs),
                t=max(g.tile_tokens for g in gs), B=32, L=256, S=12)
    sources = {k: (Path(root) / rel).read_text()
               for k, rel in CUDA_SOURCES.items()}
    return check_cuda_offsets(sources, cuda_offset_bounds(dims),
                              {k: _int64_names(s) for k, s in
                               sources.items()})


# (rule, anchor module, anchor scope, witness id, fn) — all run on every
# checker invocation; each returned problem string becomes a finding.
WITNESSES = (
    ("DT001", "src/repro_torch/core/trainer.py", "init_state",
     "topic-id-fits-dtype", _w_topic_fits),
    ("DT001", "src/repro_torch/core/updates.py", "ell_dtype",
     "ell-fits-dtype", _w_ell_fits),
    ("DT001", "src/repro_torch/core/sync.py", "compressed_sync_phi",
     "compressed-flux-int32-path", _w_compressed_flux),
    ("DT003", "src/repro_torch/core/sampler.py", "_blocked_search_rows",
     "index-topic-bound", _w_index_topic),
    ("DT003", "src/repro_torch/core/corpus.py", "tile_shard",
     "index-tile-bound", _w_index_tile),
    ("DT003", "src/repro_torch/core/updates.py", "_scatter_counts",
     "flat-index-int64", _w_flat_index_int64),
    ("DT003", "src/repro_torch/kernels", "csrc",
     "cuda-flat-offsets", _w_cuda_offsets),
    ("DT004", "src/repro_torch/core/updates.py", "phi_from_z",
     "count-scatter-int32", _w_count_scatter),
)


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def run(root: Path) -> list[Finding]:
    import inspect

    findings: list[Finding] = []
    matched: set[tuple[str, str, str]] = set()
    for target in TARGET_DIRS:
        base = Path(root) / target
        if not base.is_dir():
            continue
        for path in sorted(base.rglob("*.py")):
            if path.name in SKIP_NAMES:
                continue
            rel = path.relative_to(root).as_posix()
            try:
                events = scan_module(path)
            except SyntaxError as exc:
                findings.append(Finding(
                    CHECKER, "DT001", rel, exc.lineno or 0,
                    f"unparseable module: {exc.msg}", scope="<module>"))
                continue
            fs, m = apply_declarations(events, rel)
            findings.extend(fs)
            matched.update(m)

    known_witnesses = {w[3] for w in WITNESSES}
    for key, witness in sorted(DECLARED.items()):
        rel, scope, code = key
        if key not in matched:
            findings.append(Finding(
                CHECKER, code, rel, 0,
                f"declared {code} site matched no event — the code moved; "
                "drop or update the declaration", scope=scope))
        if witness not in known_witnesses:
            findings.append(Finding(
                CHECKER, code, rel, 0,
                f"declaration names unknown witness {witness!r}",
                scope=scope))

    for code, rel, scope, wid, fn in WITNESSES:
        try:
            probs = fn(root) if inspect.signature(fn).parameters else fn()
        except Exception as exc:
            probs = [f"witness {wid!r} crashed: {exc!r}"]
        findings.extend(Finding(CHECKER, code, rel, 0,
                                f"[{wid}] {p}", scope=scope)
                        for p in probs)
    return findings
