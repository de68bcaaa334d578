"""repro_torch.analysis: each of the port's five checkers flags a planted
fault and stays quiet on the fixed version and on the real port tree; the
lock checker and the report / baseline logic give the reference's findings
on the reference's own snippets (tests/test_analysis.py); the CLI gates on
the empty ``analysis-baseline-torch.json``."""
import importlib.util
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.analysis import locks as ref_locks
from repro.analysis.report import Finding as RefFinding
from repro.analysis.report import build_report as ref_build_report
from repro_torch.analysis import cli
from repro_torch.analysis import collectives as coll
from repro_torch.analysis import dtypes
from repro_torch.analysis import kernel_contract as kc
from repro_torch.analysis import locks, prng
from repro_torch.analysis.contracts import (MAX_SMEM_BYTES, KernelContract,
                                            LaunchCase)
from repro_torch.analysis.report import Finding, build_report

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_tests():
    """tests/test_analysis.py, for its snippets (loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "_ref_analysis_tests", ROOT / "tests" / "test_analysis.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tests()


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

def _closure_engine():
    return REF.BAD_ENGINE.replace(
        "    def leak_write(self):\n        self._pending = 0\n",
        "    def leak_write(self):\n"
        "        with self._lock:\n"
        "            cb = lambda: setattr(self, 'x', self._pending)\n"
        "        return cb\n")


@pytest.mark.parametrize("snippet", ["BAD_ENGINE", "GOOD_ENGINE", "closure"])
def test_lock_checker_matches_reference(snippet):
    src = _closure_engine() if snippet == "closure" else getattr(REF, snippet)
    ours = build_report(locks.check_source(src, "x.py"), ["lock-discipline"],
                        ROOT / "no-baseline.json")
    theirs = ref_build_report(ref_locks.check_source(src, "x.py"),
                              ["lock-discipline"], ROOT / "no-baseline.json")
    assert [(r["code"], r["fingerprint"]) for r in ours["findings"]] == \
        [(r["code"], r["fingerprint"]) for r in theirs["findings"]]
    if snippet == "BAD_ENGINE":
        assert sorted(r["code"] for r in ours["findings"]) == ["LD001",
                                                               "LD002"]


def test_lock_checker_sees_a_conditional_lock():
    """``Lock() if sanitize else nullcontext()`` (the engine's _sync_turn)
    guards like a lock: an access outside it is flagged."""
    src = textwrap.dedent("""
        import contextlib
        import threading

        class Engine:
            def __init__(self, sanitize):
                self._turn = (threading.Lock() if sanitize
                              else contextlib.nullcontext())
                self._n = 0

            def add(self):
                with self._turn:
                    self._n += 1

            def peek(self):
                return self._n
    """)
    found = locks.check_source(src, "x.py")
    assert [(f.code, f.scope) for f in found] == [("LD002", "Engine.peek")]


def test_lock_checker_real_port_clean():
    assert locks.run(ROOT) == []
    assert all((ROOT / t).exists() for t in locks.TARGETS)


# ---------------------------------------------------------------------------
# report / baseline / CLI
# ---------------------------------------------------------------------------

def test_report_and_baseline_match_reference(tmp_path):
    """The same findings give the reference's fingerprints, summary and
    stale-suppression rows (BASE001 names the baseline file it came
    from)."""
    args = dict(checker="prng-discipline", code="PRNG001", path="src/x.py",
                scope="f", message="m")
    base = tmp_path / "b.json"
    fp = "prng-discipline:PRNG001:src/x.py:f#0"
    base.write_text(json.dumps({
        "schema": "repro-analysis-baseline/v1",
        "suppressions": [{"fingerprint": fp}, {"fingerprint": "gone:X:y#1"}],
    }))
    for line in (10, 99):    # fingerprints carry no line numbers
        ours = build_report([Finding(line=line, **args)] * 2, ["p"], base)
        theirs = ref_build_report([RefFinding(line=line, **args)] * 2, ["p"],
                                  base)
        strip = [(r["code"], r["scope"], r["suppressed"])
                 for r in ours["findings"]]
        assert strip == [(r["code"], r["scope"], r["suppressed"])
                         for r in theirs["findings"]]
        assert [r["fingerprint"] for r in ours["findings"][:2]] == \
            [fp, fp[:-1] + "1"]
        assert ours["summary"] == theirs["summary"] == dict(
            total=3, suppressed=1, unsuppressed=2)
        assert ours["stale_suppressions"] == ["gone:X:y#1"]
        assert ours["findings"][-1]["path"] == "b.json"


def test_cli_gates_green_on_the_port(tmp_path):
    out = tmp_path / "report.json"
    assert cli.main(["--root", str(ROOT), "--json", str(out),
                     "--max-seconds", "60"]) == 0
    rep = json.loads(out.read_text())
    assert rep["schema"] == "repro-analysis/v1"
    assert rep["checks"] == ["prng-discipline", "kernel-contract",
                             "lock-discipline", "collective-contract",
                             "dtype-flow"]
    assert rep["summary"]["unsuppressed"] == 0
    assert set(rep["timings"]) == set(rep["checks"]) | {"total"}


def test_committed_baseline_is_empty():
    doc = json.loads((ROOT / "analysis-baseline-torch.json").read_text())
    assert doc == {"schema": "repro-analysis-baseline/v1",
                   "suppressions": []}


def test_cli_stale_suppression_is_base001(tmp_path):
    base, out = tmp_path / "b.json", tmp_path / "r.json"
    base.write_text(json.dumps({
        "schema": "repro-analysis-baseline/v1",
        "suppressions": [{"fingerprint": "lock-discipline:LD001:x.py:E.f#0",
                          "justification": "fixed long ago"}]}))
    args = ["--checks", "lock-discipline", "--root", str(ROOT),
            "--baseline", str(base), "--json", str(out)]
    assert cli.main(args) == 1
    rep = json.loads(out.read_text())
    assert [r["code"] for r in rep["findings"]] == ["BASE001"]
    assert cli.main(args + ["--update-baseline"]) == 0
    assert json.loads(base.read_text())["suppressions"] == []
    assert cli.main(args) == 0


def test_cli_update_baseline_roundtrip_and_crash(tmp_path, monkeypatch):
    root = tmp_path / "repo"
    (root / "src" / "repro_torch").mkdir(parents=True)
    (root / "src" / "repro_torch" / "bad.py").write_text(
        "import torch\n\ndef f():\n    return torch.rand(3)\n")
    base = root / "analysis-baseline-torch.json"
    args = ["--checks", "prng-discipline", "--root", str(root)]
    assert cli.main(args) == 1
    assert cli.main(args + ["--update-baseline"]) == 0
    assert cli.main(args) == 0
    assert len(json.loads(base.read_text())["suppressions"]) == 1

    def boom(root):
        raise RuntimeError("planted")
    monkeypatch.setattr(cli, "_checker", lambda name: boom)
    assert cli.main(args) == 2
    assert cli.main(args + ["--max-seconds", "0"]) == 2


def test_python_m_entry_point():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--checks",
         "lock-discipline", "prng-discipline", "--max-seconds", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 1, res.stderr      # a budget of 0 s is missed
    assert "lock-discipline: 0 finding(s)" in res.stdout
    assert "wall-clock budget exceeded" in res.stderr


# ---------------------------------------------------------------------------
# prng-discipline
# ---------------------------------------------------------------------------

def _prng(src, rel="src/repro_torch/launch/x.py"):
    return [f.code for f in prng.check_source(textwrap.dedent(src), rel)]


@pytest.mark.parametrize("src,rel,codes", [
    ("import torch\ndef f():\n    return torch.rand(3)\n", None,
     ["PRNG001"]),
    ("from torch import randint\ndef f(g):\n    return randint(0, 4, (2,))\n",
     None, ["PRNG001"]),
    ("def f(x):\n    return x.uniform_()\n", None, ["PRNG001"]),
    ("def f(p):\n    return p.multinomial(1)\n", None, ["PRNG001"]),
    ("import torch\ndef f():\n    torch.manual_seed(0)\n", None,
     ["PRNG002"]),
    ("import torch\ndef f():\n    torch.cuda.manual_seed_all(0)\n", None,
     ["PRNG002"]),
    ("import torch\ndef sweep(g):\n    return torch.rand(3, generator=g)\n",
     "src/repro_torch/core/sampler.py", ["PRNG003"]),
    ("import torch\ndef sweep(x):\n    return x.bernoulli_()\n",
     "src/repro_torch/serve/infer.py", ["PRNG001", "PRNG003"]),
], ids=["rand", "imported-randint", "uniform_", "multinomial",
        "manual_seed", "cuda-seed", "raw-sampling-draw", "raw-inplace"])
def test_prng_flags_planted_draws(src, rel, codes):
    assert _prng(src, rel or "src/repro_torch/launch/x.py") == codes


def test_prng_clean_cases():
    src = """
        import torch

        def draw_sweep_uniforms(generator, n, t):
            return torch.rand((n, t, 2), generator=generator)

        def seeded(seed):
            g = torch.Generator()
            g.manual_seed(seed)              # a generator's own seed
            return g
    """
    assert _prng(src, "src/repro_torch/core/sampler.py") == []
    assert prng.run(ROOT) == []


# ---------------------------------------------------------------------------
# kernel-contract
# ---------------------------------------------------------------------------

def test_kernel_contract_flags_planted_launches():
    cases = (
        LaunchCase("ok", (4, 1, 1), 256, 1024),
        LaunchCase("smem", (4, 1, 1), 256, MAX_SMEM_BYTES + 4),
        LaunchCase("threads", (4, 1, 1), 2048, 1024),
        LaunchCase("cluster", (16, 1, 1), 256, 1024, cluster=16),
        LaunchCase("grid-y", (1, 70_000, 1), 256, 1024),
        LaunchCase("cover", (1, 1, 1), 32, 0, coverage=(lambda: ["gap"],)),
        LaunchCase("extra", (1, 1, 1), 32, 0, extra_checks=(lambda: ["x"],)),
    )
    found = kc.check_contract(KernelContract("k", MAX_SMEM_BYTES, cases),
                              "k.py")
    assert [(f.scope, f.code) for f in found] == [
        ("k:smem", "KC001"), ("k:threads", "KC002"), ("k:cluster", "KC002"),
        ("k:grid-y", "KC002"), ("k:cover", "KC003"), ("k:extra", "KC004")]


def test_kernel_contracts_real_tree_clean():
    assert kc.run(ROOT) == []


def test_k1_smem_mirror_and_cases():
    """The mirror of ``lda_sample.cu::layout`` at its known sizes, and the
    matrix covers both Table-3 corpora at their ELL width and type."""
    from repro_torch.kernels.lda_sample import contract, kernel

    assert contract.smem_bytes(256, 1024, 512, 128, 2) == 65632
    assert contract.smem_bytes(256, 1024, 1024, 128, 4) == 180320
    assert kernel.MAX_SMEM_BYTES == MAX_SMEM_BYTES
    names = {c[0]: c for c in contract.cases()}
    assert names["nytimes-full"][4] == 512 and names["pubmed-full"][4] == 256
    assert names["pubmed-full"][5] == 2            # int16 ELL
    assert names["pubmed-full"][1] > 2_900_000     # ~738M tokens in tiles


def test_k3_candidates_within_limits_and_slices_covered():
    from repro_torch.kernels.fold_in import contract

    shapes = contract.candidate_shapes(256)
    assert shapes[0] == (1, 16) and max(c for c, _ in shapes) == 8
    names = [c[0] for c in contract.cases()]
    assert "serve-B32-L256-K1024" in names and "slice-S8-B4-L32-K1024" in names


@pytest.mark.parametrize("fault", ["segment", "zero-row"])
def test_k24_coverage_flags_a_planted_table(monkeypatch, fault):
    """A segment table missing its last segment leaves tiles uncounted; a
    list of rows to zero missing one leaves a phi row unwritten (K4)."""
    from repro_torch.kernels.phi_update import contract, ops

    name = "segment_table" if fault == "segment" else "rows_to_zero"
    real = getattr(ops, name)
    monkeypatch.setattr(ops, name, lambda *a, **k: real(*a, **k)[:-1])
    tw, tf = contract._tiling([3, 0, 300, 1])
    _, check = contract._coverage("planted", tw, tf, 5)
    msg = "tiles lie in no segment" if fault == "segment" else "phi rows"
    assert any(msg in m for m in check())


# ---------------------------------------------------------------------------
# dtype-flow
# ---------------------------------------------------------------------------

def _dt(src):
    return [e.code for e in dtypes.scan_source(textwrap.dedent(src))]


@pytest.mark.parametrize("src,codes", [
    ("def f(z):\n    return z.to(torch.int16)\n", ["DT001"]),
    ("def f(z):\n    return z.short()\n", ["DT001"]),
    ("def f(z):\n    return z.view(torch.uint8)\n", ["DT001"]),
    ("def f(z, cfg):\n    return z.to(cfg.topic_dtype)\n", ["DT001"]),
    ("def f(n):\n    return torch.empty(n, dtype=torch.int16)\n", ["DT001"]),
    ("def f(z):\n    return z.to(torch.int32).to(torch.int16)\n",
     ["DT001", "DT002"]),
    ("def f(r, z, K):\n    return r * K + z\n", ["DT003"]),
    ("def f(x, m, n):\n    return x[m * n]\n", ["DT003"]),
    ("def f(i, v):\n    acc = torch.zeros(4, dtype=torch.float32)\n"
     "    acc.index_add_(0, i, v)\n", ["DT004"]),
], ids=["to-int16", "short", "uint8-view", "dynamic", "ctor", "chain",
        "flat-index", "subscript", "float-scatter"])
def test_dtype_flags_planted_events(src, codes):
    assert _dt(src) == codes


def test_dtype_clean_cases():
    src = """
        def f(r, z, K, n, like):
            a = r.long() * K + z.long()          # formed in int64
            b = z.to(torch.int64)
            c = torch.zeros(n, dtype=like.dtype)  # no value is cast
            d = [0] * 3 + [1] * 2
            return a, b, c, d
    """
    assert _dt(src) == []
    events = dtypes.scan_source("def g(z):\n    return z.to(torch.int16)\n")
    decl = {("m.py", "g", "DT001"): "topic-id-fits-dtype"}
    assert dtypes.apply_declarations(events, "m.py", decl)[0] == []
    assert len(dtypes.apply_declarations(events, "other.py", decl)[0]) == 1


def test_dtype_real_tree_clean():
    assert dtypes.run(ROOT) == []


def test_dtype_cuda_offsets_flag_planted_sources():
    src = ("int* row = out + (int64_t)w * K;\n"
           "int* bad = out + w * K;      // not declared\n"
           "int* q = out + v * K;\n")
    probs = dtypes.check_cuda_offsets(
        {"k": src}, {"k": {"(int64_t)w * K": 1 << 40, "v * K": 1 << 31}},
        {"k": set()})
    assert any("'w * K' is neither" in p for p in probs)
    assert any("'v * K' reaches" in p for p in probs)
    assert dtypes.check_cuda_offsets({"k": src.splitlines()[0]},
                                     {"k": {"(int64_t)w * K": 1 << 40}},
                                     {"k": set()}) == []


def test_dtype_flux_witness_sees_a_broken_heavy_path(monkeypatch):
    from repro_torch.core import sync

    real = sync.compressed_sync_phi
    monkeypatch.setattr(sync, "compressed_sync_phi",
                        lambda d, g, heavy=None, a=False: real(d, g, None))
    assert any("heavy-row int32 correction not exact" in p
               for p in dtypes._w_compressed_flux())


# ---------------------------------------------------------------------------
# collective-contract
# ---------------------------------------------------------------------------

def _coll(src, contracts, tmp_path):
    mod = tmp_path / "planted.py"
    mod.write_text(textwrap.dedent(src))
    return [f.code for f in coll.scan_module(mod, "src/x.py", contracts)]


CONTRACT = {"sync": (frozenset({"data_group"}), frozenset({"int32"}))}


@pytest.mark.parametrize("src,codes", [
    ("def sync(x, model_group):\n"
     "    dist.all_reduce(x, group=model_group)\n", ["CC001"]),
    ("def sync(x):\n    dist.all_reduce(x)\n", ["CC001"]),
    ("def other(x, data_group):\n"
     "    dist.all_reduce(x, group=data_group)\n", ["CC002"]),
    ("def sync(x, data_group):\n"
     "    dist.all_reduce(x, group=data_group)\n"
     "    return torch.gather(x, 0, x)\n", []),
], ids=["wrong-group", "no-group", "undeclared", "clean"])
def test_collectives_ast_rules(src, codes, tmp_path):
    assert _coll(src, CONTRACT, tmp_path) == codes


def test_collectives_flag_int16_and_wrong_group():
    rec = dict(file=str(ROOT / coll._SYNC), scope="maybe_all_reduce",
               call="all_reduce", sent=0)
    found = coll.check_recorded(
        [dict(rec, role="data", dtype="int16", numel=3),
         dict(rec, role="data", dtype="int32", numel=6 * 4),   # theta
         dict(rec, role="model", dtype="int32", numel=5 * 4)],  # phi
        V=5, K=4, D=6)
    assert [f.code for f in found] == ["CC004", "CC001", "CC001"]


def test_collectives_lossy_router_flagged():
    def lossy(owner, payload, S, C):
        from repro_torch.distributed.partition import route_buckets
        send, src = route_buckets(owner, payload, S, C)
        src = src.clone()
        src.view(-1)[0] = owner.shape[0]          # drop one token
        return send, src
    found = coll.check_route_roundtrip(route_fn=lossy, shard_counts=(2,),
                                       batches=((4, 16),))
    assert found and {f.code for f in found} == {"CC003"}


@pytest.mark.parametrize("key", ["a2a_bytes", "psum_bytes"])
def test_collectives_byte_drift_flagged(key):
    found = coll.check_serving_bytes({key: 1})
    assert [f.code for f in found] == ["CC005"]


def test_collectives_byte_wire_drift_flagged():
    from repro_torch.core import sync

    def int16_on_the_wire(delta, group, heavy=None):
        sync.dist.all_reduce(delta.to(torch.int16), group=group)
        return delta
    codes = {f.code for f in coll.check_byte_wire(
        counts=(2,), sync_fn=int16_on_the_wire)}
    assert codes == {"CC002", "CC005"}       # undeclared scope, wrong bytes


def test_collectives_real_tree_clean():
    assert coll.run(ROOT) == []
