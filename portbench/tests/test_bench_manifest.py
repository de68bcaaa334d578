"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by the names it gives."""
import importlib
import json
import re

import pytest

from portbench import run

M = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\n\t]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.fullmatch(p) and ".." not in p and not p.startswith("/")
    assert not M["paths"][0].endswith("_torch")
    assert len(json.dumps(M)) <= 64 * 1024


def test_run_seconds_fits_a_check_of_24_cells():
    r = M["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(entry["name"])
    assert TEXT.fullmatch(entry["source"]) and TEXT.fullmatch(entry["why"])
    assert entry["file"].startswith(M["paths"][0] + "/")
    cfg = run.load_json(run.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.fullmatch(key) and key in cfg
        assert not key.endswith(("_dim", "_rank"))


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda c: c["name"])
def test_cell_files_found(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.fullmatch(cell["name"]) and NAME.fullmatch(cell["traffic"])
    assert cell["chips"] in (1, 4) and TEXT.fullmatch(cell["why"])
    files = run.load_cell(M, cell["name"])
    assert files["traffic"]["ranks"] == cell["chips"]
    kind = importlib.import_module(
        f"portbench.kinds.{files['traffic']['kind']}")
    assert callable(kind.run) and callable(kind.report)
    assert list(files["limits"]) == list(kind.CHECKS)
    for trace in (False, True):
        metrics = run.cell_metrics(M, cell["name"], trace)
        assert metrics
        for m in metrics:
            assert callable(run.reader(m["name"]))
    names = {m["name"] for m in run.cell_metrics(M, cell["name"], False)}
    assert "setup_s" in names and len(names) >= 2


def test_pairs_and_names_unique():
    cells = M["workloads"]
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    names = [c["name"] for c in cells] + [c["name"] for c in M["configs"]]
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(names)) == len(names)
    assert len(set(metrics)) == len(metrics)
    assert {c["config"] for c in cells} == {c["name"] for c in M["configs"]}
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in M["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert TEXT.fullmatch(metric["layer"])
        assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
    assert set(metric) - {"workloads"} == keys
    assert NAME.fullmatch(metric["name"]) and UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
    cells = {c["name"] for c in M["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert (run.HERE / "metrics" / f"{metric['name']}.py").exists()


def test_setup_bound():
    setup = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25


def test_exact_readings_have_the_limit_0():
    for cell in M["workloads"]:
        limits = run.load_cell(M, cell["name"])["limits"]
        for exact in ("layout_errors", "phi_errors", "ell_errors"):
            if exact in limits:
                assert limits[exact] == 0, (cell["name"], exact)
