"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's files are found by the names ``BENCHMARK.json`` gives:
``portbench/traffic/<traffic>.json`` (its ``kind`` names the runner,
``portbench/kinds/<kind>.py``), the configuration's ``file``,
``portbench/limits/<cell>.json`` (the judge's limits) and one reader a
metric, ``portbench/metrics/<metric>.py``.  With ``--trace 0`` the last
line of standard output is the result with the cell's end-to-end
metrics, with ``--trace 1`` with its per-layer metrics, read from a
``torch.profiler`` trace of the window.  The numbers that decide
``correct`` are printed beside their limits, last on standard error and
last in the result.  Without as many CUDA cards as the cell asks for, or
with JAX or the JAX package loaded, the run prints no result and exits
with 2.
"""
from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def named_file(folder: str, name: str, suffix: str) -> Path:
    """``portbench/<folder>/<name><suffix>``, for a name the manifest
    allows."""
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return HERE / folder / f"{name}{suffix}"


def reader(name: str):
    """The ``read(run)`` function of ``portbench/metrics/<name>.py``."""
    path = named_file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list it, or that list no cells."""
    return [m for m in manifest["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def load_cell(manifest: dict, name: str) -> dict:
    """The cell, its configuration, traffic and limits, from their files."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    return dict(cell=cell,
                config=load_json(ROOT / configs[cell["config"]]["file"]),
                traffic=load_json(named_file("traffic", cell["traffic"],
                                             ".json")),
                limits=load_json(named_file("limits", name, ".json")))


def verdict(readings: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): one check for each entry of
    the cell's limits file, in its order.  A reading passes at or under its
    limit; a limit that the run gave no reading for fails."""
    checks = {k: dict(value=readings.get(k), limit=float(v))
              for k, v in limits.items()}
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values()), checks


def measure(manifest: dict, files: dict, seed: int, seconds: float,
            trace: bool, device: str, start: float, hook: str | None = None
            ) -> tuple[dict, list, list]:
    """One run of a cell on ``device`` ("cuda", or "cpu" for the tests):
    (the result, the lines for standard error, the foreign modules the
    ranks had loaded).  The cell's kind, ``portbench/kinds/<kind>.py``,
    runs it (``run(spec)``, one record a rank) and says what to print of
    it (``report(ranks, start)``); the metrics' readers read the records."""
    import torch

    kind = importlib.import_module(
        f"portbench.kinds.{files['traffic']['kind']}")
    spec = dict(config=files["config"], traffic=files["traffic"], seed=seed,
                seconds=seconds, trace=trace, device=device, hook=hook)
    ranks = kind.run(spec)
    run = dict(ranks=ranks, start=start, trace=trace)
    metrics = {}
    for m in cell_metrics(manifest, files["cell"]["name"], trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    rep = kind.report(ranks, start)
    correct, checks = verdict(rep["readings"], files["limits"])
    result = dict(
        correct=correct, attempted=rep["attempted"],
        failed=0 if correct else 1, metrics=metrics,
        device=dict(platform="gpu" if device == "cuda" else device,
                    kind=(torch.cuda.get_device_name(0) if device == "cuda"
                          else "cpu"),
                    count=len(ranks), **rep["device"]))
    if trace and rep["breakdown"]:
        result["breakdown"] = rep["breakdown"]
    result["checks"] = checks
    notes = rep["notes"] + [f"check {k} {c['value']!r} limit {c['limit']!r}"
                            for k, c in checks.items()]
    return result, notes, rep["foreign"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = load_json(ROOT / "BENCHMARK.json")
    files = load_cell(manifest, args.workload)
    # the package and the port by their names, not this folder's modules
    # by theirs (a module here would shadow one of the standard library's)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]
    import torch

    need = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"the cell needs {need} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, notes, foreign = measure(manifest, files, args.seed, args.seconds,
                              bool(args.trace), "cuda", PROCESS_START)
    from portbench import foreign as foreign_mod

    foreign = sorted(set(foreign) | set(foreign_mod.loaded()))
    if foreign:
        print(f"JAX or the JAX package loaded: {', '.join(foreign)}",
              file=sys.stderr)
        return 2
    for line in notes:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
