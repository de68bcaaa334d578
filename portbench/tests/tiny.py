"""A cell's files cut to a size the CPU tests hold."""
from __future__ import annotations

import time

from portbench import run

TINY = dict(num_docs=300, num_words=500, avg_doc_len=40, num_topics=64)
SEED = 2**33 + 5


def cell(name: str, **traffic) -> tuple[dict, dict]:
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    files = run.load_cell(manifest, name)
    files["config"].update(TINY)
    files["traffic"].update(traffic)
    return manifest, files


def measure(name: str, trace: bool = False, hook=None, seed=SEED,
            **traffic) -> dict:
    manifest, files = cell(name, **traffic)
    result, _, foreign = run.measure(manifest, files, seed, 0.3, trace, "cpu",
                                  time.time(), hook=hook)
    assert not foreign
    return result
