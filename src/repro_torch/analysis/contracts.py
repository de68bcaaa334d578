"""Contract types for the CUDA kernels' launch geometry, and the Table-3
geometry the contracts and the dtype-flow witnesses evaluate at.

Each kernel package exports a ``contract()`` in its ``contract.py`` built
from these types; the ``kernel-contract`` checker reads it.  A case is
derived from the same Python functions the launch uses (the segment table,
the doc slices, the ELL type and width), with a Python mirror wherever the
launch asks the built library (shared-memory layouts, the segment length):
the GPU tests hold each mirror equal to the library.  They replace the
reference's Pallas BlockSpec / VMEM contracts.

Import-light (stdlib and numpy), so ``kernels/*/contract.py`` can import it
without pulling the checkers in.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np

# Hopper (H100) launch limits
MAX_SMEM_BYTES = 232_448         # dynamic shared memory a block can use
MAX_THREADS = 1024               # threads a block
MAX_CLUSTER = 8                  # CTAs a cluster (the portable limit)
MAX_GRID_X = (1 << 31) - 1
MAX_GRID_YZ = 65_535


@dataclasses.dataclass(frozen=True)
class LaunchCase:
    """One launch: its grid (x, y, z), threads a CTA, dynamic shared memory
    a CTA and CTAs a cluster.  ``coverage`` and ``extra_checks`` are
    zero-arg callables returning violation messages: the first that every
    output element is written exactly once (KC003), the second
    kernel-specific invariants (KC004)."""

    name: str
    grid: tuple[int, int, int]
    threads: int
    smem_bytes: int
    cluster: int = 1
    coverage: tuple[Callable[[], Sequence[str]], ...] = ()
    extra_checks: tuple[Callable[[], Sequence[str]], ...] = ()


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Shared-memory budget + representative launches of one kernel."""

    kernel: str                  # e.g. "lda_sample"
    smem_budget_bytes: int
    cases: tuple[LaunchCase, ...]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One paper corpus at Table-3 ``FULL`` scale, as the trainer sees it:
    documents, words, tokens, the longest document (the ELL width P and
    type follow from it) and the word-major tiling's tiles per word."""

    name: str
    num_docs: int
    num_words: int
    num_tokens: int
    max_doc_length: int
    num_topics: int
    tile_tokens: int
    tiles_per_word: np.ndarray   # (V,) int64

    @property
    def num_tiles(self) -> int:
        return int(self.tiles_per_word.sum())

    @property
    def ell_capacity(self) -> int:
        """P as ``core.corpus.ell_capacity`` gives it for this corpus."""
        from repro_torch.core.corpus import ell_width
        return ell_width(self.max_doc_length, self.num_topics)


@functools.lru_cache(maxsize=None)
def table3_geometry(name: str) -> Geometry:
    """``FULL`` scale of ``configs/lda_<name>.py``: the document lengths
    ``data.synthetic.zipf_corpus`` draws first at scale 1.0 (so the longest
    document is the generator's own), and each word's expected Zipf(1.1)
    share of the tokens (the larger of the paper's count and the
    generator's) cut into tiles of ``tile_tokens``."""
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.lda_{name}")
    full, cfg = mod.FULL, mod.CONFIG
    rng = np.random.default_rng(0)
    lengths = np.maximum(1, rng.poisson(full["avg_doc_len"],
                                        size=full["num_docs"]))
    # the larger of the paper's token count and the generator's
    V, t = full["num_words"], cfg.tile_tokens
    T = max(int(full["num_tokens"]), int(lengths.sum()))
    p = np.arange(1, V + 1, dtype=np.float64) ** -1.1
    counts = np.round(p / p.sum() * T).astype(np.int64)
    return Geometry(name=name, num_docs=full["num_docs"], num_words=V,
                    num_tokens=T, max_doc_length=int(lengths.max()),
                    num_topics=cfg.num_topics, tile_tokens=t,
                    tiles_per_word=-(-counts // t))


CORPORA = ("nytimes", "pubmed")
