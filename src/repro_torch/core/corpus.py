"""Corpus representation, workload partition and word-major tiling.

The port's copy of ``repro.core.corpus``: the same host-side numpy
preprocessing gives the same arrays, held as tensors.

* C1 (paper §4): partition-by-document, balanced **by token count**
  (longest-processing-time greedy), so every shard carries the same number
  of tokens, not the same number of documents.
* C6 (§6.1.2): tokens sorted in **word-first order** and cut into fixed-size
  *tiles*: one tile = one word and up to ``tile_tokens`` of its tokens.
  Words with more tokens than a tile span several tiles, heavy words first.
  On the card a tile is one CTA of the sampling kernel, sharing its word's
  p* through shared memory.
* C7 (§6.1.3): topic assignments are stored as int16 (K < 2**16).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Corpus:
    """A bag-of-words corpus in token-stream form (host side, numpy)."""

    doc_ids: np.ndarray  # (T,) int32 — document of each token
    word_ids: np.ndarray  # (T,) int32 — word of each token
    num_docs: int
    num_words: int

    @property
    def num_tokens(self) -> int:
        return int(self.doc_ids.shape[0])

    def doc_lengths(self) -> np.ndarray:
        return np.bincount(self.doc_ids, minlength=self.num_docs)

    def validate(self) -> None:
        if self.doc_ids.shape != self.word_ids.shape:
            raise ValueError("doc_ids and word_ids differ in shape")
        if self.doc_ids.size and (self.doc_ids.min() < 0
                                  or self.doc_ids.max() >= self.num_docs):
            raise ValueError(f"doc ids must be in [0, {self.num_docs})")
        if self.word_ids.size and (self.word_ids.min() < 0
                                   or self.word_ids.max() >= self.num_words):
            raise ValueError(f"word ids must be in [0, {self.num_words})")


def read_uci_bow(path: str, max_docs: int | None = None) -> Corpus:
    """Read the UCI bag-of-words format that NYTimes/PubMed ship in.

    Line 1: D, line 2: W, line 3: NNZ, then ``doc word count`` triples
    (1-indexed)."""
    with open(path) as f:
        num_docs = int(f.readline())
        num_words = int(f.readline())
        f.readline()  # NNZ
        triples = np.loadtxt(f, dtype=np.int64).reshape(-1, 3)
    if max_docs is not None:
        triples = triples[triples[:, 0] <= max_docs]
        num_docs = min(num_docs, max_docs)
    docs = np.repeat(triples[:, 0] - 1, triples[:, 2]).astype(np.int32)
    words = np.repeat(triples[:, 1] - 1, triples[:, 2]).astype(np.int32)
    return Corpus(docs, words, num_docs, num_words)


# ---------------------------------------------------------------------------
# C1: balanced partition-by-document
# ---------------------------------------------------------------------------

def partition_by_document(corpus: Corpus, num_shards: int) -> list[np.ndarray]:
    """Assign documents to shards, balancing **token** counts (paper §4).

    Longest-processing-time greedy: docs by length descending, each into
    the currently lightest shard (a serpentine round-robin above 2M docs).
    Returns, per shard, the sorted global document ids it owns."""
    lengths = corpus.doc_lengths()
    order = np.argsort(-lengths, kind="stable")
    assign = np.empty(corpus.num_docs, dtype=np.int32)
    if corpus.num_docs <= 2_000_000:
        heap = [(0, s) for s in range(num_shards)]
        heapq.heapify(heap)
        for d in order:
            load, s = heapq.heappop(heap)
            assign[d] = s
            heapq.heappush(heap, (load + int(lengths[d]), s))
    else:
        r = np.arange(len(order)) % (2 * num_shards)
        assign[order] = np.where(r < num_shards, r, 2 * num_shards - 1 - r)
    return [np.sort(np.nonzero(assign == s)[0]).astype(np.int32)
            for s in range(num_shards)]


# ---------------------------------------------------------------------------
# C6: word-major tiling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TiledCorpusShard:
    """One shard's tokens in word-major tiles, as tensors on one device.

    Shapes (``n`` = number of tiles, ``t`` = tile_tokens):
      tile_word:    (n,)   int32 — the word every token in the tile shares
      token_doc:    (n, t) int32 — local (shard) document id per token
      token_mask:   (n, t) bool  — False for padding slots
      tile_first:   (n,)   bool  — True on the first tile of each word run
      doc_length:   (d,)   int32 — local doc lengths
      doc_global:   (d,)   int32 — local -> global doc id map
      token_uid:    (n, t) int32 — canonical corpus token index (-1 pad)
    """

    tile_word: torch.Tensor
    token_doc: torch.Tensor
    token_mask: torch.Tensor
    tile_first: torch.Tensor
    doc_length: torch.Tensor
    doc_global: torch.Tensor
    token_uid: torch.Tensor
    num_tokens: int
    num_words: int          # local phi rows
    num_docs_local: int
    max_doc_length: int     # the longest local doc, known on the host
    num_words_total: int = 0  # global vocabulary size (Eq. 1's V)
    # tables derived from the tiling on this device (``cached``); a copy
    # made by ``to`` starts without them
    _derived: dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    _TENSORS = ("tile_word", "token_doc", "token_mask", "tile_first",
                "doc_length", "doc_global", "token_uid")

    @property
    def device(self) -> torch.device:
        return self.token_doc.device

    def cached(self, key: str, build):
        """``build()`` on first call for ``key``, then its kept result: for
        tables that depend only on the tiling, such as the phi-delta
        kernel's segment table, built once instead of every iteration."""
        if key not in self._derived:
            self._derived[key] = build()
        return self._derived[key]

    def to(self, device) -> "TiledCorpusShard":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in self._TENSORS})


def tile_shard(
    corpus: Corpus,
    doc_ids_of_shard: np.ndarray,
    tile_tokens: int = 256,
    pad_tiles_to: int | None = None,
    token_uid: np.ndarray | None = None,
    num_words_total: int | None = None,
    device="cpu",
) -> TiledCorpusShard:
    """Build the word-major tiling for one shard (paper §6.1.2).

    Heavy words (most tokens) are tiled first; a tile never mixes words.
    Padding tiles (``pad_tiles_to``) alias the last real word with
    ``tile_first=False`` and an all-False mask, so count kernels neither
    re-zero a row nor add to it.  ``token_uid`` maps this shard's tokens back
    to canonical corpus indices (for elastic checkpoints); defaults to the
    corpus positions of the selected tokens.

    The arrays equal ``repro.core.corpus.tile_shard``'s; the tiles are cut
    with array arithmetic instead of a loop over tiles, so a full NYTimes
    shard (~490k tiles) tiles in seconds."""
    t = int(tile_tokens)
    owned = np.zeros(corpus.num_docs, dtype=bool)
    owned[np.asarray(doc_ids_of_shard, dtype=np.int64)] = True
    sel = owned[corpus.doc_ids]     # np.isin(doc_ids, shard), in O(T)
    docs = corpus.doc_ids[sel]
    words = corpus.word_ids[sel]
    uid = (np.nonzero(sel)[0].astype(np.int32) if token_uid is None
           else np.asarray(token_uid, dtype=np.int32)[sel])
    doc_global = np.asarray(doc_ids_of_shard, dtype=np.int32)
    remap = np.full(corpus.num_docs, -1, dtype=np.int32)
    remap[doc_global] = np.arange(len(doc_global), dtype=np.int32)
    docs_local = remap[docs]

    # word-first sort; heavy words first, stable within word
    counts = np.bincount(words, minlength=corpus.num_words)
    heavy_rank = np.argsort(np.argsort(-counts, kind="stable"), kind="stable")
    order = np.argsort(heavy_rank[words], kind="stable")
    docs_local = docs_local[order]
    words_sorted = words[order]
    uid_sorted = uid[order]

    # word runs, then each run cut into ceil(len / t) tiles
    T = len(words_sorted)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(words_sorted)) + 1])
    run_len = np.diff(np.concatenate([starts, [T]])) if T else np.zeros(0, int)
    starts = starts[:len(run_len)]
    run_tiles = -(-run_len // t)
    tile_off = np.concatenate([[0], np.cumsum(run_tiles)])
    n = int(tile_off[-1])
    n_pad = pad_tiles_to if pad_tiles_to is not None else n
    if n_pad < n:
        raise ValueError(f"pad_tiles_to={n_pad} < required {n}")

    run_of_tile = np.repeat(np.arange(len(run_len)), run_tiles)
    first_of_run = np.zeros(n, dtype=bool)
    first_of_run[tile_off[:-1][run_tiles > 0]] = True
    tile_word = np.zeros(n_pad, dtype=np.int32)
    tile_word[:n] = words_sorted[starts[run_of_tile]] if n else 0
    tile_first = np.zeros(n_pad, dtype=bool)
    tile_first[:n] = first_of_run

    # each sorted token's (tile, slot)
    run_of_tok = np.repeat(np.arange(len(run_len)), run_len)
    pos = np.arange(T, dtype=np.int64) - starts[run_of_tok]
    dest = (tile_off[:-1][run_of_tok] + pos // t) * t + pos % t
    token_doc = np.zeros(n_pad * t, dtype=np.int32)
    token_mask = np.zeros(n_pad * t, dtype=bool)
    tok_uid = np.full(n_pad * t, -1, dtype=np.int32)
    token_doc[dest] = docs_local
    token_mask[dest] = True
    tok_uid[dest] = uid_sorted
    if n and n_pad > n:
        tile_word[n:] = tile_word[n - 1]

    doc_length = np.bincount(docs_local, minlength=len(doc_global)).astype(np.int32)
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return TiledCorpusShard(
        tile_word=as_t(tile_word),
        token_doc=as_t(token_doc.reshape(n_pad, t)),
        token_mask=as_t(token_mask.reshape(n_pad, t)),
        tile_first=as_t(tile_first),
        doc_length=as_t(doc_length),
        doc_global=as_t(doc_global),
        token_uid=as_t(tok_uid.reshape(n_pad, t)),
        num_tokens=int(T),
        num_words=corpus.num_words,
        num_docs_local=int(len(doc_global)),
        max_doc_length=int(doc_length.max(initial=0)),
        num_words_total=(corpus.num_words if num_words_total is None
                         else num_words_total),
    )


def tile_corpus(corpus: Corpus, num_shards: int, tile_tokens: int = 256,
                device="cpu") -> list[TiledCorpusShard]:
    """Partition + tile: shards padded to a common tile count."""
    parts = partition_by_document(corpus, num_shards)
    if num_shards == 1:
        return [tile_shard(corpus, parts[0], tile_tokens, device=device)]
    raw = [tile_shard(corpus, p, tile_tokens) for p in parts]
    n_max = max(s.tile_word.shape[0] for s in raw)
    return [tile_shard(corpus, p, tile_tokens, n_max, device=device)
            for p in parts]


def ell_capacity(corpus: Corpus, num_topics: int, quantile: float = 1.0) -> int:
    """Upper bound for distinct topics per document (the ELL pad width P).

    ``quantile`` < 1 gives the bucketed variant's small-P capacity; 1.0 is
    the exact bound min(K, max doc length), rounded up to 8, 16, 32, 64 or
    a multiple of 128."""
    lengths = corpus.doc_lengths()
    q = int(np.quantile(lengths, quantile)) if quantile < 1.0 else int(lengths.max())
    cap = max(1, min(num_topics, q))
    for mult in (8, 16, 32, 64, 128):
        if cap <= mult:
            return mult
    return int(np.ceil(cap / 128) * 128)
