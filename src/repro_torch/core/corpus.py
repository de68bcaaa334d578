"""Corpus representation (host side, numpy).

The port's copy of ``repro.core.corpus.Corpus``.  Partitioning and the
word-major tiling arrive with the training slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
