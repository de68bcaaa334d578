"""Synthetic LDA corpora with planted topics (data pipeline, test + bench).

A numpy copy of ``repro.data.synthetic``: the same seed gives the same
corpus in both packages.

Generates documents from the LDA generative process so convergence tests have
a known-good likelihood level, plus a Zipfian word-frequency option so the
word-major tiling sees realistic heavy/long-tail words (NYTimes-like shape).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.corpus import Corpus


def lda_corpus(
    num_docs: int,
    num_words: int,
    num_topics: int,
    avg_doc_len: int,
    alpha: float = 0.1,
    beta: float = 0.05,
    seed: int = 0,
) -> Corpus:
    """Sample a corpus from the LDA generative process (planted topics)."""
    rng = np.random.default_rng(seed)
    topic_word = rng.dirichlet(np.full(num_words, beta), size=num_topics)
    doc_ids, word_ids = [], []
    lengths = np.maximum(1, rng.poisson(avg_doc_len, size=num_docs))
    for d in range(num_docs):
        mix = rng.dirichlet(np.full(num_topics, alpha))
        zs = rng.choice(num_topics, size=lengths[d], p=mix)
        for k, cnt in zip(*np.unique(zs, return_counts=True)):
            ws = rng.choice(num_words, size=cnt, p=topic_word[k])
            word_ids.append(ws)
            doc_ids.append(np.full(cnt, d, dtype=np.int32))
    corpus = Corpus(
        doc_ids=np.concatenate(doc_ids).astype(np.int32),
        word_ids=np.concatenate(word_ids).astype(np.int32),
        num_docs=num_docs,
        num_words=num_words,
    )
    corpus.validate()
    return corpus


def zipf_corpus(
    num_docs: int,
    num_words: int,
    avg_doc_len: int,
    exponent: float = 1.1,
    seed: int = 0,
) -> Corpus:
    """Topic-free Zipf corpus: realistic word-frequency skew for tiling and
    throughput benchmarks (heavy words spanning many tiles)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, num_words + 1, dtype=np.float64)
    p = ranks ** -exponent
    p /= p.sum()
    lengths = np.maximum(1, rng.poisson(avg_doc_len, size=num_docs))
    total = int(lengths.sum())
    word_ids = rng.choice(num_words, size=total, p=p).astype(np.int32)
    doc_ids = np.repeat(np.arange(num_docs, dtype=np.int32), lengths)
    corpus = Corpus(doc_ids=doc_ids, word_ids=word_ids,
                    num_docs=num_docs, num_words=num_words)
    corpus.validate()
    return corpus


def nytimes_like(scale: float = 0.001, seed: int = 0) -> Corpus:
    """NYTimes-shaped corpus scaled down (D=300k, V=102k, T=99.5M at 1.0)."""
    d = max(8, int(299_752 * scale))
    v = max(64, int(101_636 * min(1.0, scale * 20)))
    return zipf_corpus(d, v, avg_doc_len=332, seed=seed)


def pubmed_like(scale: float = 0.0001, seed: int = 0) -> Corpus:
    """PubMed-shaped corpus scaled down (D=8.2M, V=141k, T=737.9M at 1.0)."""
    d = max(8, int(8_200_000 * scale))
    v = max(64, int(141_043 * min(1.0, scale * 100)))
    return zipf_corpus(d, v, avg_doc_len=92, seed=seed)
