"""The benchmark's corpus generator: a bag-of-words corpus drawn from the
seed on the device, with Poisson document lengths and a Zipf word law.

The law is ``repro_torch/data/synthetic.py::zipf_corpus``'s (lengths
``max(1, Poisson(avg_doc_len))``, word of rank r drawn with probability
proportional to ``r ** -exponent``); the draws are torch's on the device
(lengths by ``torch.poisson``, words by inverse transform of float64
uniforms against the float64 CDF), in a few large calls, not that host
numpy code's, so one seed gives one corpus here and another there.
Frozen: the same seed gives the same corpus in every later check.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 24     # word draws per call: bounds the float64 temporaries


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one stream of one run's seed."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def zipf_corpus(num_docs: int, num_words: int, avg_doc_len: float,
                exponent: float, seed: int, device):
    """(doc_ids, word_ids), int32 on ``device``, in document order: the
    corpus's tokens, document ``d``'s tokens contiguous."""
    gen = generator(seed, 1, device)
    rate = torch.full((num_docs,), float(avg_doc_len), dtype=torch.float32,
                      device=device)
    lengths = torch.clamp(torch.poisson(rate, generator=gen), min=1).long()
    doc_ids = torch.repeat_interleave(
        torch.arange(num_docs, dtype=torch.int32, device=device), lengths)
    ranks = torch.arange(1, num_words + 1, dtype=torch.float64,
                         device=device)
    cdf = torch.cumsum(ranks ** -float(exponent), 0)
    cdf /= cdf[-1].clone()
    T = doc_ids.numel()
    word_ids = torch.empty(T, dtype=torch.int32, device=device)
    for a in range(0, T, CHUNK):
        u = torch.rand(min(CHUNK, T - a), dtype=torch.float64, generator=gen,
                       device=device)
        word_ids[a:a + CHUNK] = torch.clamp(
            torch.searchsorted(cdf, u, right=True), max=num_words - 1)
    return doc_ids, word_ids
