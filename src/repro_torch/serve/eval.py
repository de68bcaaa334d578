"""Held-out evaluation: document-completion perplexity against a snapshot.

The port's counterpart of ``repro.serve.eval``.  Each held-out document is
split in two: theta is estimated by fold-in on the *estimation* half only,
then the *evaluation* half is scored under p(w|d) = sum_k theta^_dk phi^_wk.

    perplexity = exp( - sum log p(w) / N_eval )
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import likelihood
from repro_torch.serve.infer import InferConfig, fold_in_config, pack_docs
from repro_torch.serve.snapshot import ModelSnapshot


class PerplexityResult(NamedTuple):
    perplexity: float
    log_prob: float       # total log p over evaluation tokens
    num_tokens: int       # evaluation tokens scored
    num_docs: int


def split_documents(
    docs: Sequence[np.ndarray], rng: np.random.Generator | None = None,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """First-half / second-half completion split per document (shuffled
    first when ``rng`` is given).  Docs with < 2 tokens land entirely in
    the estimation half."""
    est, ev = [], []
    for d in docs:
        d = np.asarray(d, np.int32)
        if rng is not None:
            d = rng.permutation(d)
        h = max(1, len(d) // 2)
        est.append(d[:h])
        ev.append(d[h:])
    return est, ev


def docs_from_corpus(corpus, doc_ids: Sequence[int] | None = None) -> list[np.ndarray]:
    """Per-document word-id arrays out of a token-stream Corpus."""
    ids = range(corpus.num_docs) if doc_ids is None else doc_ids
    return [corpus.word_ids[corpus.doc_ids == d] for d in ids]


def heldout_perplexity(
    snap: ModelSnapshot,
    docs: Sequence[np.ndarray],
    cfg: InferConfig | None = None,
    seed: int = 0,
    shuffle_split: bool = True,
) -> PerplexityResult:
    """Document-completion perplexity of ``docs`` under ``snap``, on the
    snapshot's device."""
    cfg = cfg or InferConfig()
    rng = np.random.default_rng(seed) if shuffle_split else None
    est, ev = split_documents(docs, rng)
    est_tok, est_mask = pack_docs(est)
    ev_tok, ev_mask = pack_docs(ev)

    gen = torch.Generator(device=snap.device)
    gen.manual_seed(seed)
    res = fold_in_config(snap, est_tok, est_mask, gen, cfg)
    dev = snap.device
    lp, n = likelihood.heldout_token_log_prob(
        res.theta, snap.phi_vk, snap.phi_sum,
        torch.as_tensor(ev_tok, device=dev), torch.as_tensor(ev_mask, device=dev),
        snap.beta, snap.num_words_total)
    lp, n = float(lp), int(n)
    # No evaluation tokens -> NaN, not a perfect 1.0.
    ppl = float(np.exp(-lp / n)) if n else float("nan")
    return PerplexityResult(perplexity=ppl, log_prob=lp, num_tokens=n,
                            num_docs=len(docs))
