"""The least work of one LDA iteration on given inputs, and the published
peaks of one NVIDIA H100 (SXM, NVIDIA's data sheet, dense rates).

Frozen: a later change to the program must not change what is counted
here.  The counts are of the algorithm's work on these inputs, whatever
implements it: each input read once, each output written once.

* a token's document and its old topic are read, its new topic written
  (``z_bytes`` a topic, as the state holds it); a token's word is shared
  by its word's tokens in any word-sorted layout and counted once a word;
* phi's rows of the words present are read once, and phi_sum;
* each document's non-zero topics are read once as the state holds them
  (count and topic at ``ell_bytes`` each);
* the phi advance writes each entry whose count changed once (4 bytes).

Origin: ``chip_smoke.py::k1_bytes_and_ops``, ``count_bytes_and_ops`` and
``bound`` (the port's smoke check).  What differs: those count every slot
of the program's tiles (padding included) with the uniforms, the mask and
the kernels' side outputs, the phi delta as a dense (V, K) write, and S
once per run of a tile; here only what the algorithm needs on these
inputs is counted: real tokens, the entries that change, and the sparse
sum once per distinct (word, document) pair.
"""
from __future__ import annotations

import math

from portbench.reference.lda import search_block  # noqa: F401  (one rule)

HBM_BYTES_PER_S = 3.35e12      # HBM3, 80 GB
FP32_FLOPS = 67e12             # float32 outside the tensor cores


def least_ms(nbytes: float, ops: float) -> float:
    """The least time of ``nbytes`` moved and ``ops`` operations at the
    published peaks: the larger of the two bounds, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3


def search_steps(n: int) -> int:
    """Compares of a binary search among n sorted prefixes."""
    return math.ceil(math.log2(n + 1))


def sweep(tokens: int, words: int, pairs_live: int, docs_live: int,
          sparse_steps: int, dense_tokens: int, num_topics: int,
          z_bytes: int, ell_bytes: int, block: int) -> tuple[int, int]:
    """The sweep (K1): (bytes, operations).

    ``tokens`` real tokens, ``words`` distinct words present, ``docs_live``
    the sum over the documents present of their non-zero topics,
    ``pairs_live`` the same sum over distinct (word, document) pairs (the
    sparse side's sum S and its prefix are one per pair), ``sparse_steps``
    the sum over tokens drawn from the sparse side of the search's
    compares among their document's live entries, ``dense_tokens`` the
    tokens drawn from the dense side (a search of K / block block sums,
    then of block in-block sums).  Operations: p* and its prefix sums, 4
    a word and topic; 2 a live entry of a pair; 2 a token for the side,
    and the searches' compares."""
    K = num_topics
    nbytes = (tokens * (4 + 2 * z_bytes) + words * (4 + K * 4) + K * 4
              + docs_live * 2 * ell_bytes)
    ops = (4 * K * words + 2 * pairs_live + 2 * tokens + sparse_steps
           + dense_tokens * (search_steps(K // block) + search_steps(block)))
    return nbytes, ops


def advance(tokens: int, words: int, changed_entries: int,
            z_bytes: int) -> tuple[int, int]:
    """The phi advance (K2): every token's old and new topic read, each
    word once, each changed (word, topic) entry written once; one integer
    add per token and topic array."""
    return (tokens * 2 * z_bytes + words * 4 + changed_entries * 4,
            2 * tokens)


def iteration(sweep_counts, advance_counts, tokens: int, words: int,
              z_bytes: int):
    """The whole iteration: the sweep's and the advance's work, with each
    token's old and new topic and each word counted once (the advance
    reads what the sweep read and wrote)."""
    return (sweep_counts[0] + advance_counts[0] - tokens * 2 * z_bytes
            - words * 4, sweep_counts[1] + advance_counts[1])
