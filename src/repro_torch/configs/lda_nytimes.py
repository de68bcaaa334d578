"""Paper workload: NYTimes (Table 3 — T=99.5M, D=300k, V=102k), K=1024.

alpha=50/K, beta=0.01 per §2.1/§7.  The JAX counterpart also builds a
training ``LDAConfig``; that dataclass arrives with the training slice.
"""

NUM_TOPICS = 1024
BETA = 0.01
FULL = dict(num_docs=299_752, num_words=101_636, num_tokens=99_542_125,
            avg_doc_len=332)


def alpha(num_topics: int = NUM_TOPICS) -> float:
    """The paper's symmetric doc-topic prior, 50/K."""
    return 50.0 / num_topics
