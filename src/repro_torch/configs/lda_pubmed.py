"""Paper workload: PubMed (Table 3 — T=737.9M, D=8.2M, V=141k), K=1024.

alpha=50/K, beta=0.01 per §2.1/§7, as ``lda_nytimes``.  ``scaled()``
returns a synthetic corpus with the same shape statistics
(``data.synthetic.pubmed_like``); V reaches its full 141,043 from scale
0.01.
"""
from repro_torch.core.trainer import LDAConfig
from repro_torch.data import synthetic

NUM_TOPICS = 1024
BETA = 0.01
CONFIG = LDAConfig(num_topics=NUM_TOPICS, beta=BETA, tile_tokens=256)
FULL = dict(num_docs=8_200_000, num_words=141_043, num_tokens=737_869_083,
            avg_doc_len=92)


def alpha(num_topics: int = NUM_TOPICS) -> float:
    """The paper's symmetric doc-topic prior, 50/K."""
    return 50.0 / num_topics


def scaled(scale: float = 0.0001, seed: int = 0):
    return synthetic.pubmed_like(scale, seed)
