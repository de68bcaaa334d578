"""Workload configurations: the published widths of the paper's datasets
(``lda_nytimes``, ``lda_pubmed``) and the LM zoo's ten architectures
(``archs``; ``--arch <id>`` resolves through ``ARCHS``)."""
from .archs import ARCHS, SHAPES, LONG_OK, cells, skipped_cells, smoke  # noqa: F401
