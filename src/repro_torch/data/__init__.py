"""Host data: synthetic corpora (numpy) and the LM training path's
prefetching loader."""
