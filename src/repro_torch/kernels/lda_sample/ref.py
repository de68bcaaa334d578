"""Plain PyTorch version of the training-sweep kernel.

Mirrors ``repro/kernels/lda_sample/ref.py::lda_sample_tiles_ref`` (the same
branch rule, the same blocked search, the naive per-token ELL gather) with
the port kernel's argument order, and works through the tiles in chunks of
``tiles_per_step``: the (n, t, P) intermediates of a whole NYTimes sweep
would not fit any device.  Chunking never changes a draw.  The CPU path of
the port runs this; on the card it is what the CUDA kernel is held against.
"""
from __future__ import annotations

from repro_torch.core.sampler import sample_sweep_tokens


def lda_sample_tiles_ref(
    tile_word,     # (n,) int32
    token_doc,     # (n, t) int32
    token_mask,    # (n, t) bool
    z_old,         # (n, t) int
    phi_vk,        # (V, K) int32
    phi_sum,       # (K,) int32
    ell_counts,    # (D, P) int32
    ell_topics,    # (D, P) int32
    uniforms,      # (n, t, 2) float32
    *,
    alpha: float,
    beta: float,
    num_words_total: int,
    tiles_per_step: int = 64,
):
    """Returns (z_new (n, t) like z_old, sparse (n, t) bool, ssq (n, t)
    float32) — the kernel's contract."""
    return sample_sweep_tokens(
        phi_vk, phi_sum, tile_word, token_doc, token_mask != 0, z_old,
        ell_counts, ell_topics, uniforms, alpha=alpha, beta=beta,
        num_words_total=num_words_total, tiles_per_step=tiles_per_step)
