"""Plain PyTorch versions of the phi count kernels: the sorted scatter-adds
of ``repro_torch.core.updates`` (the trainer's own update), as
``repro/kernels/phi_update/ref.py`` is for the Pallas kernels.  The CPU
path of the port runs these; on the card they are what the CUDA kernels
are held against.  A scatter-add needs no run structure, so these ignore
``tile_first``; the kernels read it (the TPU kernels to keep a word's
block across its run of tiles, the CUDA K2 through its segment table) and
must give the same counts whatever it marks."""
from __future__ import annotations

from repro_torch.core import updates


def phi_update_tiles_ref(tile_word, tile_first, z, token_mask,
                         num_words: int, num_topics: int):
    """(V, K) int32 counts(z) per word row over masked tokens."""
    return updates.phi_from_z(z, tile_word, token_mask != 0, num_words,
                              num_topics)


def phi_delta_tiles_ref(tile_word, tile_first, z_new, z_old, token_mask,
                        num_words: int, num_topics: int):
    """(V, K) int32 counts(z_new) - counts(z_old) per word row."""
    return updates.phi_delta(z_old, z_new, tile_word, token_mask != 0,
                             num_words, num_topics)
