"""Public wrapper for the training-sweep kernel, as
``repro/kernels/lda_sample/ops.py``.

Randomness is data: the sweep takes its (n, t, 2) uniforms as a tensor
(or draws them from a ``torch.Generator`` with
``core.sampler.draw_sweep_uniforms``), so the same arrays fed to the JAX
package give the same draws, up to float-order boundary flips (fault F2).
``lda_sample`` dispatches on the tensors' device: CUDA tensors go to the
hand-written kernel, CPU tensors to its plain version.  There is no
fallback: a failed build or launch raises.  The ELL keeps its stored type
(int16 from the trainer, C7); the kernel also takes each row's live
length, computed here once per sweep.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampler import draw_sweep_uniforms, sweep_stats

from . import kernel, ref

DEFAULT_TILES_PER_STEP = 64


def live_lengths(ell_counts: torch.Tensor) -> torch.Tensor:
    """(D,) int32 — each ELL row's number of non-zero counts.  ELL puts zero
    counts last, so these are the leading entries the kernel reads."""
    return (ell_counts > 0).sum(1, dtype=torch.int32)


def sweep_args(tile_word, token_doc, token_mask, z, phi_vk, phi_sum,
               ell_counts, ell_topics, uniforms):
    """The kernel's nine arrays in its types: z and the ELL keep int16 or
    int32 (anything else becomes int32), the rest int32 / bool / float32,
    all contiguous."""
    def keep(a, kinds):
        return (a if a.dtype in kinds else a.to(torch.int32)).contiguous()

    return (tile_word.to(torch.int32).contiguous(),
            token_doc.to(torch.int32).contiguous(),
            (token_mask != 0).contiguous(),
            keep(z, kernel.Z_DTYPES),
            phi_vk.to(torch.int32).contiguous(),
            phi_sum.to(torch.int32).contiguous(),
            keep(ell_counts, kernel.ELL_DTYPES),
            keep(ell_topics, kernel.ELL_DTYPES),
            uniforms.to(torch.float32).contiguous())


def launch_kernel(args, **kw):
    """``sweep_args``' arrays -> the kernel, with the ELL's live lengths."""
    return kernel.lda_sample_tiles(*args, ell_live=live_lengths(args[6]),
                                   **kw)


def lda_sample(
    tile_word, token_doc, token_mask, z, phi_vk, phi_sum, ell_counts,
    ell_topics, uniforms, *, alpha: float, beta: float,
    num_words_total: int, tiles_per_step: int | None = None,
):
    """Sample one sweep of word tiles.

    ``uniforms``: (n, t, 2) float32, or a ``torch.Generator`` on z's
    device.  ``tiles_per_step`` bounds the plain version's chunk (the
    kernel takes every tile at once).  Returns ``(z_new, SamplerStats)``
    with z_new of z's dtype."""
    n, t = z.shape
    if isinstance(uniforms, torch.Generator):
        uniforms = draw_sweep_uniforms(uniforms, n, t, z.device)
    args = sweep_args(tile_word, token_doc, token_mask, z, phi_vk, phi_sum,
                      ell_counts, ell_topics, uniforms)
    kw = dict(alpha=alpha, beta=beta, num_words_total=num_words_total)
    if z.device.type == "cuda":
        z_new, sparse, ssq = launch_kernel(args, **kw)
    else:
        z_new, sparse, ssq = ref.lda_sample_tiles_ref(
            *args, tiles_per_step=tiles_per_step or DEFAULT_TILES_PER_STEP,
            **kw)
    return z_new.to(z.dtype), sweep_stats(args[2], sparse, ssq)
