"""CUDA training-sweep kernel for Hopper: the wrapper around
``csrc/lda_sample.cu``.

Replaces ``repro/kernels/lda_sample/kernel.py::lda_sample_tiles`` (K1, the
Pallas TPU kernel): one delayed-count S/Q sweep over word tiles.  The TPU
kernel stages a chunk's (C, K) phi table, which does not fit a block's
shared memory at NYTimes width; here a CTA takes a few consecutive tiles in
turn (the paper's layout, one tile at a time) with the word's p* and search
sums in shared memory, and one warp per run of a tile's slots with one
document reads that document's live ELL entries once and draws every token
of the run.  The group of tiles a CTA takes is fixed when the source is
built (``tiles_per_cta``).  The kernel reads no chunk
plan, so ``build_chunk_plan``/``build_sweep_plans`` of the JAX package have
no counterpart here.

What bounds it: its least work by bytes — each run reads its document's
live ELL entries (counts and topics, int16 or int32) from device memory
(the (D, P) ELL is far larger than L2), besides the uniforms and the
per-token inputs and outputs; its time by the per-run scan and draws, with
the row loads mostly hidden behind them (see the source note).

Built with ``nvcc`` for ``sm_90a`` at first launch (``kernels/_build.py``)
and bound with ctypes, behind the custom op ``repro_torch::lda_sample_tiles``
(``torch.library``): its CUDA body is the ctypes launch, and its fake
implementation gives the outputs' shapes and dtypes, so a trace on fake
tensors (the dry run's LDA cells) reaches the op without building or
launching anything, and ``FlopCounterMode`` counts ``ops_reckoning``.
The wrapper refuses CPU tensors: ``ops.py`` sends those to the plain
version in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.sampler import pick_search_block
from repro_torch.kernels import _build

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
Z_DTYPES = (torch.int16, torch.int32)
ELL_DTYPES = (torch.int16, torch.int32)   # counts and topics, one of them
MAX_SMEM_BYTES = 232_448         # a Hopper block's shared-memory limit


def _lib(defines: tuple[str, ...] = ()):
    """The built library; ``defines`` (``NAME=VALUE``) select a build
    variant of the source, which only ``k1_probe.py`` asks for."""
    lib = _build.load("lda_sample", defines)
    fn = lib.lda_sample_tiles_launch
    if fn.argtypes is None:   # pointers and the stream as c_void_p, not int
        fn.argtypes = [_vp] * 13 + [_i] * 7 + [_f, _f, _i, _vp]
        fn.restype = _i
        lib.lda_sample_smem_bytes.argtypes = [_i] * 5
        lib.lda_sample_smem_bytes.restype = ctypes.c_size_t
        lib.lda_sample_tiles_per_cta.restype = _i
    return lib


def tiles_per_cta() -> int:
    """Consecutive tiles a CTA takes in turn, as the kernel was built."""
    return int(_lib().lda_sample_tiles_per_cta())


def smem_bytes(t: int, K: int, P: int, ell_bytes: int) -> int:
    """Dynamic shared memory of one CTA, as the built kernel lays it out."""
    return int(_lib().lda_sample_smem_bytes(t, K, P, pick_search_block(K),
                                            ell_bytes))


def lda_sample_tiles(
    tile_word,     # (n,) int32
    token_doc,     # (n, t) int32 — local doc id per token
    token_mask,    # (n, t) bool
    z_old,         # (n, t) int16 or int32
    phi_vk,        # (V, K) int32
    phi_sum,       # (K,) int32
    ell_counts,    # (D, P) int16 or int32 — per-doc ELL, zero counts last
    ell_topics,    # (D, P) of ell_counts' dtype
    uniforms,      # (n, t, 2) float32
    *,
    ell_live,      # (D,) int32 — live (non-zero) entries of each ELL row
    alpha: float,
    beta: float,
    num_words_total: int,
):
    """Launch one sweep on the current stream; does not synchronise.

    ``ell_live`` must be each row's number of non-zero counts
    (``ops.live_lengths``): the kernel reads no entry past it.  Returns
    (z_new (n, t) like z_old, sparse (n, t) bool, ssq (n, t) float32 —
    S/(S+Q) per token, 0 on padding).  Through the custom op: the launch
    is counted in its CUDA body, so a fake trace counts none."""
    _check(tile_word, token_doc, token_mask, z_old, phi_vk, phi_sum,
           ell_counts, ell_topics, uniforms, ell_live)
    return _sweep_op(tile_word, token_doc, token_mask, z_old, phi_vk,
                     phi_sum, ell_counts, ell_topics, uniforms, ell_live,
                     float(alpha), float(beta), int(num_words_total))


@torch.library.custom_op("repro_torch::lda_sample_tiles", mutates_args=(),
                         device_types="cuda")
def _sweep_op(tile_word: torch.Tensor, token_doc: torch.Tensor,
              token_mask: torch.Tensor, z_old: torch.Tensor,
              phi_vk: torch.Tensor, phi_sum: torch.Tensor,
              ell_counts: torch.Tensor, ell_topics: torch.Tensor,
              uniforms: torch.Tensor, ell_live: torch.Tensor, alpha: float,
              beta: float, num_words_total: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    out = sweep_variant((), tile_word, token_doc, token_mask, z_old, phi_vk,
                        phi_sum, ell_counts, ell_topics, uniforms,
                        ell_live=ell_live, alpha=alpha, beta=beta,
                        num_words_total=num_words_total)
    lda_sample_tiles.launches += 1
    return out


@_sweep_op.register_fake
def _(tile_word, token_doc, token_mask, z_old, phi_vk, phi_sum, ell_counts,
      ell_topics, uniforms, ell_live, alpha, beta, num_words_total):
    n, t = z_old.shape
    return (torch.empty_like(z_old),
            z_old.new_empty((n, t), dtype=torch.bool),
            z_old.new_empty((n, t), dtype=torch.float32))


def ops_reckoning(n: int, t: int, K: int) -> int:
    """The float operations of one sweep over ``n`` tiles of ``t`` slots at
    ``K`` topics, reckoned from the shapes alone: ``chip_smoke.py``'s
    ``k1_bytes_and_ops`` with its data-dependent terms taken at the
    tiling's shape — 4 per topic for each tile's word (p* and its prefix
    sums; a word over several tiles counted once a tile), and per slot 2
    for the side and a dense draw's search (``pick_search_block``'s block
    sums, then the sums inside one block).  The 2 per live ELL entry that
    each run of a document reads depend on the ELL's live lengths, which
    the shapes do not give, and are left out."""
    bw = pick_search_block(K)
    steps = math.ceil(math.log2(max(K // bw, 1))) + math.ceil(
        math.log2(max(bw, 1)))
    return sum((4 * K * n, n * t * (2 + steps)))


@register_flop_formula(torch.ops.repro_torch.lda_sample_tiles)
def _sweep_flops(tile_word, token_doc, token_mask, z_old, phi_vk, *args,
                 out_shape=None, **kwargs) -> int:
    return ops_reckoning(z_old[0], z_old[1], phi_vk[1])


def _check(tile_word, token_doc, token_mask, z_old, phi_vk, phi_sum,
           ell_counts, ell_topics, uniforms, ell_live) -> torch.device:
    """The arguments' devices, dtypes and shapes (real or fake tensors)."""
    dev = _build.require_cuda(z_old, "lda_sample_tiles",
                              "ref.lda_sample_tiles_ref")
    n, t = z_old.shape
    V, K = phi_vk.shape
    D, P = ell_counts.shape
    chk = _build.check_tensor
    chk("tile_word", tile_word, torch.int32, (n,), dev)
    chk("token_doc", token_doc, torch.int32, (n, t), dev)
    chk("token_mask", token_mask, torch.bool, (n, t), dev)
    chk("z_old", z_old, Z_DTYPES, (n, t), dev)
    chk("phi_vk", phi_vk, torch.int32, (V, K), dev)
    chk("phi_sum", phi_sum, torch.int32, (K,), dev)
    chk("ell_counts", ell_counts, ELL_DTYPES, (D, P), dev)
    chk("ell_topics", ell_topics, ell_counts.dtype, (D, P), dev)
    chk("ell_live", ell_live, torch.int32, (D,), dev)
    chk("uniforms", uniforms, torch.float32, (n, t, 2), dev)
    if not 1 <= P <= K:
        raise ValueError(f"ELL width {P} must be in [1, K={K}]")
    return dev


def sweep_variant(defines, tile_word, token_doc, token_mask, z_old, phi_vk,
                  phi_sum, ell_counts, ell_topics, uniforms, *, ell_live,
                  alpha, beta, num_words_total):
    """``lda_sample_tiles``' launch through the build of the source with
    ``defines`` (``()``: the shipped one), on real CUDA tensors, without
    counting it."""
    dev = _check(tile_word, token_doc, token_mask, z_old, phi_vk, phi_sum,
                 ell_counts, ell_topics, uniforms, ell_live)
    n, t = z_old.shape
    K = phi_vk.shape[1]
    P = ell_counts.shape[1]
    smem = smem_bytes(t, K, P, ell_counts.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"tile {t} x K {K} x P {P} needs {smem} bytes of "
                         f"shared memory, over {MAX_SMEM_BYTES}")
    z_new = torch.empty_like(z_old)
    sparse = torch.empty((n, t), dtype=torch.bool, device=dev)
    ssq = torch.empty((n, t), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib(defines).lda_sample_tiles_launch(
            tile_word.data_ptr(), token_doc.data_ptr(), token_mask.data_ptr(),
            z_old.data_ptr(), phi_vk.data_ptr(), phi_sum.data_ptr(),
            ell_counts.data_ptr(), ell_topics.data_ptr(), ell_live.data_ptr(),
            uniforms.data_ptr(), z_new.data_ptr(), sparse.data_ptr(),
            ssq.data_ptr(), n, t, K, P, pick_search_block(K),
            z_old.element_size(), ell_counts.element_size(),
            float(alpha), float(beta),
            int(num_words_total), _build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"lda_sample_tiles launch failed: CUDA error {err}")
    return z_new, sparse, ssq


lda_sample_tiles.launches = 0   # kernel launches since the last reset
