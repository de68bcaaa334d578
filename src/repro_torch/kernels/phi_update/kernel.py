"""CUDA word-row count kernels for Hopper: the wrappers around
``csrc/phi_update.cu``.

Replace ``repro/kernels/phi_update/kernel.py::phi_delta_tiles`` (K2, the
trainer's per-iteration phi delta) and ``::phi_update_tiles`` (K4, a full
rebuild of phi from z), the Pallas TPU kernels, with one kernel body in
two modes: a delta, and a full count (a delta with no z_old in which every
real token counts).  Every add is an integer add, exact in any order, and
rows that no tile visits are 0.

Both read the run structure that the TPU kernels read from ``tile_first``
(a word's output block kept across its run of tiles) from a segment table
(``ops.segment_table``): stretches of at most ``segment_tiles()``
consecutive tiles of one word, cut where the word changes or
``tile_first`` is set.  One warp reduces a segment in its own shared K-bin
histogram and flushes it once, with plain stores where the word owns one
segment and with atomics where it owns several; padding tiles have an
all-false mask and add nothing.  K2 zeroes its whole output first.  K4's
output is phi itself, so a sole word's segment writes its whole row, zeros
included, and K4 zeroes first only the rows listed by
``ops.rows_to_zero``: each row of the output is written once.

What bounds them: bytes — reading z (int16 or int32; twice for K2), the
mask and the segment table once and writing the (V, K) output once; see
the source note.

Built with ``nvcc`` for ``sm_90a`` at first launch (``kernels/_build.py``)
and bound with ctypes, behind the custom ops ``repro_torch::phi_delta_tiles``
and ``repro_torch::phi_update_tiles`` (``torch.library``): their CUDA
bodies are the ctypes launches, their fake implementations give the
(V, K) int32 output, so a trace on fake tensors reaches them without
building or launching anything, and ``FlopCounterMode`` counts
``ops_reckoning``.  The wrappers refuse CPU tensors: ``ops.py`` sends
those to the plain versions in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

_vp, _i = ctypes.c_void_p, ctypes.c_int
Z_DTYPES = (torch.int16, torch.int32)


def _lib(defines: tuple[str, ...] = ()):
    """The built library; ``defines`` (``NAME=VALUE``) select a build
    variant of the source, which only ``kernel_probe.py`` asks for."""
    lib = _build.load("phi_update", defines)
    if lib.phi_delta_tiles_launch.argtypes is None:
        # pointers and the stream as c_void_p: ctypes would cut them to int
        lib.phi_delta_tiles_launch.argtypes = ([_vp, _i] + [_vp] * 4
                                               + [_i] * 4 + [_vp])
        lib.phi_delta_tiles_launch.restype = _i
        lib.phi_update_tiles_launch.argtypes = ([_vp, _i, _vp, _i]
                                                + [_vp] * 3 + [_i] * 4
                                                + [_vp])
        lib.phi_update_tiles_launch.restype = _i
        lib.phi_delta_segment_tiles.restype = _i
    return lib


def segment_tiles() -> int:
    """The most tiles a segment holds, as the kernels were built."""
    return int(_lib().phi_delta_segment_tiles())


def _check_slots(first, zs, token_mask):
    dev = _build.require_cuda(first, "the phi_update kernels", "ref.py")
    n, t = zs[0].shape
    z_dtype = zs[0].dtype if zs[0].dtype in Z_DTYPES else Z_DTYPES
    for name, z in zip(("z_new", "z_old"), zs):
        _build.check_tensor(name, z, z_dtype, (n, t), dev)
    _build.check_tensor("token_mask", token_mask, torch.bool, (n, t), dev)
    return dev, n, t


def _check_segments(segments, dev):
    _build.check_tensor("segments", segments, torch.int32,
                        (segments.shape[0], 4), dev)


def phi_delta_tiles(segments, z_new, z_old, token_mask, num_words: int,
                    num_topics: int) -> torch.Tensor:
    """(V, K) int32: counts(z_new) - counts(z_old) per word row over the
    masked tokens.  segments (S, 4) int32 from ``ops.segment_table`` on the
    tiling of z; z_new, z_old (n, t) int16 or int32 (the same);
    token_mask (n, t) bool.  Launches on the current stream and does not
    synchronise (through the custom op: counted in its CUDA body)."""
    dev, _, _ = _check_slots(segments, (z_new, z_old), token_mask)
    _check_segments(segments, dev)
    return _delta_op(segments, z_new, z_old, token_mask, int(num_words),
                     int(num_topics))


@torch.library.custom_op("repro_torch::phi_delta_tiles", mutates_args=(),
                         device_types="cuda")
def _delta_op(segments: torch.Tensor, z_new: torch.Tensor,
              z_old: torch.Tensor, token_mask: torch.Tensor, num_words: int,
              num_topics: int) -> torch.Tensor:
    out = delta_variant((), segments, z_new, z_old, token_mask, num_words,
                        num_topics)
    phi_delta_tiles.launches += 1
    return out


@_delta_op.register_fake
def _(segments, z_new, z_old, token_mask, num_words, num_topics):
    return z_new.new_empty((num_words, num_topics), dtype=torch.int32)


def ops_reckoning(n: int, t: int, delta: bool) -> int:
    """The integer operations of one count over ``n`` tiles of ``t`` slots,
    reckoned from the shapes alone: ``chip_smoke.py``'s
    ``count_bytes_and_ops`` (one add per real token and z array: two for a
    delta) with every slot counted as a real token — the shapes do not say
    how many are padding."""
    return n * t * (2 if delta else 1)


@register_flop_formula(torch.ops.repro_torch.phi_delta_tiles)
def _delta_flops(segments, z_new, *args, out_shape=None, **kwargs) -> int:
    return ops_reckoning(z_new[0], z_new[1], True)


def delta_variant(defines, segments, z_new, z_old, token_mask, num_words,
                  num_topics):
    """``phi_delta_tiles``' launch through the build of the source with
    ``defines`` (``()``: the shipped one), on real CUDA tensors, without
    counting it."""
    dev, n, t = _check_slots(segments, (z_new, z_old), token_mask)
    _check_segments(segments, dev)
    out = torch.empty((num_words, num_topics), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib(defines).phi_delta_tiles_launch(
            segments.data_ptr(), segments.shape[0], z_new.data_ptr(),
            z_old.data_ptr(), token_mask.data_ptr(), out.data_ptr(), t,
            num_words, num_topics, z_new.element_size(),
            _build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"phi_delta_tiles launch failed: CUDA error {err}")
    return out


def phi_update_tiles(segments, zero_rows, z, token_mask, num_words: int,
                     num_topics: int) -> torch.Tensor:
    """(V, K) int32: counts(z) per word row over the masked tokens.
    segments (S, 4) int32 from ``ops.segment_table`` on the tiling of z;
    zero_rows (R,) int32 from ``ops.rows_to_zero(segments, num_words)``:
    the rows that no sole segment writes whole (a row list made for
    another ``num_words`` leaves rows unset); z (n, t) int16 or int32;
    token_mask (n, t) bool.  Launches on the current stream and does not
    synchronise (through the custom op: counted in its CUDA body)."""
    _check_update(segments, zero_rows, z, token_mask, num_words)
    return _update_op(segments, zero_rows, z, token_mask, int(num_words),
                      int(num_topics))


@torch.library.custom_op("repro_torch::phi_update_tiles", mutates_args=(),
                         device_types="cuda")
def _update_op(segments: torch.Tensor, zero_rows: torch.Tensor,
               z: torch.Tensor, token_mask: torch.Tensor, num_words: int,
               num_topics: int) -> torch.Tensor:
    out = update_variant((), segments, zero_rows, z, token_mask, num_words,
                         num_topics)
    phi_update_tiles.launches += 1
    return out


@_update_op.register_fake
def _(segments, zero_rows, z, token_mask, num_words, num_topics):
    return z.new_empty((num_words, num_topics), dtype=torch.int32)


@register_flop_formula(torch.ops.repro_torch.phi_update_tiles)
def _update_flops(segments, zero_rows, z, *args, out_shape=None,
                  **kwargs) -> int:
    return ops_reckoning(z[0], z[1], False)


def _check_update(segments, zero_rows, z, token_mask, num_words):
    dev, n, t = _check_slots(segments, (z,), token_mask)
    _check_segments(segments, dev)
    _build.check_tensor("zero_rows", zero_rows, torch.int32,
                        (zero_rows.shape[0],), dev)
    if zero_rows.shape[0] > num_words:
        raise ValueError(f"zero_rows lists {zero_rows.shape[0]} rows, more "
                         f"than num_words = {num_words}")
    return dev, n, t


def update_variant(defines, segments, zero_rows, z, token_mask, num_words,
                   num_topics):
    """``phi_update_tiles``' launch through the build of the source with
    ``defines`` (``()``: the shipped one), on real CUDA tensors, without
    counting it."""
    dev, n, t = _check_update(segments, zero_rows, z, token_mask, num_words)
    out = torch.empty((num_words, num_topics), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib(defines).phi_update_tiles_launch(
            segments.data_ptr(), segments.shape[0], zero_rows.data_ptr(),
            zero_rows.shape[0], z.data_ptr(), token_mask.data_ptr(),
            out.data_ptr(), t, num_words, num_topics, z.element_size(),
            _build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"phi_update_tiles launch failed: CUDA error {err}")
    return out


phi_delta_tiles.launches = 0    # kernel launches since the last reset
phi_update_tiles.launches = 0
