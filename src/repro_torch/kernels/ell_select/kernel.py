"""CUDA kernel for the ELL of theta on Hopper: the wrapper around
``csrc/ell_select.cu``.

Replaces no TPU kernel: the JAX package leaves the ELL to ``lax.top_k``.
The kernel turns every row of a dense (..., K) int32 count array into its
first P entries in ``lax.top_k`` order (count descending, ties to the lower
topic id, zero counts last in id order) and the row's overflow flag
(more than P non-zero topics), in one launch, bit for bit what the plain
version in ``ref.py`` gives.  A warp a row ranks the row's non-zero topics
with a stable counting select and writes the ELL in its own type (int16 or
int32) straight from shared memory; nothing but the outputs is allocated.

Input contract: theta holds non-negative int32 counts and is contiguous
(the source note; a negative count has no place in the order, and nothing
checks for one).

What bounds it: bytes — reading theta once and writing the ELL once (see
the source note).  The launch shape (rows a block, whether the P entries
are staged in shared memory) follows from K, P and the ELL's type alone
(``rows_per_block``).

Built with ``nvcc`` for ``sm_90a`` at first launch (``kernels/_build.py``)
and bound with ctypes, behind the custom op ``repro_torch::ell_select``
(``torch.library``): its CUDA body is the ctypes launch, its fake
implementation gives the outputs' shapes and dtypes, so a trace on fake
tensors (the dry run's LDA cells) reaches it without building or launching
anything.  The wrapper refuses CPU tensors: ``core.updates`` sends those
to the plain version (``ref.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_vp, _i = ctypes.c_void_p, ctypes.c_int
ELL_DTYPES = (torch.int16, torch.int32)


def _lib():
    lib = _build.load("ell_select")
    fn = lib.ell_select_launch
    if fn.argtypes is None:   # pointers and the stream as c_void_p, not int
        fn.argtypes = [_vp, ctypes.c_longlong, _i, _i, _vp, _vp, _vp, _i,
                       _vp]
        fn.restype = _i
        lib.ell_select_rows_per_block.argtypes = [_i, _i, _i]
        lib.ell_select_rows_per_block.restype = _i
    return lib


def rows_per_block(num_topics: int, capacity: int, dtype) -> int:
    """Rows (one warp each) a block of the launch takes at these K, P and
    ELL type, as the built kernel chooses them."""
    return int(_lib().ell_select_rows_per_block(num_topics, capacity,
                                                dtype.itemsize))


def _check(theta, dtype):
    dev = _build.require_cuda(theta, "the ell_select kernel", "ref.py")
    if theta.dim() < 1 or theta.shape[-1] < 1:
        raise ValueError(f"theta has shape {tuple(theta.shape)}: it needs "
                         "a last axis of K >= 1 topics")
    _build.check_tensor("theta", theta, torch.int32, theta.shape, dev)
    if dtype not in ELL_DTYPES:
        raise ValueError(f"the ELL's dtype is {dtype}, expected int16 or "
                         "int32")
    return dev


def ell_select(theta: torch.Tensor, capacity: int, dtype=torch.int32):
    """Dense counts (..., K) int32 on the card -> ``(counts, topics,
    overflowed)``: counts and topics (..., P) of ``dtype``, P = min(capacity,
    K), in ``lax.top_k`` order with zero-count padding; overflowed (...,)
    bool, more than P non-zero topics.  Launches on the current stream and
    does not synchronise (through the custom op: counted in its CUDA
    body)."""
    _check(theta, dtype)
    return _op(theta, int(capacity), dtype)


@torch.library.custom_op("repro_torch::ell_select", mutates_args=(),
                         device_types="cuda")
def _op(theta: torch.Tensor, capacity: int, dtype: torch.dtype
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dev = _check(theta, dtype)
    K = theta.shape[-1]
    P = min(capacity, K)
    lead = theta.shape[:-1]
    counts = torch.empty((*lead, P), dtype=dtype, device=dev)
    topics = torch.empty_like(counts)
    over = torch.empty(lead, dtype=torch.bool, device=dev)
    if over.numel() == 0:
        return counts, topics, over
    with torch.cuda.device(dev):
        err = _lib().ell_select_launch(
            theta.data_ptr(), over.numel(), K, P, counts.data_ptr(),
            topics.data_ptr(), over.data_ptr(), counts.element_size(),
            _build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"ell_select launch failed: CUDA error {err}")
    ell_select.launches += 1
    return counts, topics, over


@_op.register_fake
def _(theta, capacity, dtype):
    lead = theta.shape[:-1]
    P = min(capacity, theta.shape[-1])
    counts = theta.new_empty((*lead, P), dtype=dtype)
    return counts, torch.empty_like(counts), theta.new_empty(
        lead, dtype=torch.bool)


ell_select.launches = 0    # kernel launches since the last reset
