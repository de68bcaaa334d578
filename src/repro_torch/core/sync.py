"""Model synchronisation (paper §5.2) as ``torch.distributed`` collectives,
as ``repro.core.sync``.

The paper reduces the phi replicas with a log(G) tree and broadcasts the
sum, on the cards.  Here that is one all-reduce over a process group: NCCL's
ring or tree on a ``cuda`` mesh, gloo's on a ``cpu`` one.  Every function
takes a ``torch.distributed.ProcessGroup`` where the reference takes mesh
axis names; ``None`` means no collective (one device).  The reductions run
in place: the tensor given is the result (callers hand in fresh counts).

Partition modes (``repro_torch.distributed.partition``):
  * 1d, the paper's: documents over every rank, phi replicated -> phi
    deltas all-reduced over all ranks (the data group);
  * 2d doc x word: documents over the data group, vocabulary over the model
    group -> phi deltas all-reduced over the data group only (1/|model| of
    the 1d volume), theta partials over the model group.

``compressed_sync_phi`` carries int16 as bytes: neither gloo nor NCCL takes
a 16-bit integer (fault F4), so the int16 delta travels as ``uint8`` views,
a reduce-scatter (``all_to_all_single`` and a local sum) and an all-gather.
"""
from __future__ import annotations

import warnings
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core import updates


class PendingSync:
    """A sync in flight (``async_op=True``): ``wait()`` returns its result.
    The tensors it reduces must not change until then."""

    def __init__(self, finish: Callable[[], torch.Tensor]):
        self._finish = finish

    def wait(self) -> torch.Tensor:
        return self._finish()


def all_gather_bytes(out: torch.Tensor, part: torch.Tensor, group) -> None:
    """``all_gather_into_tensor`` of ``uint8`` tensors: ``out`` holds every
    rank's ``part`` in group order.  The name exists in every torch the
    port runs on; newer ones call it deprecated, which is not news here."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, part, group=group)


def maybe_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; ``x`` itself without one."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def sync_phi(phi_local: torch.Tensor, data_group) -> torch.Tensor:
    """C3: reduce + broadcast of the per-shard phi counts."""
    return maybe_all_reduce(phi_local, data_group)


def sync_theta(theta_partial: torch.Tensor, model_group) -> torch.Tensor:
    """2d: a document's tokens are split over the word shards, so its theta
    row is the sum over the model group.  No-op in 1d."""
    return maybe_all_reduce(theta_partial, model_group)


def global_phi_sum(phi_vk: torch.Tensor, model_group) -> torch.Tensor:
    """(K,) int32 per-topic totals (int32, as ``jnp.sum`` keeps it: F3); in
    2d phi's rows live on the word shards."""
    return maybe_all_reduce(updates.phi_totals(phi_vk), model_group)


def sync_phi_delta(phi_delta: torch.Tensor, data_group,
                   heavy_rows: torch.Tensor | None = None,
                   compressed: bool = False, async_op: bool = False):
    """One phi-delta all-reduce: compressed int16 (+ int32 heavy-row
    corrections) when asked, plain int32 otherwise.

    Both sync schedules go through here: the end-of-iteration sync and the
    per-micro-chunk one (``LDAConfig.sync_overlap``).  The sum is linear
    over the integers, so per-chunk syncs add up to the one-shot result
    exactly, the compressed wire included (a chunk's per-entry flux is
    bounded by the iteration's).  ``async_op`` returns a ``PendingSync``."""
    if compressed and data_group is not None:
        return compressed_sync_phi(phi_delta, data_group, heavy_rows,
                                   async_op)
    if data_group is None or not async_op:
        out = sync_phi(phi_delta, data_group)
        return PendingSync(lambda: out) if async_op else out
    work = dist.all_reduce(phi_delta, group=data_group, async_op=True)

    def finish():
        work.wait()
        return phi_delta
    return PendingSync(finish)


def compressed_sync_phi(phi_delta: torch.Tensor, data_group,
                        heavy_rows: torch.Tensor | None = None,
                        async_op: bool = False):
    """C7 on the wire: the per-iteration phi delta summed in int16, half the
    bytes of an int32 all-reduce.

    Exact where the **global** per-entry sum fits int16: addition mod 2^16
    is associative, so the wrapped sum is the true one whenever that lies
    in [-2^15, 2^15), which holds for every word with fewer than 2^15
    occurrences.  ``heavy_rows`` — the (H,) local rows
    ``partition.heavy_word_rows`` gives — are all-reduced again in int32
    and written over the wrapped rows.  Duplicate or padding ids are
    harmless (each writes its row's exact sum).

    The wire (fault F4: the collectives take no int16): the delta cast to
    int16 (wrapping) and padded to G equal chunks; ``all_to_all_single`` of
    its ``uint8`` view sends chunk j to rank j; each rank adds the G int16
    chunks it received (int16 adds wrap mod 2^16, the same residue as an
    int32 sum cast back); ``all_gather_into_tensor`` of the reduced
    chunk's ``uint8`` view.  Each rank sends and receives 2 (G - 1) / G
    * 2 bytes an entry, half of an int32 ring all-reduce.  With G = 1 every
    step still runs.  Returns (V, K) int32, or a ``PendingSync`` of it
    whose first collective (and the heavy rows') is already in flight."""
    if data_group is None:
        return PendingSync(lambda: phi_delta) if async_op else phi_delta
    G = dist.get_world_size(data_group)
    n = phi_delta.numel()
    c = -(-n // G)
    # narrow and fill_block, not Python indexing and copy_: the dry run
    # traces this on fake cuda tensors (updates' module docstring)
    send = torch.empty(G * c, dtype=torch.int16, device=phi_delta.device)
    updates.fill_block(send.narrow(0, 0, n),            # int32 -> int16 wraps
                       phi_delta.reshape(-1))
    send.narrow(0, n, G * c - n).zero_()
    recv = torch.empty_like(send)
    w_a2a = dist.all_to_all_single(recv.view(torch.uint8),
                                   send.view(torch.uint8), group=data_group,
                                   async_op=True)
    heavy = heavy_rows is not None and heavy_rows.numel() > 0
    if heavy:
        heavy_rows = heavy_rows.to(torch.long)
        exact = phi_delta.index_select(0, heavy_rows)          # (H, K) int32
        w_heavy = dist.all_reduce(exact, group=data_group, async_op=True)

    def finish():
        w_a2a.wait()
        chunks = recv.view(G, c).unbind(0)
        part = chunks[0]
        for j in range(1, G):
            part = part + chunks[j]
        out = torch.empty_like(send)
        all_gather_bytes(out.view(torch.uint8), part.view(torch.uint8),
                         data_group)
        s = out.narrow(0, 0, n).view(phi_delta.shape).to(torch.int32)
        if heavy:
            w_heavy.wait()
            s.index_copy_(0, heavy_rows, exact)
        return s

    return PendingSync(finish) if async_op else finish()
