"""Reading a ``torch.profiler`` trace of the measured window: the device's
busy time, device time by operation, the launches of named kernels, and
the device's idle gaps labelled by what the host was doing meanwhile.

Origin: ``chip_smoke.py::device_busy`` (the union of the device events'
intervals, the kernels with the most device time).  What differs: the
gaps between device events are also kept, and each of the longest is
labelled by the innermost host operation running at its middle.
"""
from __future__ import annotations

import numpy as np

LABELLED_GAPS = 500     # the longest gaps labelled one by one
TOP = 10


def summarize(prof, window_s: float, kernels=()) -> dict | None:
    """The window's device reading, or None when the trace holds no device
    time (a run on the CPU, or a profiler that sees no kernels).

    Returns ``busy_s`` (the union of the device intervals), ``window_s``,
    ``ops`` ({name: seconds} of device time), ``launches`` ({k: [seconds
    of each launch whose name contains k, in order]} for each k of
    ``kernels``), ``nccl_s`` (device time of NCCL kernels) and
    ``idle_gaps`` ([[host operation, seconds], ...], the longest first)."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        return None
    spans = np.array(sorted((e.time_range.start, e.time_range.end)
                            for e in dev), dtype=np.float64)
    busy_us, end = 0.0, -np.inf
    gaps = []
    for a, b in spans:
        if b > end:
            if a > end > -np.inf:
                gaps.append((end, a))
            busy_us += b - max(a, end)
            end = b
    ops: dict[str, float] = {}
    launches = {k: [] for k in kernels}
    nccl = 0.0
    for e in sorted(dev, key=lambda e: e.time_range.start):
        us = e.time_range.elapsed_us()
        ops[e.name] = ops.get(e.name, 0.0) + us * 1e-6
        for k in kernels:
            if k in e.name:
                launches[k].append(us * 1e-6)
        if "nccl" in e.name.lower():
            nccl += us * 1e-6
    return dict(busy_s=busy_us * 1e-6, window_s=window_s, ops=ops,
                launches=launches, nccl_s=nccl,
                idle_gaps=label_gaps(events, gaps))


def label_gaps(events, gaps) -> list:
    """[[label, seconds], ...]: the ``LABELLED_GAPS`` longest device gaps,
    each labelled by the shortest host operation that spans its middle
    ("host idle or in Python" where none does), summed by label, the
    largest first, ``TOP`` of them; the shorter gaps summed as one
    entry."""
    from torch.autograd import DeviceType

    if not gaps:
        return []
    host = [e for e in events if e.device_type == DeviceType.CPU]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    g = np.array(gaps, dtype=np.float64)
    length = g[:, 1] - g[:, 0]
    order = np.argsort(-length)
    sums: dict[str, float] = {}
    for i in order[:LABELLED_GAPS]:
        mid = (g[i, 0] + g[i, 1]) / 2
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        if inside.size:
            j = inside[np.argmin(ends[inside] - starts[inside])]
            label = host[j].name
        else:
            label = "host idle or in Python"
        sums[label] = sums.get(label, 0.0) + length[i] * 1e-6
    rest = float(length[order[LABELLED_GAPS:]].sum()) * 1e-6
    top = sorted(sums.items(), key=lambda kv: -kv[1])[:TOP - 1]
    if rest > 0:
        top.append(("shorter gaps", rest))
    return [[name[:160], s] for name, s in top]


def top_ops(ops: dict, n: int = TOP) -> list:
    """[[name, seconds], ...] of the ``n`` device operations with the most
    time."""
    return [[k[:160], v] for k, v in
            sorted(ops.items(), key=lambda kv: -kv[1])[:n]]
