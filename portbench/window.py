"""The measured window of a training loop, and the clocks it reads.

The loop is the one ``repro_torch/train/driver.py::_run_loop`` composes
and the launcher runs: a step, the host reading the step's statistics
(which waits for the device), and every ``eval_every`` steps the
log-likelihood.  The window runs whole groups of ``eval_every`` steps and
closes at the first evaluation at or past ``seconds``, so its last state
is an evaluated one.
"""
from __future__ import annotations

import dataclasses
import time

import torch


class DeviceClock:
    """Marks on the card's timeline (CUDA events on the current stream):
    the time between two marks is the device's, whatever the host did
    meanwhile."""

    def __init__(self, device):
        self.device = device

    def mark(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        return e

    def sync(self):
        torch.cuda.synchronize(self.device)

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b)


class HostClock:
    """Marks on the host's clock, for a run on the CPU (the tests)."""

    def __init__(self, device=None):
        self.device = device

    def mark(self):
        return time.perf_counter()

    def sync(self):
        pass

    @staticmethod
    def ms(a, b) -> float:
        return (b - a) * 1e3


def clock_for(device) -> DeviceClock | HostClock:
    return DeviceClock(device) if device.type == "cuda" else HostClock()


@dataclasses.dataclass
class Window:
    state: object           # the last state
    prev_z: torch.Tensor    # the topics before the last step
    iterations: int
    start_wall: float       # time.time() at the first step's launch
    seconds: float          # host clock, first launch to the last eval's end
    iter_ms: list           # each step, launch to the end of its work
    eval_ms: list           # each evaluation
    ll_per_token: float     # the last evaluation


def train(step, ll_fn, state, seconds: float, eval_every: int, clock,
          stop=lambda up: up) -> Window:
    """Run ``step`` for at least ``seconds``, in groups of ``eval_every``
    steps each followed by ``ll_fn``.  ``stop(up)`` turns this process's
    "time is up" into the decision all processes of a run share."""
    marks, evals = [], []
    start_wall = time.time()
    t0 = time.perf_counter()
    n = 0
    while True:
        prev_z = state.z
        a = clock.mark()
        state, stats = step(state)
        b = clock.mark()
        float(stats.sparse_frac), float(stats.ell_overflow)
        float(stats.mean_s_over_sq)
        marks.append((a, b))
        n += 1
        if n % eval_every == 0:
            c = clock.mark()
            ll = float(ll_fn(state))
            d = clock.mark()
            evals.append((c, d))
            if stop(time.perf_counter() - t0 >= seconds):
                break
    wall = time.perf_counter() - t0
    clock.sync()
    return Window(state=state, prev_z=prev_z, iterations=n,
                  start_wall=start_wall, seconds=wall,
                  iter_ms=[clock.ms(a, b) for a, b in marks],
                  eval_ms=[clock.ms(c, d) for c, d in evals],
                  ll_per_token=ll)
