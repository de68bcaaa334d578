"""sync_ms: the device time of NCCL kernels a step, from the trace, the
mean over the ranks: the phi sync and the step's small reductions (the
kernels' time includes waiting for the slowest rank)."""


def read(run):
    ms = [1e3 * r["trace"]["nccl_s"] / r["iterations"]
          for r in run["ranks"] if r["trace"] and r["trace"]["nccl_s"] > 0]
    return sum(ms) / len(ms) if ms else None
