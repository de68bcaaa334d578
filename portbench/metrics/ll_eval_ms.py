"""ll_eval_ms: the mean of the window's log-likelihood evaluations, each
timed by CUDA events around it (rank 0's)."""
import statistics


def read(run):
    ms = run["ranks"][0]["eval_ms"]
    return statistics.mean(ms) if ms else None
