"""iter_ms_p90: the 90th percentile of the window's steps, each from its
launch to the end of its work on the card (rank 0's CUDA events; over
several ranks its step waits on the sync)."""
from portbench import stats


def read(run):
    return stats.percentile(run["ranks"][0]["iter_ms"], 90)
