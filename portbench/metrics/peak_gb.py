"""peak_gb: the largest ``torch.cuda.max_memory_allocated`` of the cell's
cards over the port's set-up and the window, in GB (1e9 bytes)."""


def read(run):
    return max(r["peak_bytes"] for r in run["ranks"]) / 1e9
