"""prep_s: the port's host preparation, on the host clock: ``tile_corpus``
and K2's segment table on one card, the ``DistributedLDA`` build over
several ranks (the slowest rank's)."""


def read(run):
    return max(r["setup_parts"]["prep_s"] for r in run["ranks"])
