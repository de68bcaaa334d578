"""k2_roofline: the phi advance kernel's (K2, ``phi_count_kernel`` in delta
mode) share of its roofline on the window's last step, in %: the least
time of that step's advance (``roofline/counts.py::advance``) over the
kernel's device time in the trace; the mean over the ranks."""
from portbench.roofline import counts


def read(run):
    shares = []
    for r in run["ranks"]:
        if not (r["trace"] and r["least"]):
            continue
        launches = r["trace"]["launches"].get("phi_count_kernel")
        if not launches:
            continue
        c = r["least"]
        least = counts.least_ms(*counts.advance(
            c["tokens"], c["words"], c["changed_entries"], c["z_bytes"]))
        shares.append(100 * least / (launches[-1] * 1e3))
    return sum(shares) / len(shares) if shares else None
