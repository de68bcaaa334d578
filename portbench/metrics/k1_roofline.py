"""k1_roofline: the sweep kernel's (K1, ``lda_sample_kernel``) share of its
roofline on the window's last step, in %: the least time of that step's
sweep on its inputs (``roofline/counts.py::sweep``, at the published
peaks) over the kernel's device time in the trace; the mean over the
ranks."""
from portbench.roofline import counts


def read(run):
    shares = []
    for r in run["ranks"]:
        if not (r["trace"] and r["least"]):
            continue
        launches = r["trace"]["launches"].get("lda_sample_kernel")
        if not launches:
            continue
        c = r["least"]
        least = counts.least_ms(*counts.sweep(
            c["tokens"], c["words"], c["pairs_live"], c["docs_live"],
            c["sparse_steps"], c["dense_tokens"], r["num_topics"],
            c["z_bytes"], c["ell_bytes"], counts.search_block(
                r["num_topics"])))
        shares.append(100 * least / (launches[-1] * 1e3))
    return sum(shares) / len(shares) if shares else None
