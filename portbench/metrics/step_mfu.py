"""step_mfu: the whole step's share of the card's peak, in %: the least
time of the window's last step on its inputs (``roofline/counts.py::
iteration``: the sweep and the advance), times the window's steps, over
the window's wall time; over several cards each card's shard, the mean.
The last step's count stands for every step's: a document's live topics
shrink, as a rule, as training goes, so it is about the smallest."""
from portbench.roofline import counts


def read(run):
    shares = []
    for r in run["ranks"]:
        c = r["least"]
        if not (r["trace"] and c):
            continue
        K = r["num_topics"]
        sweep = counts.sweep(
            c["tokens"], c["words"], c["pairs_live"], c["docs_live"],
            c["sparse_steps"], c["dense_tokens"], K, c["z_bytes"],
            c["ell_bytes"], counts.search_block(K))
        adv = counts.advance(c["tokens"], c["words"], c["changed_entries"],
                             c["z_bytes"])
        least = counts.least_ms(*counts.iteration(
            sweep, adv, c["tokens"], c["words"], c["z_bytes"]))
        shares.append(100 * least * r["iterations"]
                      / (run["ranks"][0]["window_s"] * 1e3))
    return sum(shares) / len(shares) if shares else None
