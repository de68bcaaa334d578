"""idle_share: the share of the traced window in which no operation runs
on the card, in %; over several cards the idlest."""


def read(run):
    shares = [100 * (1 - r["trace"]["busy_s"] / r["trace"]["window_s"])
              for r in run["ranks"] if r["trace"]]
    return max(shares) if shares else None
