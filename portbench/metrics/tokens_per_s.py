"""tokens_per_s: tokens resampled by every step of the window, over the
window's wall seconds (rank 0's host clock, evaluations inside); over
several ranks the whole corpus's tokens a step."""


def read(run):
    r = run["ranks"][0]
    return r["tokens"] * r["iterations"] / r["window_s"]
