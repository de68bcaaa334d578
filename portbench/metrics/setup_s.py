"""setup_s: from the start of the process to the launch of the window's
first step (rank 0's), the spawn of the ranks included."""


def read(run):
    return run["ranks"][0]["start_wall"] - run["start"]
