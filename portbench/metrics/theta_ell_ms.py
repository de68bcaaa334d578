"""theta_ell_ms: ``trainer.theta_and_ell`` on the window's last step's
topics, called by the harness after the window and timed by CUDA events,
the mean of the calls (the slowest rank's)."""


def read(run):
    times = [r["theta_ell_ms"] for r in run["ranks"]
             if r["theta_ell_ms"] is not None]
    return max(times) if times else None
