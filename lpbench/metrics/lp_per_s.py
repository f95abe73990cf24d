"""lp_per_s (LP/s): every LP the window's calls returned, over the
window's wall by the host clock.  A call's LPs count once its answers are
on the host (a sweep's, once it has written every chunk)."""


def read(run):
    return run.lps / run.window_s if run.window_s > 0 else None
