"""device_idle_share (%): the share of the traced stretch's wall (host
clock) in which no operation ran on the device: 1 − the union of the
intervals of its kernels, copies and fills over the stretch."""

from lpbench.trace import union


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - union(tr.device_ops) / 1e6 / tr.window_s)
