"""batch_s.p95 (s): the 95th percentile (linear interpolation) of the wall
of every call in the window, from the call of the entry to the pull of its
answers to the host, by the host clock."""

import numpy as np


def read(run):
    walls = [c.wall for c in run.calls]
    return float(np.percentile(walls, 95)) if walls else None
