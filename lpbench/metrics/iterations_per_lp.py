"""iterations_per_lp (iter): the mean over the window's LPs of the
``iterations`` the entry returns for each (a sweep's, read back from its
checkpoint files)."""

import numpy as np


def read(run):
    its = [np.asarray(c.answers["iterations"]) for c in run.calls if c.answers is not None]
    n = sum(len(i) for i in its)
    return float(sum(i.sum(dtype=np.int64) for i in its)) / n if n else None
