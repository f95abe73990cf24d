"""kernel_ms.torch (ms): device time per entry call, in the traced stretch,
of the PyTorch, CUB, cuBLAS, CUTLASS and cuSOLVER kernels that ``lpbench/kernel_names.py`` names: the elementwise algebra, reductions, GEMMs and solves.  Each kernel's own duration, summed (kernels that overlap count
each)."""

from lpbench.kernel_names import is_library


def read(run):
    tr = run.trace
    if tr is None or not tr.batches or not tr.kernels:
        return None
    us = sum(e.end - e.start for e in tr.kernels if is_library(e.name))
    return us / 1e3 / tr.batches
