"""kernel_ms.port (ms): device time per entry call, in the traced stretch,
of the program's own kernels: every kernel that ``lpbench/kernel_names.py`` does not name as PyTorch's, cuBLAS's, CUTLASS's or cuSOLVER's.  Each kernel's own duration, summed (kernels that overlap count
each)."""

from lpbench.kernel_names import is_library


def read(run):
    tr = run.trace
    if tr is None or not tr.batches or not tr.kernels:
        return None
    us = sum(e.end - e.start for e in tr.kernels if not is_library(e.name))
    return us / 1e3 / tr.batches
