"""Profiling helpers: FLOP model + achieved-rate accounting.

Counterpart of :mod:`pycllp_tpu.utils.profiling`: the same per-iteration
FLOP model, and a thin ``torch.profiler`` wrapper in place of the
reference's ``jax.profiler`` one.  The reference's peak constants belong
to its own device and its JAX benchmark, so none is carried over.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

__all__ = ["ipm_iteration_flops", "solve_flops", "achieved_tflops", "trace"]


def ipm_iteration_flops(m: int, n: int, n_rhs: int = 3) -> int:
    """FLOPs for one HSD iteration of one instance (dense, shared A).

    normal-eq formation 2·m²·n (as W@d: 2·m²·n), Cholesky m³/3,
    ``n_rhs`` forward+backward solves 2·n_rhs·m², ~8 A-matvecs 2·m·n
    each (residuals, sym_solve assemblies), vector ops O(n).
    """
    return int(
        2 * m * m * n  # M = W @ d
        + m**3 // 3  # Cholesky
        + 2 * n_rhs * 2 * m * m  # triangular solves
        + 8 * 2 * m * n  # matvecs
        + 20 * n  # elementwise
    )


def solve_flops(m: int, n: int, iterations, n_rhs: int = 3):
    """Total FLOPs for a batch: sum of per-instance iteration counts."""
    return int(np.sum(np.asarray(iterations)) * ipm_iteration_flops(m, n, n_rhs))


def achieved_tflops(total_flops: int, seconds: float) -> float:
    return total_flops / seconds / 1e12


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when a
    card is present) and write a Chrome trace (``trace.json``, view with
    Perfetto or ``chrome://tracing``) into ``log_dir``.  Yields the
    profiler, for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
