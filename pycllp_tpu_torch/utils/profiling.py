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
    profiler, for ``key_averages()``.

    The trace holds the solver's own ranges, recorded while a profiler
    runs; with none running a range costs about 11 µs of host time (on an
    H100 machine's host, PyTorch 2.11).  Each nests in the entry call's
    range, the root of one call:

    * ``scenario_sweep``, ``hsd_solve_scan``, ``hsd_solve_batched``: the
      whole public call (a sweep's windows are ``hsd_solve_scan`` calls);
    * ``narrow stage``, ``finish stage``: the scan's two stages, with no
      sync added, so the device may still run a stage's work after its
      range ends (the kernels carry the launching call's correlation id);
    * ``ipm phase``: one IPM loop, from its static loads through its
      blocks and predicate reads to the copy of its state out;
    * ``segment``: one straight-line segment, from its key and lookup
      through its loads and replay to the copy of its outputs;
    * ``graph capture``: a new graph's eager warm-up and capture, inside
      the ``segment`` or the loop (an ``ipm phase``, or ``dense_path``'s)
      that needed it;
    * ``predicate read``, ``loop replay``, ``segment replay``: one read of
      a predicate by the host, one replay of a loop block or a segment;
    * ``sweep pull``, ``sweep write``: a sweep window's copy of its
      outputs to numpy, and each chunk file it writes.

    ``ipm phase`` and ``segment`` never nest in each other; a stage's own
    predicate reads lie outside both.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
