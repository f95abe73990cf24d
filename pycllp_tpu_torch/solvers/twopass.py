"""Compacted batch solve: cap, compact, resume.

Counterpart of :mod:`pycllp_tpu.solvers.twopass`.  A batched solve runs
every lane of a chunk until the SLOWEST lane terminates, so chunk cost
follows the max iteration count while useful work is the mean.  The one
mechanism that fixes this is the cap → compact → warm-resume sweep of
:func:`pycllp_tpu_torch.solvers.hsd.hsd_solve_scan` (``compact_cap=``);
``hsd_solve_two_pass`` is kept for API compatibility and, for shared 2-D
A, delegates to it (identical trajectories).  Only per-instance (3-D) A,
which the scan does not take, runs the host-side two-pass ladder:

1. **Pass 1** — solve every chunk with a short iteration cap.
2. **Compact** — pull statuses; lanes that hit the cap are gathered
   into power-of-two remnant buckets, padded by repeating the last lane.
3. **Pass 2** — the remnant re-solves from scratch with the full
   ``opts.maxiter`` budget; results scatter back.
"""

from __future__ import annotations

import numpy as np
import torch

from pycllp_tpu_torch.ops.reference import KernelSet, REFERENCE_KERNELS
from pycllp_tpu_torch.solvers.hsd import hsd_solve_batched, hsd_solve_scan
from pycllp_tpu_torch.solvers.options import SolverOptions, Status
from pycllp_tpu_torch.utils.device import resolve_device

__all__ = ["hsd_solve_two_pass"]

_OUT_KEYS = (
    "x", "y", "z", "tau", "kappa", "objective", "status", "iterations",
    "rho_p", "rho_d", "rho_gap",
)

REDUCE_ANY_NOT_PORTED = (
    "reduce_any= (collective termination across devices) belongs to the "
    "parallel slice of the port (ROADMAP.md §1 item 6), which is not ported yet"
)


def _bucket(size: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest power-of-two bucket ≥ size (clamped): few distinct shapes."""
    b = min_bucket
    while b < size and b < max_bucket:
        b *= 2
    return min(b, max_bucket)


def hsd_solve_two_pass(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    kset: KernelSet = REFERENCE_KERNELS,
    *,
    chunk: int | None = None,
    pass1_maxiter: int = 16,
    min_bucket: int = 1024,
    reduce_any=None,
    keys: tuple = _OUT_KEYS,
    device="cuda",
):
    """Solve ``min cᵀx, Ax=b, x≥0`` batched, with remnant compaction.

    Parameters mirror :func:`hsd_solve_batched`; additionally:

    chunk : rows per pass-1 solve (default: the whole batch at once).
    pass1_maxiter : iteration cap for pass 1.  Lanes still running at the
        cap continue (shared A: resume warm; 3-D A: re-solve from
        scratch) with the full ``opts.maxiter``.
    min_bucket : smallest remnant padding bucket.
    reduce_any : not ported (raises ``NotImplementedError``): collective
        termination is the parallel slice's.
    keys : which output fields to return.
    device : where the solves run (``"cuda"`` by default).

    Returns a dict of host numpy arrays restricted to ``keys`` (+
    ``status``).  For shared 2-D A ``iterations`` counts cumulatively
    across the warm resume; for 3-D A remnant lanes report the pass-2
    from-scratch count.
    """
    if reduce_any is not None:
        raise NotImplementedError(REDUCE_ANY_NOT_PORTED)
    dev = resolve_device(device)
    b = torch.as_tensor(b, device=dev)
    c = torch.as_tensor(c, device=dev)
    B = b.shape[0]
    chunk = B if chunk is None else min(chunk, B)
    if B % chunk:
        raise ValueError(f"batch {B} must be a multiple of chunk {chunk}")
    want = tuple(dict.fromkeys(("status",) + tuple(keys)))

    if getattr(A, "ndim", 2) == 2:
        # shared structure: the compact sweep IS the mechanism (pass-1 cap
        # → compaction → warm resume with the full budget).  The resume
        # bucket covers every lane, so no remnant overflows.
        out = hsd_solve_scan(
            A, b, c, opts, kset,
            chunk=chunk, keys=want,
            compact_cap=min(pass1_maxiter, opts.maxiter),
            compact_bucket=B,
            device=dev,
        )
        return {k: v.cpu().numpy() for k, v in out.items()}

    A = torch.as_tensor(A, device=dev)
    opts1 = opts.replace(maxiter=pass1_maxiter)
    # pass 1: every chunk capped; the status vector drives the compaction
    pass1 = []
    for k in range(B // chunk):
        sl = slice(k * chunk, (k + 1) * chunk)
        pass1.append(hsd_solve_batched(A[sl], b[sl], c[sl], opts1, kset, device=dev))
    status = torch.cat([p["status"] for p in pass1]).cpu().numpy()

    remnant = np.flatnonzero(status == int(Status.ITERATION_LIMIT))
    subs = []  # (row indices, pass-2 results)
    if remnant.size and opts.maxiter > pass1_maxiter:
        # pass 2: the unfinished lanes in padded bucket batches
        nb = _bucket(remnant.size, min_bucket, chunk)
        for s in range(-(-remnant.size // nb)):
            idx = remnant[s * nb : (s + 1) * nb]
            pad = nb - idx.size
            rows = np.concatenate([idx, np.repeat(idx[-1:], pad)]) if pad else idx
            r = torch.from_numpy(rows).to(dev)
            subs.append((idx, hsd_solve_batched(A[r], b[r], c[r], opts, kset, device=dev)))

    out = {}
    for key in want:
        vals = status.copy() if key == "status" else torch.cat([p[key] for p in pass1]).cpu().numpy()
        for idx, res in subs:
            vals[idx] = res[key][: idx.size].cpu().numpy()
        out[key] = vals
    return out
