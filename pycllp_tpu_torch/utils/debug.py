"""Numerical debug mode.

Counterpart of :mod:`pycllp_tpu.utils.debug`.  Instances are independent
lanes, so there is nothing to race; the numerical hazard is the
factorization going non-PSD / non-finite in f32.  :func:`checked_solve`
localises WHERE a NUMERICAL lane first broke: it re-runs the lane with an
f64 shadow solve and bisects the f32 iteration cap for the first
iteration that ends NUMERICAL, and reports the state there.
"""

from __future__ import annotations

import numpy as np

from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS
from pycllp_tpu_torch.solvers.hsd import hsd_solve_batched
from pycllp_tpu_torch.solvers.options import SolverOptions, Status

__all__ = ["diagnose_numerical_lanes", "checked_solve"]


def checked_solve(A, b, c, opts: SolverOptions = SolverOptions(), kset=REFERENCE_KERNELS,
                  *, device="cuda"):
    """Solve; if any lane ends NUMERICAL, attach a diagnosis report.

    Returns ``(out, report)``: ``hsd_solve_batched``'s dict of tensors on
    ``device`` and a list of per-lane reports (empty on a clean batch).
    """
    out = hsd_solve_batched(A, b, c, opts, kset, device=device)
    status = out["status"].cpu().numpy()
    bad = np.flatnonzero(status == int(Status.NUMERICAL))
    report = diagnose_numerical_lanes(A, b, c, bad, opts, device=device) if bad.size else []
    return out, report


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


def diagnose_numerical_lanes(A, b, c, lanes, opts: SolverOptions, max_lanes: int = 4,
                             *, device="cuda"):
    """Re-solve failing lanes (f64 shadow run, then a bisection of the f32
    iteration cap) and report where the f32 trajectory breaks.

    Returns a list of dict reports, one per diagnosed lane, with the
    reference's keys: ``lane``, ``f64_status``, ``f64_iterations``,
    ``first_bad_f32_iteration``, ``scaling_spread_before_breakdown``,
    ``hint``.
    """
    reports = []
    A, b, c = _host(A), _host(b), _host(c)

    def lane_solve(Ai, bi, ci, dtype, o):
        npd = np.dtype(dtype)
        out = hsd_solve_batched(Ai.astype(npd), bi.astype(npd), ci.astype(npd), o, device=device)
        return {k: v[0].cpu().numpy() for k, v in out.items()}

    for lane in list(lanes)[:max_lanes]:
        bi = b[lane : lane + 1]
        ci = c[lane : lane + 1]
        Ai = A[lane] if A.ndim == 3 else A
        rep = {"lane": int(lane)}
        # f64 shadow: does the instance solve cleanly in high precision?
        shadow = lane_solve(Ai, bi, ci, "float64", opts.replace(dtype="float64", finish_dtype=None))
        rep["f64_status"] = int(shadow["status"])
        rep["f64_iterations"] = int(shadow["iterations"])
        # find the first f32 iteration that breaks by bisecting maxiter
        narrow = opts.replace(dtype="float32", finish_dtype=None)
        lo, hi = 1, opts.maxiter
        while lo < hi:
            mid = (lo + hi) // 2
            probe = lane_solve(Ai, bi, ci, "float32", narrow.replace(maxiter=mid))
            if int(probe["status"]) == int(Status.NUMERICAL):
                hi = mid
            else:
                lo = mid + 1
        rep["first_bad_f32_iteration"] = int(lo)
        # conditioning proxy at the pre-breakdown iterate
        probe = lane_solve(Ai, bi, ci, "float32", narrow.replace(maxiter=max(1, lo - 1)))
        x, z = probe["x"], probe["z"]
        with np.errstate(divide="ignore", invalid="ignore"):
            dspread = np.nanmax(x / np.maximum(z, 1e-30)) / max(
                np.nanmin(x / np.maximum(z, 1e-30)), 1e-30
            )
        rep["scaling_spread_before_breakdown"] = float(dspread)
        rep["hint"] = (
            "instance solves in f64 — raise reg_eps, enable kkt_refine, or "
            "use finish_dtype='float64'"
            if rep["f64_status"] == int(Status.OPTIMAL)
            else "instance is numerically hard even in f64 — check problem scaling"
        )
        reports.append(rep)
    return reports
