"""Solver options, status codes, and the solution container.

Counterpart of :mod:`pycllp_tpu.solvers.options`: the same fields with
the same defaults, so a reference configuration carries over field for
field (:func:`pycllp_tpu_torch.interop.options_from_reference`).  Every
value the reference accepts runs, ``finish_kset="df64_fastform"`` (its
recorded negative result) included.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Any

import numpy as np

__all__ = ["SolverOptions", "Status", "Solution"]


class Status(enum.IntEnum):
    """Per-instance termination status.

    Matches the classic interior-point status convention (optimal /
    iteration limit / primal infeasible / dual infeasible a.k.a.
    unbounded / numerical breakdown).  ``RUNNING`` is internal.
    """

    RUNNING = -1
    OPTIMAL = 0
    ITERATION_LIMIT = 1
    INFEASIBLE = 2
    UNBOUNDED = 3
    NUMERICAL = 4
    STALLED = 5  # no indicator progress for `stall_patience` iterations;
    # the reported point is the best iterate reached (f32 floor behaviour)


@dataclass(frozen=True)
class SolverOptions:
    """Hashable solver configuration.

    Attributes
    ----------
    tol:
        Relative optimality tolerance (primal/dual residual and gap).
    maxiter:
        Iteration cap for the IPM loop (absolute in the loop counter k).
    alpha0:
        Fraction-to-the-boundary step damping (Mehrotra's 0.99995).
    mehrotra:
        Use predictor-corrector (True) or single centering step (False).
    gamma:
        Fixed centering parameter when ``mehrotra=False``.
    reg_eps:
        Relative diagonal (Tikhonov) regularization added to the normal
        matrix before Cholesky, scaled by its max diagonal.
    refine_steps:
        Iterative-refinement sweeps on each normal-equations solve.
    scale:
        Apply Ruiz equilibration to A (and fold into b, c) before
        solving; strongly recommended for f32.
    dtype:
        Compute dtype ("float32"/"float64"/None=follow inputs).
    kkt_refine:
        Iterative-refinement passes on the full 5-block Newton system
        (each pass = one extra normal-equations solve).
    stall_patience:
        Iterations without best-score progress before a lane is frozen
        as STALLED (its best iterate is returned).
    finish_dtype:
        Wide finish phase dtype ("float64"; None = narrow only): the
        narrow phase stops at ``switch_tol`` and a wide finish (vertex
        crossover or wide IPM, ``finish_mode``) polishes to ``tol``.
    """

    tol: float = 1e-6
    maxiter: int = 100
    alpha0: float = 0.99995
    mehrotra: bool = True
    gamma: float = 0.1
    reg_eps: float | None = None  # None → dtype-dependent default
    refine_steps: int | None = None  # None → dtype-dependent default
    scale: bool = True
    dtype: str | None = None
    kkt_refine: int = 0
    kkt_refine_pred: int | None = None  # KKT refinement sweeps for the
    # PREDICTOR direction only (None = kkt_refine).  The predictor is
    # never taken: it gauges μ_aff (→ centering weight γ) and feeds the
    # corrector's second-order products, so it tolerates fewer sweeps.
    kkt_warmup: int = 0  # narrow iterations run at kkt_refine=0 before
    # the configured kkt_refine engages (0 = refine from the start)
    gondzio_correctors: int = 0  # extra centrality-corrector solves per
    # iteration (Gondzio); reduces iteration count for ~1 solve each
    stall_patience: int = 12
    stall_rtol: float = 0.0  # minimum RELATIVE best-score improvement that
    # counts as progress for the stall clock (0 = any improvement).  Best-
    # iterate tracking itself still accepts ANY improvement.
    # -- wide finish --
    finish_dtype: str | None = None
    finish_maxiter: int = 20
    switch_tol: float = 1e-3
    finish_kset: str = "df64"
    finish_patience: int = 8
    finish_restart: bool = True
    finish_mode: str = "ipm"
    crossover_refine: int = 2
    crossover_feas_tol: float = 1e-9
    crossover_kset: str = "mixed1"
    crossover_repair: int = 2
    finish_kkt_refine: int | None = None
    finish_gondzio: int = 0
    # ---------------------------------------------------------------------
    log_every: int = 0  # emit structured per-iteration metrics every k
    # iterations (0 = off; see pycllp_tpu_torch.utils.logging)
    init_point: str = "ones"  # "ones" (blind HSD start) or "mehrotra"
    # (least-squares start: one extra factorization)
    warm_start: bool = False  # registry-level: reuse the previous solve's
    # solution as the starting point for the next solve on the same
    # structure; on the chunked scan path, chunk-to-chunk warm chaining.
    warm_lambda: float = 0.05  # interiorization blend for a warm start

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)

    def resolved_reg_eps(self, dtype) -> float:
        if self.reg_eps is not None:
            return self.reg_eps
        return 2e-6 if _is_f32(dtype) else 1e-12

    def resolved_finish_kkt_refine(self) -> int:
        return self.kkt_refine if self.finish_kkt_refine is None else self.finish_kkt_refine

    def resolved_kkt_refine_pred(self) -> int:
        return self.kkt_refine if self.kkt_refine_pred is None else self.kkt_refine_pred

    def resolved_refine_steps(self, dtype) -> int:
        if self.refine_steps is not None:
            return self.refine_steps
        return 1 if _is_f32(dtype) else 0


def _is_f32(dtype) -> bool:
    """True for float32 given as a string, numpy dtype or torch dtype."""
    return str(dtype).removeprefix("torch.") == "float32"


@dataclass
class Solution:
    """Batched solve result (host numpy arrays).

    All arrays carry the instance batch axis first (absent for an
    unbatched solve).  ``x``/``y``/``z`` are in the coordinates of the
    form that was solved; container-level ``solve()`` wrappers map them
    back to the user's form.
    """

    x: Any  # primal (..., n)
    y: Any  # row duals (..., m)
    z: Any  # reduced costs (..., n)
    objective: Any  # (...,)
    status: Any  # (...,) int32 Status codes
    iterations: Any  # (...,)
    # convergence diagnostics at exit
    rho_p: Any = None
    rho_d: Any = None
    rho_gap: Any = None

    @property
    def converged(self):
        return np.asarray(self.status) == int(Status.OPTIMAL)

    def __repr__(self) -> str:
        st = np.atleast_1d(np.asarray(self.status))
        it = np.atleast_1d(np.asarray(self.iterations))
        n_opt = int((st == int(Status.OPTIMAL)).sum())
        return (
            f"Solution(n={st.size}, optimal={n_opt}, "
            f"iters[min/mean/max]={it.min()}/{it.mean():.1f}/{it.max()})"
        )
