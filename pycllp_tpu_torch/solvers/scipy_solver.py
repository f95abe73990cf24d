"""Host-side scipy oracle backend.

Counterpart of :mod:`pycllp_tpu.solvers.scipy_solver`: the correctness
oracle every accelerated backend is cross-checked against.  Loops over
instances on the host with ``scipy.optimize.linprog(method="highs")``;
intended for tests and tiny problems only.
"""

from __future__ import annotations

import numpy as np

from pycllp_tpu_torch.solvers.base import BaseSolver, register_solver
from pycllp_tpu_torch.solvers.options import Solution, Status

__all__ = ["ScipySolver"]


@register_solver
class ScipySolver(BaseSolver):
    """``device=`` is accepted so that one ``get_solver(name, device=...)``
    call fits every registry name; this backend always runs on the host."""

    name = "scipy"
    aliases = ("oracle",)

    def __init__(self, options=None, *, device=None, **opt_kwargs):
        super().__init__(options, **opt_kwargs)

    @classmethod
    def is_available(cls) -> bool:
        try:
            import scipy.optimize  # noqa: F401

            return True
        except ImportError:  # pragma: no cover
            return False

    def _solve_impl(self, A, b, c) -> Solution:
        from scipy.optimize import linprog

        B = b.shape[0]
        m, n = A.shape[-2], A.shape[-1]
        xs = np.zeros((B, n))
        ys = np.zeros((B, m))
        zs = np.zeros((B, n))
        obj = np.zeros(B)
        status = np.zeros(B, dtype=np.int32)
        iters = np.zeros(B, dtype=np.int32)
        for i in range(B):
            Ai = A[i] if A.ndim == 3 else A
            res = linprog(
                c[i],
                A_eq=Ai,
                b_eq=b[i],
                bounds=[(0, None)] * n,
                method="highs",
            )
            # scipy status: 0 ok, 1 iterlimit, 2 infeasible, 3 unbounded, 4 numerical
            status[i] = {0: Status.OPTIMAL, 1: Status.ITERATION_LIMIT, 2: Status.INFEASIBLE,
                         3: Status.UNBOUNDED}.get(res.status, Status.NUMERICAL)
            iters[i] = getattr(res, "nit", 0)
            if res.x is not None:
                xs[i] = res.x
                obj[i] = res.fun
            if getattr(res, "eqlin", None) is not None and res.eqlin.marginals is not None:
                # scipy's equality duals are the negative of our convention
                ys[i] = -res.eqlin.marginals
                zs[i] = c[i] - Ai.T @ ys[i]
        return Solution(x=xs, y=ys, z=zs, objective=obj, status=status, iterations=iters)
