"""Solver registry and the two-phase ``init``/``solve`` contract.

Counterpart of :mod:`pycllp_tpu.solvers.base`, unchanged in behaviour:
a name→class registry, ``BaseSolver.init(lp)`` once per structure and
``solve(lp)`` per scenario data (stochastic sweeps re-solve with fresh
b/c).  Solutions come back as host numpy arrays.
"""

from __future__ import annotations

from typing import Type

import numpy as np

from pycllp_tpu_torch.models import EqualityLP, GeneralLP, StandardLP
from pycllp_tpu_torch.solvers.options import Solution, SolverOptions

__all__ = [
    "BaseSolver",
    "solver_registry",
    "register_solver",
    "get_solver",
    "available_solvers",
]

solver_registry: dict[str, Type["BaseSolver"]] = {}


def register_solver(cls: Type["BaseSolver"]) -> Type["BaseSolver"]:
    """Class decorator: register under ``cls.name`` and any ``cls.aliases``."""
    solver_registry[cls.name] = cls
    for alias in getattr(cls, "aliases", ()):
        solver_registry[alias] = cls
    return cls


def get_solver(name: str, **kwargs) -> "BaseSolver":
    try:
        cls = solver_registry[name]
    except KeyError:
        raise KeyError(
            f"unknown solver {name!r}; available: {sorted(set(solver_registry))}"
        ) from None
    return cls(**kwargs)


def available_solvers(include_unavailable: bool = False) -> list[str]:
    names = sorted({cls.name for cls in solver_registry.values()})
    if include_unavailable:
        return names
    return [n for n in names if solver_registry[n].is_available()]


class BaseSolver:
    """Two-phase solver interface over :class:`StandardLP`.

    ``init(lp)`` performs the structure-dependent work (form conversion,
    staging, trace/compile); ``solve(lp)`` performs the numeric solve and
    may be called repeatedly with updated ``b``/``c`` (same structure).
    """

    name: str = "base"
    aliases: tuple[str, ...] = ()

    def __init__(self, options: SolverOptions | None = None, **opt_kwargs):
        if options is None:
            options = SolverOptions(**opt_kwargs)
        elif opt_kwargs:
            options = options.replace(**opt_kwargs)
        self.options = options
        self._eq: EqualityLP | None = None

    @classmethod
    def is_available(cls) -> bool:
        return True

    # -- lifecycle --------------------------------------------------------

    def init(self, lp: StandardLP | GeneralLP) -> None:
        if isinstance(lp, GeneralLP):
            lp, self._general_map = lp.to_standard_form()
        else:
            self._general_map = None
        self._std = lp
        self._eq = lp.to_equality_form()
        self._init_impl(self._eq)

    def solve(self, lp: StandardLP | GeneralLP | None = None) -> Solution:
        if lp is not None or self._eq is None:
            self.init(lp if lp is not None else self._std)
        else:
            # init-once / re-solve contract: the caller may mutate the
            # held problem's b/c between solves (the upstream stochastic
            # re-solve pattern), so refresh the equality-form arrays from
            # the CURRENT StandardLP.  Structure (A sparsity/shape) is
            # assumed unchanged — that is what ``init`` is for.
            self._eq = self._std.to_equality_form()
        eq = self._eq
        A, b, c = np.asarray(eq.A), np.asarray(eq.b), np.asarray(eq.c)
        squeeze = b.ndim == 1
        if squeeze:
            b, c = b[None], c[None]
            if A.ndim == 3:
                A = A[0]
        sol = self._solve_impl(A, b, c)
        # map equality-form solution back to the Vanderbei (max, ≤) form
        nstruct = eq.n_structural
        x = sol.x[..., :nstruct]
        z = sol.z[..., :nstruct]
        y = -sol.y
        obj = -sol.objective + np.asarray(eq.f)
        out = Solution(
            x=x[0] if squeeze else x,
            y=y[0] if squeeze else y,
            z=z[0] if squeeze else z,
            objective=obj[0] if squeeze else obj,
            status=sol.status[0] if squeeze else sol.status,
            iterations=sol.iterations[0] if squeeze else sol.iterations,
            rho_p=None if sol.rho_p is None else (sol.rho_p[0] if squeeze else sol.rho_p),
            rho_d=None if sol.rho_d is None else (sol.rho_d[0] if squeeze else sol.rho_d),
            rho_gap=None if sol.rho_gap is None else (sol.rho_gap[0] if squeeze else sol.rho_gap),
        )
        if self._general_map is not None:
            # map the standard-form solution back to the user's general
            # form: variables un-shift/un-split, objective re-signed,
            # row duals folded over the ± split rows.
            fm = self._general_map
            out = Solution(
                x=fm.recover_x(out.x),
                y=fm.recover_duals(out.y),
                z=out.z,
                objective=fm.recover_objective(out.objective),
                status=out.status,
                iterations=out.iterations,
                rho_p=out.rho_p,
                rho_d=out.rho_d,
                rho_gap=out.rho_gap,
            )
        return out

    # -- backend hooks ----------------------------------------------------

    def _init_impl(self, eq: EqualityLP) -> None:  # pragma: no cover - default no-op
        pass

    def _solve_impl(self, A, b, c) -> Solution:
        """Solve batched equality form; A (m,n)|(B,m,n), b (B,m), c (B,n).

        Must return a :class:`Solution` in equality-form coordinates with
        the batch axis present.
        """
        raise NotImplementedError
