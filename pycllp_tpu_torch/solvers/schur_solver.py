"""Registry-facing column-sharded (big-LP) solver.

Counterpart of :mod:`pycllp_tpu.solvers.schur_solver`: one LP — or a
small batch of them — whose variable dimension is sharded over the ranks
of a model mesh, the normal matrix all-reduced per iteration
(:func:`pycllp_tpu_torch.parallel.column_sharded_hsd_solve`).

Columns are zero-padded up to mesh divisibility with unit objective
coefficients (a zero column contributes nothing to ADAᵀ and its variable
sits at 0 with reduced cost 1 — invisible to the solution); the padding
is stripped from the returned x/z.
"""

from __future__ import annotations

import numpy as np

from pycllp_tpu_torch.parallel.schur import column_sharded_hsd_solve, model_mesh
from pycllp_tpu_torch.solvers.base import BaseSolver, register_solver
from pycllp_tpu_torch.solvers.options import Solution
from pycllp_tpu_torch.utils.device import resolve_device

__all__ = ["SchurSolver"]


@register_solver
class SchurSolver(BaseSolver):
    """Column-sharded HSD over a ``("model",)`` mesh.

    For LPs whose n (or the per-iteration O(m²·n) Gram work) exceeds one
    device: each rank owns n/P columns, the m×m normal matrix is
    all-reduced and factored on every rank.  Use the scenario-batched
    solvers (``hsd``/``hsd_pallas``) when the batch, not the LP, is big.

    ``mesh``: a model mesh (default :func:`model_mesh`: every rank of the
    process group, or one device without a group).  ``device``:
    ``"cuda"`` (default) or ``"cpu"``, checked at construction.
    """

    name = "schur"
    aliases = ("column_sharded", "big_lp")

    def __init__(self, options=None, *, mesh=None, device="cuda", **opt_kwargs):
        super().__init__(options, **opt_kwargs)
        self.mesh = mesh
        self.device = resolve_device(device)

    def _solve_impl(self, A, b, c) -> Solution:
        if getattr(A, "ndim", 2) != 2:
            raise ValueError(
                "schur solver shards the columns of ONE shared A; "
                "per-instance (3-D) A is not supported"
            )
        mesh = self.mesh if self.mesh is not None else model_mesh()
        n_dev = mesh.size()
        m, n = A.shape
        pad = (-n) % n_dev
        if pad:
            A = np.concatenate([A, np.zeros((m, pad), A.dtype)], axis=1)
            c = np.concatenate([c, np.ones((c.shape[0], pad), c.dtype)], axis=1)
        out = column_sharded_hsd_solve(A, b, c, self.options, mesh=mesh, device=self.device)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return Solution(
            x=out["x"][:, :n],
            y=out["y"],
            z=out["z"][:, :n],
            objective=out["objective"],
            status=out["status"],
            iterations=out["iterations"],
        )
