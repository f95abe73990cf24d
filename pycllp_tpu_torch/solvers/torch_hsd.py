"""Registry-facing PyTorch HSD solvers (reference-kernel and CUDA-kernel).

Counterpart of :mod:`pycllp_tpu.solvers.jax_hsd`.  Both classes run the
same HSD core (:mod:`pycllp_tpu_torch.solvers.hsd`) and differ only in
which :class:`KernelSet` feeds the hot path.  The registry names are the
reference's (``hsd`` with alias ``jax_hsd``; ``hsd_pallas`` with aliases
``clhsd`` and ``pallas``), so ``get_solver(...)`` calls carry over
unchanged, plus the keywords ``device=`` (default ``"cuda"``) and
``ozaki_bits=`` / ``ozaki_mv_bits=`` (the reference's ``PYCLLP_OZAKI_BITS``
/ ``PYCLLP_OZAKI_MV_BITS``).
"""

from __future__ import annotations

import numpy as np

from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS, BatchLastKernels
from pycllp_tpu_torch.ops.df64 import check_ozaki_width
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS, KernelSet
from pycllp_tpu_torch.solvers.base import BaseSolver, register_solver
from pycllp_tpu_torch.solvers.hsd import hsd_solve_batched, hsd_solve_scan
from pycllp_tpu_torch.solvers.options import Solution, Status
from pycllp_tpu_torch.utils.device import resolve_device

__all__ = ["TorchHSDSolver", "CudaHSDSolver"]

_SOLUTION_KEYS = (
    "x", "y", "z", "objective", "status", "iterations",
    "rho_p", "rho_d", "rho_gap",
)

# statuses whose terminal point is a useful warm start for the next solve
_WARMABLE = (int(Status.OPTIMAL), int(Status.STALLED), int(Status.ITERATION_LIMIT))


def _sanitized_warm(out: dict, prev):
    """Per-lane warm cache update that cannot poison later solves.

    INFEASIBLE/UNBOUNDED lanes have τ→0 (x/τ blows up) and NUMERICAL
    lanes carry NaN; such lanes keep the previous warm point if one
    exists, else fall back to the blind start (x=z=1, y=0) — per lane.
    """
    keep = np.isin(out["status"], _WARMABLE)
    keep = keep & np.isfinite(out["x"]).all(-1)
    keep = keep & np.isfinite(out["y"]).all(-1) & np.isfinite(out["z"]).all(-1)
    if prev is None:
        prev = (np.ones_like(out["x"]), np.zeros_like(out["y"]), np.ones_like(out["z"]))
    kn = keep[:, None]
    return (
        np.where(kn, out["x"], prev[0]),
        np.where(kn, out["y"], prev[1]),
        np.where(kn, out["z"], prev[2]),
    )


@register_solver
class TorchHSDSolver(BaseSolver):
    """Batched HSD IPM on the plain PyTorch kernel set.

    Large-batch throughput knobs (shared 2-D A only; see
    :func:`~pycllp_tpu_torch.solvers.hsd.hsd_solve_scan`):

    chunk : solve the batch as a loop of chunk-wide masked solves.
    compact_cap / compact_bucket : cap every chunk, finish the slow tail
        compacted into one bucket that resumes warm.
    device : ``"cuda"`` (default) or ``"cpu"``; checked here, so a CUDA
        request without a card fails at construction.
    ozaki_bits / ozaki_mv_bits : the Ozaki widths of the wide finish (None:
        66 / 48 bits).  Checked here; the plain set's finish runs no Ozaki
        product, so on this class they change nothing, as the reference's
        variables change nothing on its plain solver.
    """

    name = "hsd"
    aliases = ("jax_hsd",)  # the reference's registry name, kept so its calls carry over
    kernels: KernelSet = REFERENCE_KERNELS

    def __init__(
        self,
        options=None,
        *,
        chunk: int | None = None,
        compact_cap: int | None = None,
        compact_bucket: int = 8192,
        device="cuda",
        ozaki_bits: int | None = None,
        ozaki_mv_bits: int | None = None,
        **opt_kwargs,
    ):
        super().__init__(options, **opt_kwargs)
        self.device = resolve_device(device)
        if ozaki_bits is not None or ozaki_mv_bits is not None:
            self.kernels = self._kernels_at(ozaki_bits, ozaki_mv_bits)
        self.chunk = chunk
        self.compact_cap = compact_cap
        self.compact_bucket = compact_bucket
        self._warm = None  # (x, y, z) equality-coordinate solution of the
        # previous solve, kept when options.warm_start is set

    def _kernels_at(self, bits, mv_bits) -> KernelSet:
        for width, what in ((bits, "ozaki_bits"), (mv_bits, "ozaki_mv_bits")):
            if width is not None:
                check_ozaki_width(width, what)
        return self.kernels

    def _init_impl(self, eq) -> None:
        self._warm = None  # new structure invalidates the warm point

    def _solve_impl(self, A, b, c) -> Solution:
        scan = (self.chunk or self.compact_cap) and np.ndim(A) == 2
        if scan:
            # warm_start on the scan path means chunk-to-chunk warm
            # chaining WITHIN the batch; solve-to-solve caching stays off
            out = hsd_solve_scan(
                A, b, c, self.options, self.kernels,
                chunk=self.chunk or b.shape[0], keys=_SOLUTION_KEYS,
                compact_cap=self.compact_cap,
                compact_bucket=self.compact_bucket,
                warm_chain=self.options.warm_start,
                device=self.device,
            )
        else:
            warm = None
            if self.options.warm_start and self._warm is not None:
                shapes_match = (
                    self._warm[0].shape == (b.shape[0], c.shape[-1])
                    and self._warm[1].shape == b.shape
                )
                warm = self._warm if shapes_match else None
            out = hsd_solve_batched(
                A, b, c, self.options, self.kernels, warm=warm, device=self.device,
            )
        out = {k: out[k].cpu().numpy() for k in _SOLUTION_KEYS}
        if self.options.warm_start and not scan:
            self._warm = _sanitized_warm(out, self._warm)
        return Solution(**out)


@register_solver
class CudaHSDSolver(TorchHSDSolver):
    """Batched HSD on the batch-last kernel set: hand-written CUDA
    Cholesky and solve kernels (:mod:`pycllp_tpu_torch.ops.batchlast`).

    With ``device="cpu"`` the same set runs the kernels' plain PyTorch
    versions.  Per-instance (3-D) A forms M per instance; f64 routes the
    factor to the reference set.  ``ozaki_bits`` / ``ozaki_mv_bits`` build
    the set's wide finish and crossover sets at those widths.
    """

    name = "hsd_pallas"
    aliases = ("clhsd", "pallas")
    kernels: KernelSet = BATCHLAST_KERNELS

    def _kernels_at(self, bits, mv_bits) -> KernelSet:
        return BatchLastKernels(ozaki_bits=bits, ozaki_mv_bits=mv_bits)
