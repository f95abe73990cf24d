"""Dense infeasible primal-dual path-following solver (batched).

Counterpart of :mod:`pycllp_tpu.solvers.dense_path`: the classic
Kojima–Megiddo–Mizuno / Mehrotra infeasible-start method WITHOUT the
homogeneous embedding — simpler per iteration, separate primal/dual step
lengths, but no infeasibility certificates (an infeasible or unbounded
instance runs to the iteration limit).  The HSD solver is the robust
default; this one is the cross-check.

Problem form: ``min cᵀx  s.t.  Ax = b, x ≥ 0`` with residuals
``r_p = b − Ax``, ``r_d = c − Aᵀy − z``, ``μ = xᵀz/n``.

As in the port's HSD core, the reference's ``lax.while_loop`` is a host
loop whose predicate ``k < maxiter and any(status == RUNNING)`` is read
back once per iteration, and f32 matmuls run with TF32 off (the
reference pins ``default_matmul_precision("highest")``).  The normal
equations go through the kernel set: with ``BATCHLAST_KERNELS`` and f32
the factor and solve are the hand-written ``chol_bl`` / ``solve_bl``.
"""

from __future__ import annotations

import torch

from pycllp_tpu_torch.ops.reference import KernelSet, REFERENCE_KERNELS
from pycllp_tpu_torch.solvers.base import BaseSolver, register_solver
from pycllp_tpu_torch.solvers.hsd import _full_precision_matmuls, _resolve_dtype, _to
from pycllp_tpu_torch.solvers.options import Solution, SolverOptions, Status
from pycllp_tpu_torch.utils.device import resolve_device
from pycllp_tpu_torch.utils.scaling import ruiz_equilibrate, scale_problem, unscale_solution

__all__ = ["dense_path_solve_batched", "DensePathSolver"]

_RUNNING = int(Status.RUNNING)
_OPTIMAL = int(Status.OPTIMAL)
_NUMERICAL = int(Status.NUMERICAL)
_ITERATION_LIMIT = int(Status.ITERATION_LIMIT)

_KEYS = ("x", "y", "z", "objective", "status", "iterations", "rho_p", "rho_d", "rho_gap")


def _ratio(v, dv):
    """Largest step to the boundary per lane, capped at the dtype's max
    where no component decreases (the reference's finfo-max cap)."""
    big = torch.finfo(v.dtype).max
    r = torch.where(dv < 0, v / torch.where(dv < 0, -dv, 1.0), big)
    return r.amin(dim=-1)


def dense_path_solve_batched(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    kset: KernelSet = REFERENCE_KERNELS,
    *,
    device="cuda",
):
    """Batched path-following solve; same output dict as ``hsd_solve_batched``
    (tensors on ``device``).  A CUDA request without a card raises."""
    dev = resolve_device(device)
    with _full_precision_matmuls():
        return _impl(A, b, c, opts, kset, dev)


def _impl(A, b, c, opts, kset, dev):
    dtype = _resolve_dtype(opts, A, b, c)
    A, b, c = _to(A, dtype, dev), _to(b, dtype, dev), _to(c, dtype, dev)
    B, m = b.shape
    n = c.shape[-1]
    if opts.scale:
        scaling = ruiz_equilibrate(A)
        A, b, c = scale_problem(A, b, c, scaling)
    else:
        scaling = None

    ctx = kset.prepare(A)
    reg_eps = opts.resolved_reg_eps(dtype)
    bnorm = 1.0 + torch.linalg.vector_norm(b, dim=-1)
    cnorm = 1.0 + torch.linalg.vector_norm(c, dim=-1)

    def classify(x, y, z):
        rp = b - kset.mv(ctx, x)
        rd = c - kset.rmv(ctx, y) - z
        cx = (c * x).sum(-1)
        gap = (cx - (b * y).sum(-1)).abs() / (1.0 + cx.abs())
        ok = (
            (torch.linalg.vector_norm(rp, dim=-1) / bnorm <= opts.tol)
            & (torch.linalg.vector_norm(rd, dim=-1) / cnorm <= opts.tol)
            & (gap <= opts.tol)
        )
        return rp, rd, gap, ok

    x = torch.ones((B, n), dtype=dtype, device=dev)
    y = torch.zeros((B, m), dtype=dtype, device=dev)
    z = torch.ones((B, n), dtype=dtype, device=dev)
    status = torch.full((B,), _RUNNING, dtype=torch.int32, device=dev)
    iterations = torch.zeros((B,), dtype=torch.int32, device=dev)
    k = 0
    while k < opts.maxiter and bool((status == _RUNNING).any()):
        rp, rd, gap, ok = classify(x, y, z)
        status = torch.where((status == _RUNNING) & ok, _OPTIMAL, status)
        active = status == _RUNNING

        mu = (x * z).sum(-1) / n
        dinv = x / z
        fac = kset.factor(ctx, dinv, reg_eps)

        def newton(rxs):
            r1 = rd - rxs / x
            (dy,) = kset.solve(fac, (rp + kset.mv(ctx, dinv * r1),))
            dx = dinv * (kset.rmv(ctx, dy) - r1)
            dz = (rxs - z * dx) / x
            return dx, dy, dz

        if opts.mehrotra:
            dxa, dya, dza = newton(-x * z)
            ap = torch.clamp(_ratio(x, dxa), max=1.0)
            ad = torch.clamp(_ratio(z, dza), max=1.0)
            mu_aff = ((x + ap[..., None] * dxa) * (z + ad[..., None] * dza)).sum(-1) / n
            gamma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
            dx, dy, dz = newton((gamma * mu)[..., None] - x * z - dxa * dza)
        else:
            gamma = torch.full_like(mu, opts.gamma)
            dx, dy, dz = newton((gamma * mu)[..., None] - x * z)

        ap = torch.clamp(opts.alpha0 * _ratio(x, dx), max=1.0)
        ad = torch.clamp(opts.alpha0 * _ratio(z, dz), max=1.0)
        xn = x + ap[..., None] * dx
        yn = y + ad[..., None] * dy
        zn = z + ad[..., None] * dz

        finite = (
            torch.isfinite(xn).all(dim=-1)
            & torch.isfinite(yn).all(dim=-1)
            & torch.isfinite(zn).all(dim=-1)
        )
        status = torch.where(active & ~finite, _NUMERICAL, status)
        take = active & finite
        tn = take[..., None]
        x = torch.where(tn, xn, x)
        y = torch.where(tn, yn, y)
        z = torch.where(tn, zn, z)
        iterations = torch.where(take, iterations + 1, iterations)
        k += 1

    rp, rd, gap, ok = classify(x, y, z)
    status = torch.where((status == _RUNNING) & ok, _OPTIMAL, status)
    status = torch.where(status == _RUNNING, _ITERATION_LIMIT, status)
    objective = (c * x).sum(-1)  # scaled-c·scaled-x == c·x, as the reference takes it
    if scaling is not None:
        x, y, z = unscale_solution(x, y, z, scaling)
    return {
        "x": x,
        "y": y,
        "z": z,
        "tau": torch.ones((B,), dtype=dtype, device=dev),
        "kappa": torch.zeros((B,), dtype=dtype, device=dev),
        "objective": objective,
        "status": status,
        "iterations": iterations,
        "rho_p": torch.linalg.vector_norm(rp, dim=-1) / bnorm,
        "rho_d": torch.linalg.vector_norm(rd, dim=-1) / cnorm,
        "rho_gap": gap,
    }


@register_solver
class DensePathSolver(BaseSolver):
    """Batched dense path-following backend (registry: ``dense_path``).

    ``device``: ``"cuda"`` (default) or ``"cpu"``; checked here, so a CUDA
    request without a card fails at construction.
    """

    name = "dense_path"
    aliases = ("dense",)
    kernels: KernelSet = REFERENCE_KERNELS

    def __init__(self, options=None, *, device="cuda", **opt_kwargs):
        super().__init__(options, **opt_kwargs)
        self.device = resolve_device(device)

    def _solve_impl(self, A, b, c) -> Solution:
        out = dense_path_solve_batched(A, b, c, self.options, self.kernels, device=self.device)
        return Solution(**{k: out[k].cpu().numpy() for k in _KEYS})
