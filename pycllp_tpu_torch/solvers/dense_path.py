"""Dense infeasible primal-dual path-following solver (batched).

Counterpart of :mod:`pycllp_tpu.solvers.dense_path`: the classic
Kojima–Megiddo–Mizuno / Mehrotra infeasible-start method WITHOUT the
homogeneous embedding — simpler per iteration, separate primal/dual step
lengths, but no infeasibility certificates (an infeasible or unbounded
instance runs to the iteration limit).  The HSD solver is the robust
default; this one is the cross-check.

Problem form: ``min cᵀx  s.t.  Ax = b, x ≥ 0`` with residuals
``r_p = b − Ax``, ``r_d = c − Aᵀy − z``, ``μ = xᵀz/n``.

As in the port's HSD core, the reference's ``lax.while_loop`` over its
``PFState`` carry runs as blocks of gated iterations whose predicate
``k < maxiter and any(status == RUNNING)`` stays on the device
(:func:`pycllp_tpu_torch.solvers._loop._device_while`: ``_loop.BLOCK``
iterations a block on shared A, ``_loop.BLOCK_PER_INSTANCE`` on
per-instance A), each block a replayed CUDA graph on the card; the
prologue (scaling, ``prepare``, the norms, the start) and the epilogue
(the last classification, unscaling) are segments.  A collective
``reduce_any`` keeps the host loop that reads the predicate every
iteration, as do the private switches of
:mod:`pycllp_tpu_torch.solvers.hsd` (``_HOST_LOOP``; ``_EAGER_SEGMENTS``
runs the segments eagerly).  f32 matmuls run with TF32 off (the
reference pins ``default_matmul_precision("highest")``).  The normal
equations go through the kernel set: with ``BATCHLAST_KERNELS`` and f32
the factor and solve are the hand-written ``chol_bl`` / ``solve_bl``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pycllp_tpu_torch.ops.reference import KernelSet, REFERENCE_KERNELS
from pycllp_tpu_torch.solvers import _loop
from pycllp_tpu_torch.solvers import hsd as _hsd
from pycllp_tpu_torch.solvers.base import BaseSolver, register_solver
from pycllp_tpu_torch.solvers.options import Solution, SolverOptions, Status
from pycllp_tpu_torch.utils.device import resolve_device
from pycllp_tpu_torch.utils.scaling import ruiz_equilibrate, scale_problem, unscale_solution

__all__ = ["dense_path_solve_batched", "DensePathSolver"]

_RUNNING = int(Status.RUNNING)
_OPTIMAL = int(Status.OPTIMAL)
_NUMERICAL = int(Status.NUMERICAL)
_ITERATION_LIMIT = int(Status.ITERATION_LIMIT)

_KEYS = ("x", "y", "z", "objective", "status", "iterations", "rho_p", "rho_d", "rho_gap")


class PFState(NamedTuple):
    x: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m)
    z: torch.Tensor  # (B, n)
    status: torch.Tensor  # (B,) int32
    iterations: torch.Tensor  # (B,) int32
    k: torch.Tensor  # () int32 — the loop counter, on the state's device


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
    reduce_any=torch.any,
    *,
    device="cuda",
):
    """Batched path-following solve; same output dict as ``hsd_solve_batched``
    (tensors on ``device``).  A CUDA request without a card raises.
    ``reduce_any`` reduces the loop predicate's RUNNING mask, as in
    ``hsd_solve_batched`` (``torch.any`` or None: locally)."""
    dev = resolve_device(device)
    with _hsd._full_precision_matmuls():
        return _impl(A, b, c, opts, kset, dev, reduce_any)


def _impl(A, b, c, opts, kset, dev, reduce_any):
    dtype = _hsd._resolve_dtype(opts, A, b, c)
    params = dict(opts=opts, kset=kset, dtype=dtype)
    inputs = tuple(_hsd._on(v, dev) for v in (A, b, c))
    state, data, scaling = _hsd._seg(_seg_start, inputs, (), borrow=True, **params)
    local = reduce_any is None or reduce_any is torch.any
    if not local or _hsd._HOST_LOOP:
        body = _make_body(data, opts, kset, dtype)
        s, k = state, 0
        while k < opts.maxiter:
            _loop.HOST_SYNCS += 1
            if not _hsd._any_running(s.status, reduce_any):
                break
            s = body(s)
            k += 1
        _hsd.HOST_STEPS += k
    else:
        limit = torch.full((), opts.maxiter, dtype=torch.int32, device=dev)
        block = _loop.BLOCK if data[0].A.dim() == 2 else _loop.BLOCK_PER_INSTANCE
        s, steps = _loop._device_while(
            _cond, lambda d: _make_body(d, opts, kset, dtype), state, data, limit, block,
            key=("dense_path", opts, kset, dtype),
        )
        _hsd.HOST_STEPS += steps
    return _hsd._seg(_seg_end, (s, scaling), data, **params)


def _cond(s: PFState, maxiter):
    """The reference's loop predicate, reduced locally, on the device."""
    return (s.k < maxiter) & (s.status == _RUNNING).any()


def _seg_start(state, data, *, opts, kset, dtype):
    """The prologue, from ``state = (A, b, c)`` on the device in their own
    dtypes: the starting :class:`PFState`, the loop's data ``(ctx, b, c,
    bnorm, cnorm)`` (scaled) and the scaling."""
    A, b, c = (v.to(dtype) for v in state)
    B, m = b.shape
    n = c.shape[-1]
    if opts.scale:
        scaling = ruiz_equilibrate(A)
        A, b, c = scale_problem(A, b, c, scaling)
    else:
        scaling = None
    ctx = kset.prepare(A)
    bnorm = 1.0 + torch.linalg.vector_norm(b, dim=-1)
    cnorm = 1.0 + torch.linalg.vector_norm(c, dim=-1)
    dev = b.device
    s = PFState(
        x=torch.ones((B, n), dtype=dtype, device=dev),
        y=torch.zeros((B, m), dtype=dtype, device=dev),
        z=torch.ones((B, n), dtype=dtype, device=dev),
        status=torch.full((B,), _RUNNING, dtype=torch.int32, device=dev),
        iterations=torch.zeros((B,), dtype=torch.int32, device=dev),
        k=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return s, (ctx, b, c, bnorm, cnorm), scaling


def _classify(data, kset, tol, x, y, z):
    ctx, b, c, bnorm, cnorm = data
    rp = b - kset.mv(ctx, x)
    rd = c - kset.rmv(ctx, y) - z
    cx = (c * x).sum(-1)
    gap = (cx - (b * y).sum(-1)).abs() / (1.0 + cx.abs())
    ok = (
        (torch.linalg.vector_norm(rp, dim=-1) / bnorm <= tol)
        & (torch.linalg.vector_norm(rd, dim=-1) / cnorm <= tol)
        & (gap <= tol)
    )
    return rp, rd, gap, ok


def _make_body(data, opts, kset, dtype):
    """The reference's loop body over ``data``: classify, one Mehrotra (or
    fixed-γ) step on the lanes still RUNNING."""
    ctx, b, c, _, _ = data
    reg_eps = opts.resolved_reg_eps(dtype)
    n = c.shape[-1]

    def body(s: PFState) -> PFState:
        x, y, z = s.x, s.y, s.z
        rp, rd, gap, ok = _classify(data, kset, opts.tol, x, y, z)
        status = torch.where((s.status == _RUNNING) & ok, _OPTIMAL, s.status)
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
        return PFState(
            x=torch.where(tn, xn, x),
            y=torch.where(tn, yn, y),
            z=torch.where(tn, zn, z),
            status=status,
            iterations=torch.where(take, s.iterations + 1, s.iterations),
            k=s.k + 1,
        )

    return body


def _seg_end(state, data, *, opts, kset, dtype):
    """The epilogue: the last classification, OPTIMAL / ITERATION_LIMIT,
    the objective and the unscaled point, as the output dict."""
    s, scaling = state
    _, b, c, bnorm, cnorm = data
    rp, rd, gap, ok = _classify(data, kset, opts.tol, s.x, s.y, s.z)
    status = torch.where((s.status == _RUNNING) & ok, _OPTIMAL, s.status)
    status = torch.where(status == _RUNNING, _ITERATION_LIMIT, status)
    x, y, z = s.x, s.y, s.z
    objective = (c * x).sum(-1)  # scaled-c·scaled-x == c·x, as the reference takes it
    if scaling is not None:
        x, y, z = unscale_solution(x, y, z, scaling)
    B = b.shape[0]
    return {
        "x": x,
        "y": y,
        "z": z,
        "tau": torch.ones((B,), dtype=dtype, device=b.device),
        "kappa": torch.zeros((B,), dtype=dtype, device=b.device),
        "objective": objective,
        "status": status,
        "iterations": s.iterations,
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
