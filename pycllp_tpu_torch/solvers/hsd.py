"""Homogeneous self-dual interior-point core (batched), narrow + wide finish.

Counterpart of :mod:`pycllp_tpu.solvers.hsd`, ported function by
function with the same names.  Algorithm: the homogeneous self-dual
embedding with Mehrotra predictor-corrector, KKT-level refinement,
Gondzio correctors, per-lane best-iterate tracking and a stall cutoff;
with ``finish_dtype`` set, a wide f64 finish (vertex crossover or a wide
IPM continuation) polishes every lane to the full ``tol``.

What differs from the reference, and why:

* ``lax.while_loop`` becomes a host loop whose predicate
  ``(k < maxiter) & any(status == RUNNING)`` syncs once per iteration;
  ``lax.scan`` over chunks becomes a Python loop over chunks, and every
  ``lax.cond`` a Python branch on a value read back from the device.
  The loop counter ``k`` is a Python int.  ``maxiter`` stays absolute in
  ``k``, and a compacted bucket resumes at ``k = cap``.
* The device is explicit (``device=``, default ``"cuda"``); no tensor
  moves to another device on its own.
* f32 matmuls run in full f32 (TF32 pinned off for the solve, the
  counterpart of the reference's ``default_matmul_precision("highest")``).
* The reference's environment knobs are arguments: ``truncate`` of
  :func:`_hsd_scan_finish_core` (``PYCLLP_FINISH_TRUNCATE``) and
  ``stage_sync`` of :func:`hsd_solve_scan` (``PYCLLP_SCAN_SYNC``).
* ``log_every`` records (:mod:`pycllp_tpu_torch.utils.logging`) are
  reduced on the device and read back only on the iterations that emit
  one, where the reference calls back from inside its loop.

Problem form: ``min cᵀx  s.t.  Ax = b, x ≥ 0`` (EqualityLP).  HSD
embedding variables: x ≥ 0, y free, z ≥ 0, τ ≥ 0, κ ≥ 0; residuals

    r_p = bτ − Ax,   r_d = cτ − Aᵀy − z,   r_g = cᵀx − bᵀy + κ,
    μ = (xᵀz + τκ)/(n+1).
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from pycllp_tpu_torch.ops.reference import KernelSet, REFERENCE_KERNELS
from pycllp_tpu_torch.solvers.options import SolverOptions, Status
from pycllp_tpu_torch.utils.device import resolve_device
from pycllp_tpu_torch.utils.logging import iteration_record
from pycllp_tpu_torch.utils.scaling import ruiz_equilibrate, scale_problem, unscale_solution

__all__ = ["HSDState", "hsd_solve_batched", "hsd_solve", "hsd_solve_scan"]

_RUNNING = int(Status.RUNNING)
_OPTIMAL = int(Status.OPTIMAL)
_ITERATION_LIMIT = int(Status.ITERATION_LIMIT)
_INFEASIBLE = int(Status.INFEASIBLE)
_UNBOUNDED = int(Status.UNBOUNDED)
_NUMERICAL = int(Status.NUMERICAL)
_STALLED = int(Status.STALLED)

# Host-loop iterations run by _run_phase, one per loop body.  Counted like
# the kernels' launch counters, so a caller can tie launches to iterations.
HOST_STEPS = 0

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class HSDState(NamedTuple):
    x: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m)
    z: torch.Tensor  # (B, n)
    tau: torch.Tensor  # (B,)
    kappa: torch.Tensor  # (B,)
    status: torch.Tensor  # (B,) int32
    iterations: torch.Tensor  # (B,) int32 — iterations spent while active
    k: int  # global loop counter (host int)
    rp0: torch.Tensor  # (B,) initial-residual norms for relative indicators
    rd0: torch.Tensor
    rg0: torch.Tensor
    mu0: torch.Tensor
    # best-iterate tracking (f32 insurance: keep the best point, not the last)
    best_x: torch.Tensor
    best_y: torch.Tensor
    best_z: torch.Tensor
    best_tau: torch.Tensor
    best_kappa: torch.Tensor
    best_score: torch.Tensor  # (B,) max(ρ_p, ρ_d, ρ_A) at the best iterate
    best_k: torch.Tensor  # (B,) int32 loop index of the best iterate


class _Indicators(NamedTuple):
    rho_p: torch.Tensor
    rho_d: torch.Tensor
    rho_g: torch.Tensor
    rho_mu: torch.Tensor
    rho_A: torch.Tensor
    by: torch.Tensor


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _residuals(ctx, b, c, x, y, z, tau, kappa, k):
    n_plus_1 = x.shape[-1] + 1
    rp = b * tau[..., None] - k.mv(ctx, x)
    rd = c * tau[..., None] - k.rmv(ctx, y) - z
    rg = (c * x).sum(-1) - (b * y).sum(-1) + kappa
    mu = ((x * z).sum(-1) + tau * kappa) / n_plus_1
    return rp, rd, rg, mu


def _indicators(rp, rd, rg, mu, tau, kappa, by, rp0, rd0, rg0, mu0) -> _Indicators:
    rho_p = _norm(rp) / rp0.clamp(min=1.0)
    rho_d = _norm(rd) / rd0.clamp(min=1.0)
    rho_g = rg.abs() / rg0.clamp(min=1.0)
    rho_mu = mu / mu0
    cx_minus_by = rg - kappa  # cᵀx − bᵀy
    # gap test normalized by max(τ, |bᵀy|): the de-embedded
    # |cᵀx/τ − bᵀy/τ| ≤ tol·max(1, |obj|), the quantity the audit checks
    tiny = torch.finfo(rp.dtype).tiny
    rho_A = cx_minus_by.abs() / torch.maximum(tau, by.abs()).clamp(min=tiny)
    return _Indicators(rho_p, rho_d, rho_g, rho_mu, rho_A, by)


def _classify(ind: _Indicators, tau, kappa, status, tol):
    """Per-lane termination test → new status vector."""
    optimal = (ind.rho_p <= tol) & (ind.rho_d <= tol) & (ind.rho_A <= tol)
    inf1 = (
        (ind.rho_p <= tol)
        & (ind.rho_d <= tol)
        & (ind.rho_g <= tol)
        & (tau <= tol * kappa.clamp(min=1.0))
    )
    inf2 = (ind.rho_mu <= tol) & (tau <= tol * kappa.clamp(max=1.0))
    infeasible = inf1 | inf2
    inf_status = torch.full_like(status, _UNBOUNDED).masked_fill_(ind.by > tol, _INFEASIBLE)
    running = status == _RUNNING
    return torch.where(
        running & optimal,
        _OPTIMAL,
        torch.where(running & infeasible, inf_status, status),
    )


def _max_step(x, dx, z, dz, tau, dtau, kappa, dkappa):
    """Largest α keeping (x, z, τ, κ) ≥ 0 along the direction (ratio test)."""
    big = torch.finfo(x.dtype).max

    def ratios(v, dv):
        neg = dv < 0
        return torch.where(neg, v / torch.where(neg, -dv, 1.0), big)

    a = torch.minimum(ratios(x, dx).amin(dim=-1), ratios(z, dz).amin(dim=-1))
    a = torch.minimum(a, ratios(tau, dtau))
    a = torch.minimum(a, ratios(kappa, dkappa))
    return a


def _make_step_fn(ctx, b, c, opts: SolverOptions, kset: KernelSet, dtype):
    """Build the per-iteration Newton step closure (batched over lanes).

    Solve schedule per iteration (one factorization, 2 + 1 RHS): stage 1
    jointly solves the τ-column system (p, q) and the predictor system;
    stage 2 solves the corrector; ``kkt_refine`` sweeps add one solve each.
    """
    reg_eps = opts.resolved_reg_eps(dtype)
    refine = opts.resolved_refine_steps(dtype)
    kkt_refine = opts.kkt_refine

    def step(x, y, z, tau, kappa, rp, rd, rg, mu):
        # "D" = X Z⁻¹, capped at 1e30 as in the reference: the late-IPM
        # spread of x/z can exceed 1e40, and the cap also shapes f64
        # trajectories, so parity with the reference needs it.
        dinv = torch.clamp(x / z, max=1e30)

        def refine_vs(fac, rs, vs):
            for _ in range(refine):
                es = tuple(r - kset.matvec_M(fac, v) for r, v in zip(rs, vs))
                cs = kset.solve(fac, es)
                vs = tuple(v + cv for v, cv in zip(vs, cs))
            return vs

        def sym_parts(r1, v):
            """Recover u = D(Aᵀv − r1) for a solved v."""
            return dinv * (kset.rmv(ctx, v) - r1)

        # ---- stage 1: τ-column (p, q) + predictor RHS, one joint solve ----
        t_pq = b + kset.mv(ctx, dinv * c)
        # predictor RHS (γ=0, η=1): rhs_d − rhs_xs/x = rd + z
        r1_pred = rd + z
        t_pred = rp + kset.mv(ctx, dinv * r1_pred)
        if opts.mehrotra:
            fac, vs = kset.factor_and_solve(ctx, dinv, reg_eps, (t_pq, t_pred))
            q, v_pred = refine_vs(fac, (t_pq, t_pred), vs)
        else:
            gamma0 = torch.full_like(tau, opts.gamma)
            eta0 = 1.0 - gamma0
            rxs0 = (gamma0 * mu)[..., None] - x * z
            r1_c = eta0[..., None] * rd - rxs0 / x
            t_c = eta0[..., None] * rp + kset.mv(ctx, dinv * r1_c)
            fac, vs = kset.factor_and_solve(ctx, dinv, reg_eps, (t_pq, t_c))
            q, v_c = refine_vs(fac, (t_pq, t_c), vs)

        def msolve(rs):
            return refine_vs(fac, rs, kset.solve(fac, rs))

        p = sym_parts(c, q)
        # denominator of the dτ formula: κ/τ + (bᵀq − cᵀp)
        denom = kappa / tau + (b * q).sum(-1) - (c * p).sum(-1)

        def assemble(v, r1, rhs_g, rhs_xs, rhs_tk):
            """Given the normal-equations solution v for a Newton RHS,
            recover the full direction (dx, dy, dz, dτ, dκ)."""
            u = sym_parts(r1, v)
            dtau = (rhs_g + rhs_tk / tau - ((b * v).sum(-1) - (c * u).sum(-1))) / denom
            dx = u + p * dtau[..., None]
            dy = v + q * dtau[..., None]
            dz = (rhs_xs - z * dx) / x
            dkappa = (rhs_tk - kappa * dtau) / tau
            return dx, dy, dz, dtau, dkappa

        def solve_newton(rhs_p, rhs_d, rhs_g, rhs_xs, rhs_tk):
            r1 = rhs_d - rhs_xs / x
            (v,) = msolve((rhs_p + kset.mv(ctx, dinv * r1),))
            return assemble(v, r1, rhs_g, rhs_xs, rhs_tk)

        def kkt_correct(d, rhs_p, rhs_d, rhs_g, rhs_xs, rhs_tk, sweeps=None):
            """Iterative refinement on the full 5-block Newton system."""
            for _ in range(kkt_refine if sweeps is None else sweeps):
                dx, dy, dz, dtau, dkappa = d
                e_p = rhs_p - (kset.mv(ctx, dx) - b * dtau[..., None])
                e_d = rhs_d - (kset.rmv(ctx, dy) + dz - c * dtau[..., None])
                e_g = rhs_g - ((b * dy).sum(-1) - (c * dx).sum(-1) - dkappa)
                e_xs = rhs_xs - (z * dx + x * dz)
                e_tk = rhs_tk - (kappa * dtau + tau * dkappa)
                corr = solve_newton(e_p, e_d, e_g, e_xs, e_tk)
                d = tuple(a + b_ for a, b_ in zip(d, corr))
            return d

        if opts.mehrotra:
            # predictor direction from the joint solve
            rxs_a = -x * z
            rtk_a = -tau * kappa
            da = assemble(v_pred, r1_pred, rg, rxs_a, rtk_a)
            # asymmetric refinement: the predictor only gauges μ_aff and
            # feeds the corrector's second-order products
            da = kkt_correct(da, rp, rd, rg, rxs_a, rtk_a,
                             sweeps=opts.resolved_kkt_refine_pred())
            dxa, dya, dza, dta, dka = da
            a_aff = torch.clamp(_max_step(x, dxa, z, dza, tau, dta, kappa, dka), max=1.0)
            aan = a_aff[..., None]
            mu_aff = (
                ((x + aan * dxa) * (z + aan * dza)).sum(-1)
                + (tau + a_aff * dta) * (kappa + a_aff * dka)
            ) / (x.shape[-1] + 1)
            gamma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
            # ---- stage 2: corrector ----
            eta = 1.0 - gamma
            rhs_p = eta[..., None] * rp
            rhs_d = eta[..., None] * rd
            rhs_g = eta * rg
            rhs_xs = (gamma * mu)[..., None] - x * z - dxa * dza
            rhs_tk = gamma * mu - tau * kappa - dta * dka
            d = solve_newton(rhs_p, rhs_d, rhs_g, rhs_xs, rhs_tk)
            d = kkt_correct(d, rhs_p, rhs_d, rhs_g, rhs_xs, rhs_tk)
            dx, dy, dz, dtau, dkappa = d

            # Gondzio multiple centrality correctors: push outlier
            # complementarity products toward [0.1, 10]·γμ with extra
            # solves through the SAME factorization; per-lane accept only
            # when the step length improves.
            for _ in range(opts.gondzio_correctors):
                alpha_c = torch.clamp(
                    opts.alpha0 * _max_step(x, dx, z, dz, tau, dtau, kappa, dkappa), max=1.0
                )
                a_hat = torch.clamp(1.5 * alpha_c + 0.1, max=1.0)
                ah = a_hat[..., None]
                v_t = (x + ah * dx) * (z + ah * dz)
                vtk = (tau + a_hat * dtau) * (kappa + a_hat * dkappa)
                mu_g = gamma * mu
                lo = (0.1 * mu_g)[..., None]
                hi = (10.0 * mu_g)[..., None]
                # correction only for products outside the box
                t_xs = torch.clamp(v_t, min=lo, max=hi) - v_t
                t_tk = torch.clamp(vtk, min=0.1 * mu_g, max=10.0 * mu_g) - vtk
                zero = torch.zeros_like(rg)
                dc = solve_newton(
                    torch.zeros_like(rp), torch.zeros_like(rd), zero, t_xs, t_tk
                )
                cand = tuple(a + b_ for a, b_ in zip(d, dc))
                alpha_new = torch.clamp(
                    opts.alpha0 * _max_step(x, cand[0], z, cand[2], tau, cand[3], kappa, cand[4]),
                    max=1.0,
                )
                accept = alpha_new > alpha_c + 1e-4
                an_ = accept[..., None]
                d = tuple(
                    torch.where(an_ if dv.dim() == 2 else accept, cv, dv)
                    for dv, cv in zip(d, cand)
                )
                dx, dy, dz, dtau, dkappa = d
        else:
            rhs_g0 = eta0 * rg
            rtk0 = gamma0 * mu - tau * kappa
            d = assemble(v_c, r1_c, rhs_g0, rxs0, rtk0)
            d = kkt_correct(d, eta0[..., None] * rp, eta0[..., None] * rd, rhs_g0, rxs0, rtk0)
            dx, dy, dz, dtau, dkappa = d

        alpha = torch.clamp(
            opts.alpha0 * _max_step(x, dx, z, dz, tau, dtau, kappa, dkappa), max=1.0
        )
        an = alpha[..., None]
        return (
            x + an * dx,
            y + an * dy,
            z + an * dz,
            tau + alpha * dtau,
            kappa + alpha * dkappa,
        )

    return step


def _any_running(status, reduce_any) -> bool:
    """The loop predicate's lane test: ``any(status == RUNNING)``, reduced
    by ``reduce_any`` (a mask -> bool callable; the sharded solve passes
    a collective one) or locally when it is None."""
    mask = status == _RUNNING
    return bool(mask.any()) if reduce_any is None else bool(reduce_any(mask))


def _run_phase(
    ctx, b, c, state: HSDState, opts: SolverOptions, kset: KernelSet,
    dtype, tol: float, maxiter: int, reduce_any=None,
) -> HSDState:
    """Run the masked IPM loop until all lanes finish or ``k == maxiter``.

    The reference's ``lax.while_loop`` as a host loop: the predicate is
    read back from the device once per iteration.  ``k < maxiter`` is
    tested first, so ``reduce_any`` (a collective) runs on every rank at
    the same ``k``.
    """
    global HOST_STEPS
    step = _make_step_fn(ctx, b, c, opts, kset, dtype)
    patience = opts.stall_patience

    def body(s: HSDState) -> HSDState:
        rp, rd, rg, mu = _residuals(ctx, b, c, s.x, s.y, s.z, s.tau, s.kappa, kset)
        by = (b * s.y).sum(-1)
        ind = _indicators(rp, rd, rg, mu, s.tau, s.kappa, by, s.rp0, s.rd0, s.rg0, s.mu0)
        status = _classify(ind, s.tau, s.kappa, s.status, tol)
        running = status == _RUNNING

        # best-iterate bookkeeping (finite scores only)
        score = torch.maximum(torch.maximum(ind.rho_p, ind.rho_d), ind.rho_A)
        was_running = (s.status == _RUNNING) & torch.isfinite(score)
        improved = was_running & (score < s.best_score)
        imn = improved[..., None]
        best_x = torch.where(imn, s.x, s.best_x)
        best_y = torch.where(imn, s.y, s.best_y)
        best_z = torch.where(imn, s.z, s.best_z)
        best_tau = torch.where(improved, s.tau, s.best_tau)
        best_kappa = torch.where(improved, s.kappa, s.best_kappa)
        best_score = torch.where(improved, score, s.best_score)
        # the stall clock only resets on MATERIAL progress (opts.stall_rtol
        # relative drop); with the default 0.0 this equals `improved`
        if opts.stall_rtol:
            material = was_running & (score < s.best_score * (1.0 - opts.stall_rtol))
        else:
            material = improved
        best_k = torch.where(material, s.k, s.best_k)

        # stall cutoff: no best-score progress for `patience` iterations →
        # stop spending FLOPs on this lane (its best iterate is kept)
        stalled = running & (s.k - best_k >= patience)
        status = torch.where(stalled, _STALLED, status)
        active = status == _RUNNING

        if opts.log_every and s.k % opts.log_every == 0:
            _log_iteration(s, ind, mu, active)

        xn, yn, zn, taun, kappan = step(s.x, s.y, s.z, s.tau, s.kappa, rp, rd, rg, mu)

        # numerical guard: a lane whose step went non-finite keeps its old
        # iterate and is flagged NUMERICAL (the f32 breakdown path).
        finite = (
            torch.isfinite(xn).all(dim=-1)
            & torch.isfinite(yn).all(dim=-1)
            & torch.isfinite(zn).all(dim=-1)
            & torch.isfinite(taun)
            & torch.isfinite(kappan)
            & (taun > 0)
            & (kappan >= 0)
        )
        status = torch.where(active & ~finite, _NUMERICAL, status)
        take = active & finite

        tn = take[..., None]
        return HSDState(
            x=torch.where(tn, xn, s.x),
            y=torch.where(tn, yn, s.y),
            z=torch.where(tn, zn, s.z),
            tau=torch.where(take, taun, s.tau),
            kappa=torch.where(take, kappan, s.kappa),
            status=status,
            iterations=torch.where(take, s.iterations + 1, s.iterations),
            k=s.k + 1,
            rp0=s.rp0,
            rd0=s.rd0,
            rg0=s.rg0,
            mu0=s.mu0,
            best_x=best_x,
            best_y=best_y,
            best_z=best_z,
            best_tau=best_tau,
            best_kappa=best_kappa,
            best_score=best_score,
            best_k=best_k,
        )

    s = state
    while s.k < maxiter and _any_running(s.status, reduce_any):
        s = body(s)
        HOST_STEPS += 1
    return s


def _log_iteration(s: HSDState, ind: _Indicators, mu, active) -> None:
    """Emit the reference's per-iteration record: the phase (dtype name),
    k, the active-lane count, the max ρ_p / ρ_d / ρ_gap over the active
    lanes and their mean μ."""
    nact = active.sum()

    def mx(v):
        return torch.where(active, v, 0.0).amax()

    iteration_record(
        str(s.x.dtype).removeprefix("torch."), s.k, nact,
        mx(ind.rho_p), mx(ind.rho_d), mx(ind.rho_g),
        torch.where(active, mu, 0.0).sum() / nact.clamp(min=1),
    )


def _run_narrow_phase(
    ctx, b, c, state: HSDState, opts: SolverOptions, kset: KernelSet,
    dtype, tol: float, maxiter: int, reduce_any=None,
) -> HSDState:
    """Narrow IPM phase with the ``kkt_warmup`` refine schedule: the first
    ``kkt_warmup`` iterations run with ``kkt_refine=0``, then the loop
    continues refined (two sequential loops over the same state; caps
    are absolute in ``k``, so resumed states skip the warmup)."""
    w = opts.kkt_warmup
    if opts.kkt_refine and w:
        state = _run_phase(
            ctx, b, c, state, opts.replace(kkt_refine=0), kset, dtype, tol,
            min(w, maxiter), reduce_any,
        )
    return _run_phase(ctx, b, c, state, opts, kset, dtype, tol, maxiter, reduce_any)


def _finalize(ctx, b, c, s: HSDState, kset: KernelSet, tol):
    """Fold the current iterate into `best`, classify on the best iterate."""
    rp, rd, rg, mu = _residuals(ctx, b, c, s.x, s.y, s.z, s.tau, s.kappa, kset)
    by = (b * s.y).sum(-1)
    ind = _indicators(rp, rd, rg, mu, s.tau, s.kappa, by, s.rp0, s.rd0, s.rg0, s.mu0)
    score = torch.maximum(torch.maximum(ind.rho_p, ind.rho_d), ind.rho_A)
    improved = (s.status == _RUNNING) & torch.isfinite(score) & (score < s.best_score)
    imn = improved[..., None]
    s = s._replace(
        best_x=torch.where(imn, s.x, s.best_x),
        best_y=torch.where(imn, s.y, s.best_y),
        best_z=torch.where(imn, s.z, s.best_z),
        best_tau=torch.where(improved, s.tau, s.best_tau),
        best_kappa=torch.where(improved, s.kappa, s.best_kappa),
        best_score=torch.where(improved, score, s.best_score),
    )
    # non-terminated lanes answer with their best iterate — including
    # NUMERICAL ones (the tracker only ever accepts finite scores)
    stalled = s.status == _STALLED
    numerical = s.status == _NUMERICAL
    use_best = (s.status == _RUNNING) | stalled | numerical
    ubn = use_best[..., None]
    x = torch.where(ubn, s.best_x, s.x)
    y = torch.where(ubn, s.best_y, s.y)
    z = torch.where(ubn, s.best_z, s.z)
    tau = torch.where(use_best, s.best_tau, s.tau)
    kappa = torch.where(use_best, s.best_kappa, s.kappa)

    rp, rd, rg, mu = _residuals(ctx, b, c, x, y, z, tau, kappa, kset)
    by = (b * y).sum(-1)
    ind = _indicators(rp, rd, rg, mu, tau, kappa, by, s.rp0, s.rd0, s.rg0, s.mu0)
    # STALLED/NUMERICAL lanes are re-opened for this final test: if the
    # best iterate meets tol after all, they are OPTIMAL.
    status_open = torch.where(stalled | numerical, _RUNNING, s.status)
    status = _classify(ind, tau, kappa, status_open, tol)
    still_open = torch.full_like(status, _ITERATION_LIMIT)
    still_open = torch.where(numerical, _NUMERICAL, still_open)
    still_open = torch.where(stalled, _STALLED, still_open)
    status = torch.where(status == _RUNNING, still_open, status)
    return x, y, z, tau, kappa, status, ind


def _fold_to_best(ctx, b, c, s: HSDState, kset: KernelSet, only=None) -> HSDState:
    """Replace each lane's CURRENT iterate with its tracked best where the
    best scores strictly better (both re-scored in the current dtype)."""
    def score_of(x, y, z, tau, kappa):
        rp, rd, rg, mu = _residuals(ctx, b, c, x, y, z, tau, kappa, kset)
        by = (b * y).sum(-1)
        ind = _indicators(rp, rd, rg, mu, tau, kappa, by, s.rp0, s.rd0, s.rg0, s.mu0)
        return torch.maximum(torch.maximum(ind.rho_p, ind.rho_d), ind.rho_A)

    score = score_of(s.x, s.y, s.z, s.tau, s.kappa)
    score_b = score_of(s.best_x, s.best_y, s.best_z, s.best_tau, s.best_kappa)
    use_best = ~torch.isfinite(score) | (torch.isfinite(score_b) & (score_b < score))
    if only is not None:
        use_best = use_best & only  # restrict the fold to these lanes
    ubn = use_best[..., None]
    return s._replace(
        x=torch.where(ubn, s.best_x, s.x),
        y=torch.where(ubn, s.best_y, s.y),
        z=torch.where(ubn, s.best_z, s.z),
        tau=torch.where(use_best, s.best_tau, s.tau),
        kappa=torch.where(use_best, s.best_kappa, s.kappa),
    )


def _crossover_kset(kset: KernelSet, fkset: KernelSet, opts: SolverOptions):
    """Kernel set for the crossover basis solves (``opts.crossover_kset``):
    "wide" → the finish set itself; otherwise resolved through the BASE
    set's ``finish_kernels`` selector (e.g. "mixed1")."""
    if opts.crossover_kset in (None, "wide"):
        return fkset
    return kset.finish_kernels(opts.crossover_kset)


def _crossover_state(
    fctx, b, c, state: HSDState, fkset: KernelSet, opts: SolverOptions, tol,
    reopen: bool = True,
) -> HSDState:
    """Apply the vertex crossover (solvers/crossover.py) to a wide state.

    Every lane not already proven INFEASIBLE/UNBOUNDED gets a candidate;
    a lane is accepted when the candidate passes BOTH the sign/residual
    verification and the ρ-indicator optimality test at full ``tol`` —
    accepted lanes become OPTIMAL with the vertex as their iterate
    (τ = 1, κ = 0).  With ``reopen``, rejected lanes become RUNNING for a
    wide IPM continuation; a final (rescue) crossover passes
    ``reopen=False`` so reject statuses (STALLED in particular, which the
    restart logic keys on) are left untouched.
    """
    from pycllp_tpu_torch.solvers.crossover import crossover_candidate

    tau_safe = state.tau.clamp(min=torch.finfo(state.x.dtype).tiny)[..., None]
    xv, yv, zv, ok, rp, rd = crossover_candidate(
        fctx, b, c, state.x / tau_safe, state.z / tau_safe, fkset,
        refine=opts.crossover_refine,
        feas_tol=opts.crossover_feas_tol,
        repair=opts.crossover_repair,
    )
    tau1 = torch.ones_like(state.tau)
    kap0 = torch.zeros_like(state.kappa)
    # ρ test from the residuals the verification already computed (rd is
    # the z-clamp residue); the gap/μ quantities are cheap dots
    rg = (c * xv).sum(-1) - (b * yv).sum(-1) + kap0
    mu = ((xv * zv).sum(-1) + tau1 * kap0) / (xv.shape[-1] + 1)
    by = (b * yv).sum(-1)
    ind = _indicators(rp, rd, rg, mu, tau1, kap0, by, state.rp0, state.rd0, state.rg0, state.mu0)
    opt = (ind.rho_p <= tol) & (ind.rho_d <= tol) & (ind.rho_A <= tol)
    eligible = (state.status != _INFEASIBLE) & (state.status != _UNBOUNDED)
    accept = eligible & ok & opt
    an = accept[..., None]
    status = torch.where(eligible & reopen, _RUNNING, state.status)
    return state._replace(
        x=torch.where(an, xv, state.x),
        y=torch.where(an, yv, state.y),
        z=torch.where(an, zv, state.z),
        tau=torch.where(accept, tau1, state.tau),
        kappa=torch.where(accept, kap0, state.kappa),
        status=torch.where(accept, _OPTIMAL, status),
    )


def _restart_merge(state: HSDState, fresh: HSDState, retry) -> HSDState:
    """Merge a fresh start into ``state`` for the ``retry`` lanes.

    Retry lanes take the fresh iterates and normalizers but KEEP their
    old best trackers (a failed restart can never answer worse than the
    old best); the loop clock restarts at 0 for every lane.
    """
    rn = retry[..., None]
    return HSDState(
        x=torch.where(rn, fresh.x, state.x),
        y=torch.where(rn, fresh.y, state.y),
        z=torch.where(rn, fresh.z, state.z),
        tau=torch.where(retry, fresh.tau, state.tau),
        kappa=torch.where(retry, fresh.kappa, state.kappa),
        status=torch.where(retry, _RUNNING, state.status),
        iterations=state.iterations,
        k=0,
        rp0=torch.where(retry, fresh.rp0, state.rp0),
        rd0=torch.where(retry, fresh.rd0, state.rd0),
        rg0=torch.where(retry, fresh.rg0, state.rg0),
        mu0=torch.where(retry, fresh.mu0, state.mu0),
        best_x=state.best_x,
        best_y=state.best_y,
        best_z=state.best_z,
        best_tau=state.best_tau,
        best_kappa=state.best_kappa,
        best_score=state.best_score,
        best_k=torch.zeros_like(state.best_k),
    )


# stall_patience for restart phases: a restarted lane keeps its OLD best
# trackers, so the stall clock's baseline is the old best_score, which a
# cold start cannot beat until it has ~converged.  Restart phases are
# budget-capped already, so the cutoff buys nothing there: disable it.
_NO_STALL = 1 << 30


def _retry_mask(status):
    return (status == _RUNNING) | (status == _STALLED) | (status == _NUMERICAL)


def _take(state: HSDState, idx) -> HSDState:
    """Gather the lanes ``idx`` of every per-lane field (``k`` is shared)."""
    return HSDState(*[v if f == "k" else v[idx] for f, v in zip(HSDState._fields, state)])


def _scatter(state: HSDState, sub: HSDState, idx, resumed) -> HSDState:
    """Write ``sub``'s lanes back over ``state[idx]`` where ``resumed``;
    the shared loop counter merges by ``max``.  Out of place, as the
    reference's ``v.at[idx].set(...)``."""
    merged = {}
    for name, v in state._asdict().items():
        v2 = getattr(sub, name)
        if name == "k":
            merged[name] = max(v, v2)
            continue
        mask = resumed.reshape(resumed.shape + (1,) * (v2.dim() - 1))
        out = v.clone()
        out[idx] = torch.where(mask, v2, v[idx])
        merged[name] = out
    return HSDState(**merged)


def _first_lanes(mask, width: int):
    """Indices of up to ``width`` lanes, ``mask`` lanes first, in lane
    order (``stable=True``: torch's default sort is not stable, and the
    reference's argsort is)."""
    return torch.argsort((~mask).to(torch.int8), stable=True)[:width]


def _mehrotra_start(ctx, b, c, kset: KernelSet, reg_eps):
    """Mehrotra's least-squares starting point, HSD-adapted.

    x̂ = Aᵀ(AAᵀ)⁻¹b (min-norm primal), ŷ = (AAᵀ)⁻¹Ac, ẑ = c − Aᵀŷ,
    then the positivity shifts from Mehrotra (1992): one extra
    factorization (D = I) per solve.
    """
    ones_d = torch.ones_like(c)
    fac0, (vb, vc) = kset.factor_and_solve(
        ctx, ones_d, reg_eps, (b, kset.mv(ctx, c))
    )
    x_hat = kset.rmv(ctx, vb)
    y_hat = vc
    z_hat = c - kset.rmv(ctx, y_hat)
    dx = (-1.5 * x_hat.amin(dim=-1)).clamp(min=0.0)[..., None]
    dz = (-1.5 * z_hat.amin(dim=-1)).clamp(min=0.0)[..., None]
    xs = x_hat + dx
    zs = z_hat + dz
    dot = (xs * zs).sum(-1)
    # guard degenerate all-zero cases with a unit fallback
    sum_z = zs.sum(-1).clamp(min=1e-8)
    sum_x = xs.sum(-1).clamp(min=1e-8)
    x0 = xs + (0.5 * dot / sum_z)[..., None]
    z0 = zs + (0.5 * dot / sum_x)[..., None]
    # keep strictly interior even for pathological data
    x0 = x0.clamp(min=1e-4)
    z0 = z0.clamp(min=1e-4)
    return x0, y_hat, z0


def _cast_state(s: HSDState, dtype) -> HSDState:
    def cast(v):
        return v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v

    return HSDState(*[cast(v) for v in s])


def _fresh_state(
    ctx, b_s, c_s, opts: SolverOptions, kset: KernelSet, dtype, warm=None
) -> HSDState:
    """Initial HSD state (blind, Mehrotra least-squares, or warm start).

    ``warm`` is an optional (x, y, z) triple in SCALED equality
    coordinates.  It is interiorized: blended ``warm_lambda`` of the way
    toward the blind start and floored strictly positive; κ is set to the
    point's own average complementarity.  The indicator normalizers come
    from the BLIND start, so a warm solve faces the same criterion as a
    cold ``init_point='ones'`` solve.
    """
    B, m = b_s.shape
    n = c_s.shape[-1]
    dev = b_s.device
    big = torch.finfo(dtype).max

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=dev)

    if warm is not None:
        lam = opts.warm_lambda
        xw, yw, zw = (torch.as_tensor(v, dtype=dtype, device=dev) for v in warm)
        x0 = ((1.0 - lam) * xw + lam).clamp(min=1e-4)
        z0 = ((1.0 - lam) * zw + lam).clamp(min=1e-4)
        y0 = (1.0 - lam) * yw
        tau0 = full((B,), 1.0)
        kappa0 = (x0 * z0).sum(-1) / n
        ones_x = full((B, n), 1.0)
        rp_b, rd_b, rg_b, mu_b = _residuals(
            ctx, b_s, c_s, ones_x, full((B, m), 0.0), ones_x,
            full((B,), 1.0), full((B,), 1.0), kset,
        )
        return HSDState(
            x=x0, y=y0, z=z0, tau=tau0, kappa=kappa0,
            status=full((B,), _RUNNING, torch.int32),
            iterations=full((B,), 0, torch.int32),
            k=0,
            rp0=_norm(rp_b), rd0=_norm(rd_b), rg0=rg_b.abs(), mu0=mu_b,
            best_x=x0, best_y=y0, best_z=z0, best_tau=tau0, best_kappa=kappa0,
            best_score=full((B,), big),
            best_k=full((B,), 0, torch.int32),
        )
    if opts.init_point == "mehrotra":
        x0, y0, z0 = _mehrotra_start(ctx, b_s, c_s, kset, opts.resolved_reg_eps(dtype))
    else:
        x0 = full((B, n), 1.0)
        y0 = full((B, m), 0.0)
        z0 = full((B, n), 1.0)
    tau0 = full((B,), 1.0)
    kappa0 = full((B,), 1.0)
    rp, rd, rg, mu = _residuals(ctx, b_s, c_s, x0, y0, z0, tau0, kappa0, kset)
    return HSDState(
        x=x0,
        y=y0,
        z=z0,
        tau=tau0,
        kappa=kappa0,
        status=full((B,), _RUNNING, torch.int32),
        iterations=full((B,), 0, torch.int32),
        k=0,
        rp0=_norm(rp),
        rd0=_norm(rd),
        rg0=rg.abs(),
        mu0=mu,
        best_x=x0,
        best_y=y0,
        best_z=z0,
        best_tau=tau0,
        best_kappa=kappa0,
        best_score=full((B,), big),
        best_k=full((B,), 0, torch.int32),
    )


def _package(ctx, b_s, c_s, state: HSDState, kset: KernelSet, opts: SolverOptions, scaling, c_orig):
    """Finalize + unscale a terminal state into the public output dict.

    ``c_orig`` is the UNSCALED objective vector batch (original data) used
    for the reported objective value.
    """
    x, y, z, tau, kappa, status, ind = _finalize(ctx, b_s, c_s, state, kset, opts.tol)
    out = _unscaled_outputs(x, y, z, tau, kappa, status, state.iterations, scaling, c_orig)
    out.update(rho_p=ind.rho_p, rho_d=ind.rho_d, rho_gap=ind.rho_g)
    return out


def _unscaled_outputs(x, y, z, tau, kappa, status, iterations, scaling, c_orig):
    """De-embed (÷τ) and unscale a terminal iterate into the output dict."""
    out_dtype = x.dtype
    tau_safe = tau.clamp(min=torch.finfo(out_dtype).tiny)
    inv_tau = (1.0 / tau_safe)[..., None]
    x_hat = x * inv_tau
    y_hat = y * inv_tau
    z_hat = z * inv_tau
    if scaling is not None:
        sc = type(scaling)(*[v.to(out_dtype) for v in scaling])
        x_hat, y_hat, z_hat = unscale_solution(x_hat, y_hat, z_hat, sc)
    objective = (c_orig.to(out_dtype) * x_hat).sum(-1)
    return {
        "x": x_hat,
        "y": y_hat,
        "z": z_hat,
        "tau": tau,
        "kappa": kappa,
        "objective": objective,
        "status": status,
        "iterations": iterations,
    }


def _package_bucketed(
    ctx, b_s, c_s, state: HSDState, kset: KernelSet, opts: SolverOptions,
    scaling, c_orig, bucket: int
):
    """:func:`_package` with the finalize/classify pass confined to a
    gathered bucket of the NON-TERMINAL lanes.

    Terminal lanes (OPTIMAL / INFEASIBLE / UNBOUNDED) pass through
    untouched and only the gathered remainder runs ``_finalize``
    (best-iterate fold + last-chance classification).  Non-terminal lanes
    beyond ``bucket`` keep their iterate; still-RUNNING ones are flagged
    ITERATION_LIMIT.  When they overflow the bucket, a full-width
    best-iterate fold over the non-terminal lanes runs first, so an
    overflow lane answers with its best iterate; beyond-bucket
    STALLED/NUMERICAL lanes still skip the last-chance reclassification —
    the reference's remaining (status-only) divergence from
    :func:`_package`, reproduced.  The ρ diagnostics are not computed.
    """
    terminal = (
        (state.status == _OPTIMAL) | (state.status == _INFEASIBLE) | (state.status == _UNBOUNDED)
    )
    nt = ~terminal
    n_nt = int(nt.sum())
    if n_nt > bucket:
        state = _fold_to_best(ctx, b_s, c_s, state, kset, only=nt)
    if n_nt:  # with every lane terminal, the gathered finalize changes nothing
        idx = _first_lanes(nt, bucket)
        sub = _take(state, idx)
        x, y, z, tau, kappa, status, _ = _finalize(ctx, b_s[idx], c_s[idx], sub, kset, opts.tol)
        sub = sub._replace(x=x, y=y, z=z, tau=tau, kappa=kappa, status=status)
        state = _scatter(state, sub, idx, nt[idx])
    status = torch.where(state.status == _RUNNING, _ITERATION_LIMIT, state.status)
    return _unscaled_outputs(state.x, state.y, state.z, state.tau, state.kappa, status,
                             state.iterations, scaling, c_orig)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _full_precision_matmuls():
    """Run f32 matmuls in full f32 for the solve, restoring the flags after.

    TF32 keeps ~3 decimal digits: it destroys the positive-definiteness
    of A·D·Aᵀ and NaNs the Cholesky within a few iterations, as single-
    pass bf16 did on the reference's TPU (which pins
    ``default_matmul_precision("highest")`` for that reason).
    """
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            raise RuntimeError("TF32 could not be switched off for the solve")
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _dtype_of(a) -> torch.dtype:
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.empty(0, dtype=np.asarray(a).dtype)).dtype


def _resolve_dtype(opts: SolverOptions, *arrays) -> torch.dtype:
    """``opts.dtype``, else the promoted dtype of the inputs."""
    if opts.dtype:
        return _DTYPES[str(opts.dtype)]
    return functools.reduce(torch.promote_types, [_dtype_of(a) for a in arrays])


def _finish_dtype(opts: SolverOptions, dtype):
    """The wide finish dtype, or None when no (distinct) finish is configured."""
    if opts.finish_dtype is None or _DTYPES[str(opts.finish_dtype)] == dtype:
        return None
    return _DTYPES[str(opts.finish_dtype)]


def _to(v, dtype, dev):
    return torch.as_tensor(v, dtype=dtype, device=dev)


def hsd_solve_batched(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    kset: KernelSet = REFERENCE_KERNELS,
    reduce_any=None,
    *,
    warm=None,
    device="cuda",
):
    """Solve a batch of equality-form LPs ``min cᵀx, Ax = b, x ≥ 0``.

    Parameters
    ----------
    A : (m, n) shared or (B, m, n) per-instance constraint matrices.
    b : (B, m); c : (B, n).  numpy arrays or tensors.
    reduce_any : mask reduction of the loop predicate (a callable taking
        the (B,) RUNNING mask to a bool); None reduces locally.  The
        sharded solve passes :class:`pycllp_tpu_torch.parallel.CollectiveAny`
        so every rank's loops leave on the same iteration.
    warm : optional (x, y, z) starting point in UNSCALED equality
        coordinates, batched — typically the previous solve's solution on
        a nearby problem.  Overrides ``opts.init_point``.
    device : where the solve runs (``"cuda"`` by default; ``"cpu"`` only
        when asked).  A CUDA request without a card raises.

    Returns a dict of tensors on ``device``: x, y, z, tau, kappa,
    objective, status, iterations, rho_p, rho_d, rho_gap — all with
    leading batch axis.
    """
    dev = resolve_device(device)
    with _full_precision_matmuls():
        return _hsd_solve_batched_impl(A, b, c, opts, kset, dev, warm, reduce_any)


def _hsd_solve_batched_impl(A, b, c, opts, kset, dev, warm=None, reduce_any=None):
    dtype = _resolve_dtype(opts, A, b, c)
    fdtype = _finish_dtype(opts, dtype)
    # With a finish phase configured, scaling and the phase-2 arrays are
    # built in the WIDE dtype from the original inputs; phase 1 sees the
    # rounded copies.  (Upcasting already-rounded phase-1 arrays would
    # make the polish phase faithfully solve the rounded problem and
    # freeze in an O(ε_narrow) objective error.)
    wide = fdtype or dtype
    A_w = _to(A, wide, dev)
    b_w = _to(b, wide, dev)
    c_w = _to(c, wide, dev)

    if opts.scale:
        scaling = ruiz_equilibrate(A_w)
        A_sw, b_sw, c_sw = scale_problem(A_w, b_w, c_w, scaling)
    else:
        scaling = None
        A_sw, b_sw, c_sw = A_w, b_w, c_w
    A_s, b_s, c_s = A_sw.to(dtype), b_sw.to(dtype), c_sw.to(dtype)

    ctx = kset.prepare(A_s)
    if warm is not None:
        # map the user's unscaled warm point into scaled coordinates
        # (inverse of unscale_solution: x̃ = x/s, ỹ = y/r, z̃ = z·s)
        xw, yw, zw = (_to(v, dtype, dev) for v in warm)
        if scaling is not None:
            xw = xw / scaling.col.to(dtype)
            yw = yw / scaling.row.to(dtype)
            zw = zw * scaling.col.to(dtype)
        warm = (xw, yw, zw)
    state = _fresh_state(ctx, b_s, c_s, opts, kset, dtype, warm=warm)

    phase1_tol = max(opts.tol, opts.switch_tol) if fdtype else opts.tol
    state = _run_narrow_phase(ctx, b_s, c_s, state, opts, kset, dtype, phase1_tol, opts.maxiter,
                              reduce_any)
    if fdtype is None:
        return _package(ctx, b_s, c_s, state, kset, opts, scaling, c_w)

    # continue the SAME interior state in the wide dtype, against the
    # wide-dtype problem data; the kernel set may substitute a wide
    # sibling (KernelSet.finish_kernels) so the O(m³) work stays fast
    fkset = kset.finish_kernels(opts.finish_kset)
    ckset = _crossover_kset(kset, fkset, opts)
    state = _fold_to_best(ctx, b_s, c_s, state, kset)
    ctx = fkset.prepare(A_sw)
    cctx = ctx if ckset is fkset else ckset.prepare(A_sw)
    state = _cast_state(state, fdtype)
    state = state._replace(
        best_score=torch.full_like(state.best_score, torch.finfo(fdtype).max),
        best_k=torch.full_like(state.best_k, state.k),
    )
    if opts.finish_mode == "crossover":
        # one wide basis solve finishes accepted lanes as OPTIMAL;
        # rejects are re-opened RUNNING for the IPM continuation below
        state = _crossover_state(cctx, b_sw, c_sw, state, ckset, opts, opts.tol)
    else:
        state = state._replace(
            status=torch.where(state.status != _NUMERICAL, _RUNNING, state.status)
        )
    wopts = _wide_opts(opts)
    state = _run_phase(
        ctx, b_sw, c_sw, state, wopts, fkset, fdtype, opts.tol, opts.maxiter + opts.finish_maxiter,
        reduce_any,
    )
    if opts.finish_mode == "crossover":
        # second attempt after the IPM sharpened the rejects, and a rescue
        # for lanes whose IPM stalled just above tol; reopen=False keeps
        # reject statuses STALLED/NUMERICAL for the restart below
        state = _fold_to_best(ctx, b_sw, c_sw, state, fkset)
        state = _crossover_state(cctx, b_sw, c_sw, state, ckset, opts, opts.tol, reopen=False)
    if opts.finish_restart:
        # fresh-restart fallback: STALLED/NUMERICAL lanes rerun from a cold
        # Mehrotra start; still-RUNNING (budget-capped) lanes continue warm
        # with the restart round's budget (k resets to 0)
        retry = (state.status == _STALLED) | (state.status == _NUMERICAL)
        fresh = _fresh_state(ctx, b_sw, c_sw, opts.replace(init_point="mehrotra"), fkset, fdtype)
        state = _restart_merge(state, fresh, retry)
        state = _run_phase(
            ctx, b_sw, c_sw, state, wopts.replace(stall_patience=_NO_STALL), fkset, fdtype,
            opts.tol, opts.finish_maxiter + 10, reduce_any,
        )
    return _package(ctx, b_sw, c_sw, state, fkset, opts, scaling, c_w)


def _wide_opts(opts: SolverOptions) -> SolverOptions:
    """Options of the wide IPM phases: the finish patience, no relative
    stall threshold, the finish KKT sweeps (symmetric: the asymmetric
    predictor schedule is a narrow knob) and the finish Gondzio count."""
    return opts.replace(
        stall_patience=opts.finish_patience,
        stall_rtol=0.0,
        kkt_refine=opts.resolved_finish_kkt_refine(),
        kkt_refine_pred=None,
        gondzio_correctors=opts.finish_gondzio,
    )


def hsd_solve(A, b, c, opts: SolverOptions = SolverOptions(), kset: KernelSet = REFERENCE_KERNELS,
              *, device="cuda"):
    """Unbatched convenience wrapper: solve one ``min cᵀx, Ax=b, x≥0``."""
    out = hsd_solve_batched(A, b[None], c[None], opts, kset, device=device)
    return {k: v[0] for k, v in out.items()}


def _sanitize_carry(x, y, z, ok, cap=1e6):
    """Per-lane warm-carry sanitizer: non-finite / not-ok lanes fall back
    to the blind start, finite ones are clipped (τ→0 lanes blow up)."""
    fin = (
        ok
        & torch.isfinite(x).all(dim=-1)
        & torch.isfinite(y).all(dim=-1)
        & torch.isfinite(z).all(dim=-1)
    )
    fn = fin[..., None]
    return (
        torch.where(fn, x.clamp(0.0, cap), 1.0),
        torch.where(fn, y.clamp(-cap, cap), 0.0),
        torch.where(fn, z.clamp(0.0, cap), 1.0),
    )


def _hsd_scan_core(A, b3, c3, opts, kset, keys, dev, warm_chain=False):
    """No-cap chunked solve: one batched solve per chunk, in chunk order.

    With ``warm_chain``, chunk k+1's lane j starts from chunk k's lane-j
    solution (chunk 0 from the blind start).
    """
    outs = []
    carry = None
    if warm_chain:
        dtype = _resolve_dtype(opts, A, b3, c3)
        _, B, m = b3.shape
        n = c3.shape[2]
        carry = (
            torch.ones((B, n), dtype=dtype, device=dev),
            torch.zeros((B, m), dtype=dtype, device=dev),
            torch.ones((B, n), dtype=dtype, device=dev),
        )
    for bc, cc in zip(b3, c3):
        out = _hsd_solve_batched_impl(A, bc, cc, opts, kset, dev, warm=carry)
        if warm_chain:
            ok = torch.isin(
                out["status"],
                torch.tensor([_OPTIMAL, _STALLED, _ITERATION_LIMIT], device=dev,
                             dtype=out["status"].dtype),
            )
            carry = _sanitize_carry(out["x"], out["y"], out["z"], ok)
        outs.append(out)
    return {k: torch.cat([o[k] for o in outs]) for k in keys}


def _compact_resume(
    ctx, b_sf, c_sf, sflat, opts, kset, dtype, tol, maxiter, bucket, restart=False
):
    """Compact the still-RUNNING lanes and resume them warm.

    Stable argsort of the finished mask → gather the full interior state
    of up to ``bucket`` unfinished lanes into one dense batch, run the
    masked loop with the remaining budget, scatter the state back.  Lanes
    beyond ``bucket`` (overflow) keep their capped state.

    ``restart=True``: additionally gather STALLED/NUMERICAL lanes and
    rerun those from a COLD Mehrotra start (old best trackers kept, so a
    failed restart cannot regress); still-RUNNING lanes in the same
    bucket resume WARM.
    """
    unfinished = _retry_mask(sflat.status) if restart else (sflat.status == _RUNNING)
    idx = _first_lanes(unfinished, bucket)
    state2 = _take(sflat, idx)
    resumed = unfinished[idx]
    if restart:
        fresh = _fresh_state(
            ctx, b_sf[idx], c_sf[idx], opts.replace(init_point="mehrotra"), kset, dtype
        )
        stuck = (sflat.status == _STALLED) | (sflat.status == _NUMERICAL)
        # _restart_merge re-opens the stuck lanes and zeroes every lane's
        # stall clock; RUNNING overflow lanes keep their warm state
        state2 = _restart_merge(state2, fresh, stuck[idx])
        opts = opts.replace(stall_patience=_NO_STALL)
    else:
        # restart the stall clock at the resume point: gathered lanes carry
        # a best_k from their own (earlier) clock, and k may have jumped
        # past it
        state2 = state2._replace(best_k=torch.full_like(state2.best_k, state2.k))
    state2 = _run_phase(ctx, b_sf[idx], c_sf[idx], state2, opts, kset, dtype, tol, maxiter)
    return _scatter(sflat, state2, idx, resumed)


def _narrow_opts_view(opts: SolverOptions, phase1_tol: float) -> SolverOptions:
    """Canonicalize finish-phase knobs out of the narrow stages' options
    (as the reference, whose narrow program is cached on them).
    ``finish_dtype`` is kept — it decides the dtype the scaling is
    computed in — and the phase-1 tolerance is pre-folded into ``tol``."""
    return opts.replace(
        tol=phase1_tol,
        switch_tol=1e-3,
        finish_maxiter=20,
        finish_kset="df64",
        finish_patience=8,
        finish_restart=True,
        finish_mode="ipm",
        finish_kkt_refine=None,
        finish_gondzio=0,
        crossover_refine=2,
        crossover_feas_tol=1e-9,
        crossover_kset="mixed1",
        crossover_repair=2,
    )


def _finish_opts_view(opts: SolverOptions) -> SolverOptions:
    """The twin of :func:`_narrow_opts_view`: canonicalize narrow-only
    knobs out of the finish stages' options; ``kkt_refine`` (a narrow
    acceptance knob) is pre-resolved into ``finish_kkt_refine``."""
    return opts.replace(
        maxiter=40,
        stall_patience=12,
        stall_rtol=0.0,
        kkt_refine=0,
        finish_kkt_refine=opts.resolved_finish_kkt_refine(),
        gondzio_correctors=0,
        kkt_refine_pred=None,
        kkt_warmup=0,
        init_point="mehrotra",
        warm_start=False,
        warm_lambda=0.05,
        switch_tol=1e-3,
    )


def _scan_scaled_arrays(A, b3, c3, opts, dev):
    """Shared preamble of the scan stages: wide + narrow scaled data.

    With a finish configured the Ruiz scaling and the scaled data are
    computed in the WIDE dtype from the original inputs (the narrow
    stages cast them down), as in :func:`_hsd_solve_batched_impl`.
    Returns ``(dtype, wide, scaling, A_sw, b_sfw, c_sfw, c_flat_w)``.
    """
    dtype = _resolve_dtype(opts, A, b3, c3)
    wide = _finish_dtype(opts, dtype) or dtype
    K, chunk, m = b3.shape
    n = c3.shape[-1]
    N = K * chunk
    A_w = _to(A, wide, dev)
    c_flat_w = c3.reshape(N, n).to(wide)
    b_flat_w = b3.reshape(N, m).to(wide)
    if opts.scale:
        scaling = ruiz_equilibrate(A_w)
        A_sw, b_sfw, c_sfw = scale_problem(A_w, b_flat_w, c_flat_w, scaling)
    else:
        scaling = None
        A_sw, b_sfw, c_sfw = A_w, b_flat_w, c_flat_w
    return dtype, wide, scaling, A_sw, b_sfw, c_sfw, c_flat_w


def _hsd_scan_narrow_core(A, b3, c3, opts, kset, keys, cap, bucket, dev, warm_chain=False):
    """Stage 1: capped narrow chunks; stage 2: compacted warm resume.

    A chunk's masked loop runs to its SLOWEST lane, so every chunk is
    capped at ``cap`` iterations; the still-running lanes are compacted
    into one ``bucket``-wide batch that resumes WARM (same iterates, best
    trackers, loop counter continuing at ``cap``) with the full
    ``opts.maxiter`` budget.  Results scatter back over the stage-1 rows.

    With ``keys`` the packaged outputs are returned; with ``keys=None``
    the flat narrow :class:`HSDState`, for :func:`_hsd_scan_finish_core`.
    """
    dtype, _, scaling, A_sw, b_sfw, c_sfw, c_flat_w = _scan_scaled_arrays(A, b3, c3, opts, dev)
    K, chunk, m = b3.shape
    n = c3.shape[-1]
    A_s, b_sf, c_sf = A_sw.to(dtype), b_sfw.to(dtype), c_sfw.to(dtype)
    ctx = kset.prepare(A_s)
    tol = opts.tol

    # ---- stage 1: capped narrow chunks, in chunk order ----
    carry = None
    if warm_chain:
        carry = (
            torch.ones((chunk, n), dtype=dtype, device=dev),
            torch.zeros((chunk, m), dtype=dtype, device=dev),
            torch.ones((chunk, n), dtype=dtype, device=dev),
        )
    states = []
    for kk in range(K):
        rows = slice(kk * chunk, (kk + 1) * chunk)
        b_s, c_s = b_sf[rows], c_sf[rows]
        state = _fresh_state(ctx, b_s, c_s, opts, kset, dtype, warm=carry)
        state = _run_narrow_phase(ctx, b_s, c_s, state, opts, kset, dtype, tol, cap)
        if warm_chain:
            # chunk k+1 lane j warm-starts from chunk k lane j's interior point
            tau_safe = state.tau.clamp(min=torch.finfo(dtype).tiny)[..., None]
            carry = _sanitize_carry(
                state.x / tau_safe, state.y / tau_safe, state.z / tau_safe,
                state.status != _NUMERICAL,
            )
        states.append(state)
    # every still-RUNNING lane's chunk ran to exactly `cap` (an early-
    # exiting chunk has no running lanes), so stage 2 resumes at k = cap
    sflat = HSDState(**{
        f: cap if f == "k" else torch.cat([getattr(s, f) for s in states])
        for f in HSDState._fields
    })
    del states

    # ---- stage 2: compact the narrow tail, resume with full budget ----
    sflat = _compact_resume(ctx, b_sf, c_sf, sflat, opts, kset, dtype, tol, opts.maxiter, bucket)
    if keys is None:
        return sflat
    outs = _package(ctx, b_sf, c_sf, sflat, kset, opts, scaling, c_flat_w.to(dtype))
    return {k: outs[k] for k in keys}


def _hsd_scan_finish_core(
    A, b3, c3, sflat, opts, kset, keys, finish_cap, finish_bucket, dev, rounds=4,
    truncate=None,
):
    """Stages 3+4: the wide finish over the narrow :class:`HSDState`.

    Polishes every lane to the full ``opts.tol`` in the wide dtype.
    Stage 3 runs the vertex crossover (or a capped wide IPM) per chunk;
    stage 4 drains the rejects through bounded rounds of gathered wide
    work, each skipped when no lane needs it, so a high-acceptance batch
    pays ~nothing there, and a reject volume larger than a bucket is
    drained by repeats instead of overflowing to ITERATION_LIMIT.

    ``truncate`` ("pre", "stage3", "tier0" or "tier1"; the reference's
    ``PYCLLP_FINISH_TRUNCATE``) returns the packaged outputs right after
    the named stage, to split the finish's cost.
    """
    dtype, wide, scaling, A_sw, b_sfw, c_sfw, c_flat_w = _scan_scaled_arrays(
        A, b3, c3, opts, dev
    )
    K, chunk, m = b3.shape
    n = c3.shape[-1]
    N = K * chunk
    A_s, b_sf, c_sf = A_sw.to(dtype), b_sfw.to(dtype), c_sfw.to(dtype)
    ctx = kset.prepare(A_s)

    # ---- stage 3: wide finish over ALL lanes, chunk by chunk ----
    fkset = kset.finish_kernels(opts.finish_kset)
    fctx = fkset.prepare(A_sw)
    ckset = _crossover_kset(kset, fkset, opts)
    cctx = fctx if ckset is fkset else ckset.prepare(A_sw)
    sflat = _fold_to_best(ctx, b_sf, c_sf, sflat, kset)
    sflat = _cast_state(sflat, wide)
    sflat = sflat._replace(
        k=0,
        best_score=torch.full_like(sflat.best_score, torch.finfo(wide).max),
        best_k=torch.zeros_like(sflat.best_k),
    )
    wopts = _wide_opts(opts)

    def packaged(s):
        outs = _package_bucketed(fctx, b_sfw, c_sfw, s, fkset, opts, scaling, c_flat_w,
                                 finish_bucket)
        return {k: outs[k] for k in keys}

    if truncate == "pre":
        return packaged(sflat)

    if opts.finish_mode == "crossover":
        # ONE basis solve per lane: accepted lanes are OPTIMAL outright;
        # rejects re-open RUNNING and fall through to the drain tiers.
        # Repair is 0 here: tier 0 applies opts.crossover_repair to the
        # GATHERED rejects instead (same math, a fraction of the width).
        s3_opts = opts.replace(crossover_repair=0)

        def stage3(st, b_s, c_s):
            return _crossover_state(cctx, b_s, c_s, st, ckset, s3_opts, opts.tol)

        base_k = 0
    else:
        sflat = sflat._replace(
            status=torch.where(sflat.status != _NUMERICAL, _RUNNING, sflat.status)
        )

        def stage3(st, b_s, c_s):
            return _run_phase(fctx, b_s, c_s, st, wopts, fkset, wide, opts.tol, finish_cap)

        base_k = finish_cap

    parts = []
    for kk in range(K):
        rows = slice(kk * chunk, (kk + 1) * chunk)
        parts.append(stage3(_take(sflat, rows), b_sfw[rows], c_sfw[rows]))  # each from k = 0
    sflat = HSDState(**{
        f: base_k if f == "k" else torch.cat([getattr(p, f) for p in parts])
        for f in HSDState._fields
    })
    del parts
    if truncate == "stage3":
        return packaged(sflat)

    if opts.finish_mode == "crossover":
        # ---- stage 4 (crossover): bounded draining rounds ----
        def drain(s, width, n_rounds, body):
            """Bounded rounds of [gather → body → scatter] over the RUNNING
            lanes, each lane treated AT MOST ONCE: a lane still RUNNING
            after a full tier treatment is masked out of later rounds.
            Rounds repeat only to drain reject VOLUME beyond one bucket;
            the loop ends as soon as no untreated lane is RUNNING."""
            treated = torch.zeros_like(s.status, dtype=torch.bool)
            for _ in range(n_rounds):
                unfinished = (s.status == _RUNNING) & ~treated
                if not bool(unfinished.any()):
                    break
                idx = _first_lanes(unfinished, width)
                resumed = unfinished[idx]
                st2 = body(b_sfw[idx], c_sfw[idx], _take(s, idx))
                treated = treated.clone()
                treated[idx] = treated[idx] | resumed
                s = _scatter(s, st2, idx, resumed)
            return s

        # tier 0: basis-repair rounds on the gathered rejects, mixed engine
        def tier0(b2, c2, st2):
            return _crossover_state(cctx, b2, c2, st2, ckset, opts, opts.tol)

        if opts.crossover_repair:  # without repair a re-cross of the
            # unchanged state would re-fail identically — skip the tier
            sflat = drain(sflat, min(max(16384, 8 * finish_bucket), N), rounds, tier0)
        if truncate == "tier0":
            return packaged(sflat)

        # the wide tiers verify at a FLOORED feasibility tolerance (a right
        # basis solved in wide precision carries residual ~1e-8-class for
        # the ill-conditioned lanes that reach them) with one refinement
        # sweep after a direct wide factor
        topts = opts.replace(
            crossover_feas_tol=max(opts.crossover_feas_tol, 1e-8),
            crossover_refine=min(opts.crossover_refine, 1),
        )

        # tier 1: short wide IPM → wide cross (budgets relative to st2.k)
        def tier1(b2, c2, st2):
            st2 = st2._replace(best_k=torch.full_like(st2.best_k, st2.k))
            st2 = _run_phase(fctx, b2, c2, st2, wopts, fkset, wide, opts.tol,
                             st2.k + finish_cap)
            st2 = _fold_to_best(fctx, b2, c2, st2, fkset)
            return _crossover_state(fctx, b2, c2, st2, fkset, topts, opts.tol)

        sflat = drain(sflat, finish_bucket, rounds, tier1)
        if truncate == "tier1":
            return packaged(sflat)

        # tier 2: narrow, deep — IPM to budget, restart, rescue.
        # reopen=False in the rescue keeps rejects STALLED, so each lane
        # gets the deep treatment exactly once
        def tier2(b2, c2, st2):
            st2 = st2._replace(best_k=torch.full_like(st2.best_k, st2.k))
            st2 = _run_phase(fctx, b2, c2, st2, wopts, fkset, wide, opts.tol,
                             st2.k + opts.finish_maxiter)
            if opts.finish_restart:
                stuck = (st2.status == _STALLED) | (st2.status == _NUMERICAL)
                fresh = _fresh_state(
                    fctx, b2, c2, opts.replace(init_point="mehrotra"), fkset, wide
                )
                st2 = _restart_merge(st2, fresh, stuck)
                st2 = _run_phase(
                    fctx, b2, c2, st2, wopts.replace(stall_patience=_NO_STALL), fkset, wide,
                    opts.tol, opts.finish_maxiter + 10,
                )
            st2 = _fold_to_best(fctx, b2, c2, st2, fkset)
            return _crossover_state(fctx, b2, c2, st2, fkset, topts, opts.tol, reopen=False)

        sflat = drain(sflat, 256, rounds, tier2)
    else:
        # ---- stage 4 (ipm): two gated compact rounds.  A tail larger
        # than the bucket overflows round 1 — those lanes stay RUNNING and
        # round 2 gathers them; round 2 doubles as the fresh-restart
        # fallback for STALLED/NUMERICAL lanes.  Each round's budget
        # extends past the previous round's endpoint (k is shared). ----
        if bool((sflat.status == _RUNNING).any()):
            sflat = _compact_resume(
                fctx, b_sfw, c_sfw, sflat, wopts, fkset, wide, opts.tol,
                base_k + opts.finish_maxiter, finish_bucket,
            )
        if bool(_retry_mask(sflat.status).any()):
            sflat = _compact_resume(
                fctx, b_sfw, c_sfw, sflat, wopts, fkset, wide, opts.tol,
                base_k + 2 * opts.finish_maxiter, finish_bucket,
                restart=opts.finish_restart,
            )
    if any(k in ("rho_p", "rho_d", "rho_gap") for k in keys):
        outs = _package(fctx, b_sfw, c_sfw, sflat, fkset, opts, scaling, c_flat_w)
        return {k: outs[k] for k in keys}
    # ρ diagnostics not requested → finalize/classify only the gathered
    # non-terminal remainder (see _package_bucketed)
    return packaged(sflat)


def hsd_solve_scan(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    kset: KernelSet = REFERENCE_KERNELS,
    *,
    chunk: int = 16384,
    keys: tuple = ("x", "y", "z", "objective", "status", "iterations"),
    compact_cap: int | None = None,
    compact_bucket: int = 8192,
    finish_cap: int = 6,
    finish_bucket: int | None = None,
    warm_chain: bool = False,
    device="cuda",
    stage_sync: bool = False,
):
    """Chunked batched solve over shared 2-D ``A``.

    ``b``/``c`` are (N, m)/(N, n).  N is padded up to a chunk multiple
    (repeating the last row) and trimmed on return.  Returns the ``keys``
    fields only, as flat (N, ...) tensors on ``device``.

    ``compact_cap``: cap every chunk at this iteration count, then compact
    the still-running lanes into one ``compact_bucket``-wide batch that
    resumes warm with the full budget (see :func:`_hsd_scan_narrow_core`).
    Lanes beyond ``compact_bucket`` keep their capped answer.

    With ``opts.finish_dtype`` set, the compact sweep is followed by a
    wide polish of EVERY lane to the full ``opts.tol``
    (:func:`_hsd_scan_finish_core`): per chunk, one vertex crossover
    (``finish_mode="crossover"``) or a ``finish_cap``-capped wide IPM,
    then the rejects drained through buckets of ``finish_bucket`` lanes
    (default ``compact_bucket``).

    ``warm_chain``: chunk k+1's lane j warm-starts from chunk k's lane-j
    solution, for correlated scenario streams.

    ``stage_sync``: with a finish, synchronise the device after the
    narrow and after the finish stage and print each stage's seconds to
    stderr (the reference's ``PYCLLP_SCAN_SYNC``).
    """
    if getattr(A, "ndim", 2) != 2:
        raise ValueError("hsd_solve_scan requires shared 2-D A")
    dev = resolve_device(device)
    b = torch.as_tensor(b, device=dev)
    c = torch.as_tensor(c, device=dev)
    dtype = _resolve_dtype(opts, A, b, c)
    N = b.shape[0]
    chunk = min(chunk, N)
    pad = (-N) % chunk
    if pad:
        b = torch.cat([b, b[-1:].expand(pad, -1)])
        c = torch.cat([c, c[-1:].expand(pad, -1)])
    K = b.shape[0] // chunk
    b3 = b.reshape(K, chunk, -1)
    c3 = c.reshape(K, chunk, -1)
    keys = tuple(keys)
    with _full_precision_matmuls():
        if compact_cap is None:
            res = _hsd_scan_core(A, b3, c3, opts, kset, keys, dev, bool(warm_chain))
        elif _finish_dtype(opts, dtype) is None:
            res = _hsd_scan_narrow_core(
                A, b3, c3, opts, kset, keys, int(compact_cap),
                min(int(compact_bucket), K * chunk), dev, bool(warm_chain),
            )
        else:
            phase1_tol = max(opts.tol, opts.switch_tol)
            t0 = time.perf_counter()
            sflat = _hsd_scan_narrow_core(
                A, b3, c3, _narrow_opts_view(opts, phase1_tol), kset, None,
                int(compact_cap), min(int(compact_bucket), K * chunk), dev, bool(warm_chain),
            )
            if stage_sync:
                _sync(dev)
                running = int((sflat.status == _RUNNING).sum())
                print(f"[scan] narrow stage: {time.perf_counter() - t0:.3f}s "
                      f"(sync; {running} lanes still RUNNING)", file=sys.stderr, flush=True)
                t0 = time.perf_counter()
            fb = min(int(finish_bucket or compact_bucket), K * chunk)
            res = _hsd_scan_finish_core(
                A, b3, c3, sflat, _finish_opts_view(opts), kset, keys, int(finish_cap), fb, dev,
                # enough drain rounds to empty the WHOLE batch through the
                # bucket; the rounds loop ends once no lane is RUNNING
                rounds=max(4, -(-(K * chunk) // fb)),
            )
            if stage_sync:
                _sync(dev)
                print(f"[scan] finish stage: {time.perf_counter() - t0:.3f}s (sync)",
                      file=sys.stderr, flush=True)
    return {k: v[:N] for k, v in res.items()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
