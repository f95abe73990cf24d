"""Homogeneous self-dual interior-point core (batched), narrow + wide finish.

Counterpart of :mod:`pycllp_tpu.solvers.hsd`, ported function by
function with the same names.  Algorithm: the homogeneous self-dual
embedding with Mehrotra predictor-corrector, KKT-level refinement,
Gondzio correctors, per-lane best-iterate tracking and a stall cutoff;
with ``finish_dtype`` set, a wide f64 finish (vertex crossover or a wide
IPM continuation) polishes every lane to the full ``tol``.

What differs from the reference, and why:

* ``lax.while_loop`` becomes blocks of gated iterations
  (:func:`pycllp_tpu_torch.solvers._loop._device_while`): the predicate
  ``(k < maxiter) & any(status == RUNNING)`` is computed on the device,
  an iteration whose predicate is false keeps the state's bits, and the
  host reads the predicate once a block (``_loop.BLOCK`` iterations where
  the lanes share an A that the lane-group factor takes,
  ``_loop.BLOCK_PER_INSTANCE`` where each has its own or a shared A is
  larger: :func:`_phase_block`); on the card each block is a replayed
  CUDA graph.  The loop counter ``k`` is a 0-d int32 tensor on the state's
  device, as in the reference's carry, and a budget may be
  an int or such a tensor.  Two routes keep a host loop that reads the
  predicate every iteration: ``log_every`` (its records are read back
  each iteration, where the reference calls back under ``lax.cond``) and
  a collective ``reduce_any`` (a gloo collective cannot be captured, and
  every rank must advance ``k`` in lockstep).  ``lax.scan`` over chunks
  becomes a Python loop over chunks, and every ``lax.cond`` (and the drain
  rounds' ``lax.while_loop``) a Python branch on a predicate read back
  from the device.  The straight-line code between those reads — of the
  scan stages, of ``hsd_solve_batched`` and of the no-cap scan — runs as
  segments (:func:`_seg`, :func:`_loop._segment`): on the card each is a
  replayed CUDA graph, so the host reads what the reference's predicates
  read and dispatches nothing else one launch at a time but the copy of
  numpy inputs to the card; ``_EAGER_SEGMENTS`` runs them eagerly, for
  on-card comparisons.
  ``maxiter`` stays absolute in ``k``, and a compacted bucket resumes at
  ``k = cap``.
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
* Profiler marks (``torch.profiler.record_function`` ranges, beside
  those of :mod:`pycllp_tpu_torch.solvers._loop`): each call of
  :func:`hsd_solve_scan` and :func:`hsd_solve_batched` under its own
  name, the scan's ``narrow stage`` and ``finish stage``, and ``ipm
  phase`` around each :func:`_run_phase`.  None adds a sync or a host
  read.

Problem form: ``min cᵀx  s.t.  Ax = b, x ≥ 0`` (EqualityLP).  HSD
embedding variables: x ≥ 0, y free, z ≥ 0, τ ≥ 0, κ ≥ 0; residuals

    r_p = bτ − Ax,   r_d = cτ − Aᵀy − z,   r_g = cᵀx − bᵀy + κ,
    μ = (xᵀz + τκ)/(n+1).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from pycllp_tpu_torch.ops.batchlast import uses_smem
from pycllp_tpu_torch.ops.reference import KernelSet, REFERENCE_KERNELS
from pycllp_tpu_torch.solvers import _loop
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

# IPM iterations run by _run_phase (and by dense_path's loop): the
# iterations whose k advanced (read once a phase from the change in k on the
# gated route, one per body on the host loop).  Counted like the kernels'
# launch counters, so a caller can tie launches to iterations.
HOST_STEPS = 0
# the contexts that the kernel sets' ``prepare`` returned in the last entry
# call (hsd_solve_batched, hsd_solve_scan): (set name, bytes of the
# context's tensors, each storage once) → prepares, counted at replay too,
# as the launch counters are (_loop._counters).  A set that prepares the
# same A in two segments (the crossover's) shows one key, counted twice
PREPARED_BYTES: collections.Counter = collections.Counter()
# the vertex crossover's lanes on the device, per (device, crossover): int64
# (tried, accepted), added to inside the segments that run it, never read
# by the solver.  "first" is a crossover whose rejects go on to the wide IPM
# (reopen), "final" one that leaves them as they are
CROSSOVER_LANES: dict = {}
# True runs every phase as the per-iteration host loop (the route that
# log_every and a collective reduce_any take), and the scan stages'
# segments eagerly, for on-card comparisons
_HOST_LOOP = False
# True runs the scan stages' straight-line segments eagerly (the IPM loops
# stay graphs), for on-card comparisons
_EAGER_SEGMENTS = False

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class HSDState(NamedTuple):
    x: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m)
    z: torch.Tensor  # (B, n)
    tau: torch.Tensor  # (B,)
    kappa: torch.Tensor  # (B,)
    status: torch.Tensor  # (B,) int32
    iterations: torch.Tensor  # (B,) int32 — iterations spent while active
    k: torch.Tensor  # () int32 — global loop counter, on the state's device
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
    return bool(_loop._host_read(mask.any())) if reduce_any is None else bool(reduce_any(mask))


def _phase_cond(s: HSDState, maxiter):
    """The reference's loop predicate, reduced locally, on the device."""
    return (s.k < maxiter) & (s.status == _RUNNING).any()


def _phase_block(A, dtype) -> int:
    """Gated iterations a block of a phase on ``A`` in ``dtype``.

    A gated-off iteration costs little where the lanes share an A whose
    factor takes the lane-group kernels (the host paces the card), and a
    running one's where each lane has its own A, or where a shared A is past
    the lane-group factor (m > 340 in float32, 240 in float64): there the
    streaming kernels keep the card busy, about a second an iteration at
    netlib SCAGR25's size (471 rows) on 2,048 lanes.
    """
    if A.dim() == 2 and uses_smem(A.shape[0], dtype):
        return _loop.BLOCK
    return _loop.BLOCK_PER_INSTANCE


@_loop._spanned("ipm phase")
def _run_phase(
    ctx, b, c, state: HSDState, opts: SolverOptions, kset: KernelSet,
    dtype, tol: float, maxiter, reduce_any=None,
) -> HSDState:
    """Run the masked IPM loop until all lanes finish or ``k == maxiter``.

    ``maxiter`` is an int or a 0-d int tensor (a budget such as
    ``k + finish_cap``).  The reference's ``lax.while_loop`` runs as
    blocks of gated iterations (:func:`_loop._device_while`; on the card,
    replayed CUDA graphs) whose predicate stays on the device: blocks of
    :func:`_phase_block` iterations.  With
    ``opts.log_every`` or a collective ``reduce_any`` (neither None nor
    ``torch.any``) it is a host loop that reads the predicate every
    iteration: ``k < maxiter`` is tested first, so ``reduce_any`` runs on
    every rank at the same ``k``.
    """
    global HOST_STEPS
    patience = opts.stall_patience

    def make_body(data):
        ctx, b, c = data
        step = _make_step_fn(ctx, b, c, opts, kset, dtype)

        def body(s: HSDState) -> HSDState:
            return _iteration(ctx, b, c, s, opts, kset, step, tol, patience)

        return body

    local = reduce_any is None or reduce_any is torch.any
    if opts.log_every or not local or _HOST_LOOP:
        body = make_body((ctx, b, c))
        k, limit = int(state.k), int(maxiter)
        s = state
        while k < limit:
            _loop.HOST_SYNCS += 1
            if not _any_running(s.status, reduce_any):
                break
            s = body(s)
            k += 1
            HOST_STEPS += 1
        return s
    if not isinstance(maxiter, torch.Tensor):
        maxiter = torch.full((), maxiter, dtype=torch.int32, device=state.k.device)
    block = _phase_block(ctx.A, dtype)
    s, steps = _loop._device_while(
        _phase_cond, make_body, state, (ctx, b, c), maxiter, block,
        key=("hsd._run_phase", opts, kset, dtype, tol),
    )
    HOST_STEPS += steps
    return s


def _iteration(ctx, b, c, s: HSDState, opts, kset, step, tol, patience) -> HSDState:
    """The loop body: classify, track the best iterate and the stall clock,
    take the Newton step (``step``) on the lanes still RUNNING."""
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

    if opts.log_every and int(s.k) % opts.log_every == 0:
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
    dtype, tol: float, maxiter, reduce_any=None,
) -> HSDState:
    """Narrow IPM phase with the ``kkt_warmup`` refine schedule: the first
    ``kkt_warmup`` iterations run with ``kkt_refine=0``, then the loop
    continues refined (two sequential loops over the same state; caps
    are absolute in ``k``, so resumed states skip the warmup)."""
    w = opts.kkt_warmup
    if opts.kkt_refine and w:
        cap = maxiter.clamp(max=w) if isinstance(maxiter, torch.Tensor) else min(w, maxiter)
        state = _run_phase(
            ctx, b, c, state, opts.replace(kkt_refine=0), kset, dtype, tol, cap, reduce_any,
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


def _check_finish_levels(kset: KernelSet, opts: SolverOptions, A) -> None:
    """Raise the finish and crossover sets' Ozaki level-cap ``ValueError``
    for a shared 2-D ``A`` before the narrow phase runs; their ``prepare``
    would raise it only after."""
    shape = np.shape(A)
    if len(shape) != 2:
        return
    fkset = kset.finish_kernels(opts.finish_kset)
    for ks in (fkset, _crossover_kset(kset, fkset, opts)):
        ks.check_ozaki_levels(*shape)


def _crossover_lanes(dev, which: str):
    """The (tried, accepted) counter of ``CROSSOVER_LANES`` for ``dev``,
    made on first use (an eager run: a segment's warm-up precedes its
    capture)."""
    key = (str(dev), which)
    if key not in CROSSOVER_LANES:
        CROSSOVER_LANES[key] = torch.zeros(2, dtype=torch.int64, device=dev)
    return CROSSOVER_LANES[key]


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
    _crossover_lanes(state.x.device, "first" if reopen else "final").add_(
        torch.stack((eligible, accept)).reshape(2, -1).sum(1))
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
        k=torch.zeros_like(state.k),
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


def _k_tensor(k: int, dev) -> torch.Tensor:
    """The loop counter ``k`` as a state holds it: a 0-d int32 tensor."""
    return torch.full((), k, dtype=torch.int32, device=dev)


def _best_k_at(state: HSDState) -> torch.Tensor:
    """Every lane's stall clock set to the state's ``k``."""
    return state.k.expand_as(state.best_k).clone()


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
            merged[name] = torch.maximum(v, v2)
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
            k=_k_tensor(0, dev),
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
        k=_k_tensor(0, dev),
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
    scaling, c_orig, bucket: int, keys=None,
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

    The host reads the count of non-terminal lanes (the reference's
    ``lax.cond`` predicate); the rest is one segment, which gathers and
    finalizes a bucket whatever the count, as the reference does (with
    every lane terminal it changes nothing), so the count decides one
    branch.  ``keys``: the outputs to return (all with None).
    """
    fold = _loop._read((~_terminal(state.status)).sum()) > bucket
    return _seg(_seg_package_bucketed, (state,), (ctx, b_s, c_s, scaling, c_orig), kset=kset,
                opts=opts, bucket=bucket, fold=fold, keys=keys)


def _terminal(status):
    return (status == _OPTIMAL) | (status == _INFEASIBLE) | (status == _UNBOUNDED)


def _seg_package_bucketed(state, data, *, kset, opts, bucket, fold, keys):
    (state,) = state
    ctx, b_s, c_s, scaling, c_orig = data
    nt = ~_terminal(state.status)
    if fold:
        state = _fold_to_best(ctx, b_s, c_s, state, kset, only=nt)
    idx = _first_lanes(nt, bucket)
    sub = _take(state, idx)
    x, y, z, tau, kappa, status, _ = _finalize(ctx, b_s[idx], c_s[idx], sub, kset, opts.tol)
    sub = sub._replace(x=x, y=y, z=z, tau=tau, kappa=kappa, status=status)
    state = _scatter(state, sub, idx, nt[idx])
    status = torch.where(state.status == _RUNNING, _ITERATION_LIMIT, state.status)
    out = _unscaled_outputs(state.x, state.y, state.z, state.tau, state.kappa, status,
                            state.iterations, scaling, c_orig)
    return out if keys is None else {k: out[k] for k in keys}


def _seg_package(state, data, *, kset, opts, keys, dtype):
    """:func:`_package` as a segment: the outputs ``keys`` of the terminal
    state, the objective from ``c_orig`` in ``dtype``; ``state = (state,
    scaling, c_orig)``, ``data`` the loop's ``(ctx, b_s, c_s)``."""
    state, scaling, c_orig = state
    ctx, b_s, c_s = data
    out = _package(ctx, b_s, c_s, state, kset, opts, scaling, c_orig.to(dtype))
    return {k: out[k] for k in keys}


def _prepare(kset: KernelSet, A):
    """``kset.prepare(A)``, counted in ``PREPARED_BYTES``."""
    ctx = kset.prepare(A)
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in _loop._flatten(ctx)}
    PREPARED_BYTES[(kset.name, sum(held.values()))] += 1
    return ctx


def _seg(fn, state: tuple, data, *, borrow: bool = False, **params):
    """``fn(state, data, **params)`` as one straight-line segment
    (:func:`_loop._segment`: on the card a replayed CUDA graph, eager with
    ``_EAGER_SEGMENTS`` or ``_HOST_LOOP``); ``params`` decide its launches
    and name it in the graph cache.  ``borrow``: a prologue whose result
    is used within the solve (its output buffers, not copies)."""
    key = (fn.__name__,) + tuple(sorted(params.items()))
    return _loop._segment(functools.partial(fn, **params), state, data, key,
                          eager=_EAGER_SEGMENTS or _HOST_LOOP, borrow=borrow)


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


@_loop._spanned("hsd_solve_batched")
def hsd_solve_batched(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    kset: KernelSet = REFERENCE_KERNELS,
    reduce_any=torch.any,
    warm=None,
    *,
    device="cuda",
):
    """Solve a batch of equality-form LPs ``min cᵀx, Ax = b, x ≥ 0``.

    Parameters
    ----------
    A : (m, n) shared or (B, m, n) per-instance constraint matrices.
    b : (B, m); c : (B, n).  numpy arrays or tensors.
    reduce_any : mask reduction of the loop predicate (a callable taking
        the (B,) RUNNING mask to a bool); ``torch.any`` or None reduces
        locally.  The sharded solve passes
        :class:`pycllp_tpu_torch.parallel.CollectiveAny` so every rank's
        loops leave on the same iteration.
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
    PREPARED_BYTES.clear()
    with _full_precision_matmuls():
        return _hsd_solve_batched_impl(A, b, c, opts, kset, dev, warm, reduce_any)


def _on(v, dev):
    """``v`` on ``dev`` in its own dtype: an input's copy to the device,
    which stays outside the segments (a copy from pageable host memory
    cannot be captured); the casts run inside them."""
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return torch.as_tensor(np.asarray(v), device=dev)


# the outputs of hsd_solve_batched
_BATCHED_KEYS = ("x", "y", "z", "tau", "kappa", "objective", "status", "iterations", "rho_p",
                 "rho_d", "rho_gap")


def _hsd_solve_batched_impl(A, b, c, opts, kset, dev, warm=None, reduce_any=None):
    """The reference's jitted ``hsd_solve_batched``: its loops through
    :func:`_run_phase`, the code between them as segments (:func:`_seg`).
    The prologue also prepares the finish's context, so that every later
    segment takes the narrow or the wide loop's data, and shares its
    static copy; the crossover's context is prepared inside the segments
    that run it, and never leaves them."""
    dtype = _resolve_dtype(opts, A, b, c)
    fdtype = _finish_dtype(opts, dtype)
    fkset = ckset = None
    if fdtype is not None:
        _check_finish_levels(kset, opts, A)
        fkset = kset.finish_kernels(opts.finish_kset)
        ckset = _crossover_kset(kset, fkset, opts)
    inputs = tuple(_on(v, dev) for v in (A, b, c))
    if warm is not None:
        inputs += (tuple(_on(v, dev) for v in warm),)
    state, narrow, wdata, scaling, c_w = _seg(
        _seg_batched_start, inputs, (), borrow=True, opts=opts, kset=kset, fkset=fkset,
        dtype=dtype, wide=fdtype or dtype)
    ctx, b_s, c_s = narrow

    phase1_tol = max(opts.tol, opts.switch_tol) if fdtype else opts.tol
    state = _run_narrow_phase(ctx, b_s, c_s, state, opts, kset, dtype, phase1_tol, opts.maxiter,
                              reduce_any)
    if fdtype is None:
        return _seg(_seg_package, (state, scaling, c_w), narrow, kset=kset, opts=opts,
                    keys=_BATCHED_KEYS, dtype=dtype)

    # continue the SAME interior state in the wide dtype, against the
    # wide-dtype problem data; the kernel set may substitute a wide
    # sibling (KernelSet.finish_kernels) so the O(m³) work stays fast
    fctx, b_sw, c_sw = wdata
    state = _seg(_seg_fold, (state,), narrow, kset=kset)
    state = _seg(_seg_wide_start, (state,), wdata, opts=opts, fkset=fkset, ckset=ckset,
                 fdtype=fdtype)
    wopts = _wide_opts(opts)
    state = _run_phase(
        fctx, b_sw, c_sw, state, wopts, fkset, fdtype, opts.tol, opts.maxiter + opts.finish_maxiter,
        reduce_any,
    )
    if opts.finish_mode == "crossover":
        # second attempt after the IPM sharpened the rejects, and a rescue
        # for lanes whose IPM stalled just above tol; reopen=False keeps
        # reject statuses STALLED/NUMERICAL for the restart below
        state = _seg(_seg_wide_cross, (state,), wdata, opts=opts, fkset=fkset, ckset=ckset,
                     fdtype=fdtype)
    if opts.finish_restart:
        # fresh-restart fallback: STALLED/NUMERICAL lanes rerun from a cold
        # Mehrotra start; still-RUNNING (budget-capped) lanes continue warm
        # with the restart round's budget (k resets to 0)
        state = _seg(_seg_tier_restart, (state,), wdata, opts=opts, fkset=fkset, wide=fdtype)
        state = _run_phase(
            fctx, b_sw, c_sw, state, wopts.replace(stall_patience=_NO_STALL), fkset, fdtype,
            opts.tol, opts.finish_maxiter + 10, reduce_any,
        )
    return _seg(_seg_package, (state, scaling, c_w), wdata, kset=fkset, opts=opts,
                keys=_BATCHED_KEYS, dtype=fdtype)


def _seg_batched_start(state, data, *, opts, kset, fkset, dtype, wide):
    """:func:`_hsd_solve_batched_impl`'s prologue, from ``state = (A, b, c)``
    or ``(A, b, c, warm)`` on the device in their own dtypes: the starting
    state, the narrow loop's data ``(ctx, b_s, c_s)``, the wide loop's
    ``(fctx, b_sw, c_sw)`` (None without a finish), the scaling and ``c``
    in ``wide``.

    With a finish, scaling and the phase-2 arrays are built in the WIDE
    dtype from the original inputs; phase 1 sees the rounded copies.
    (Upcasting already-rounded phase-1 arrays would make the polish phase
    faithfully solve the rounded problem and freeze in an O(ε_narrow)
    objective error.)"""
    A_w, b_w, c_w = (v.to(wide) for v in state[:3])
    if opts.scale:
        scaling = ruiz_equilibrate(A_w)
        A_sw, b_sw, c_sw = scale_problem(A_w, b_w, c_w, scaling)
    else:
        scaling = None
        A_sw, b_sw, c_sw = A_w, b_w, c_w
    A_s, b_s, c_s = A_sw.to(dtype), b_sw.to(dtype), c_sw.to(dtype)
    ctx = _prepare(kset, A_s)
    warm = None
    if len(state) > 3:
        # map the user's unscaled warm point into scaled coordinates
        # (inverse of unscale_solution: x̃ = x/s, ỹ = y/r, z̃ = z·s)
        xw, yw, zw = (v.to(dtype) for v in state[3])
        if scaling is not None:
            xw = xw / scaling.col.to(dtype)
            yw = yw / scaling.row.to(dtype)
            zw = zw * scaling.col.to(dtype)
        warm = (xw, yw, zw)
    s = _fresh_state(ctx, b_s, c_s, opts, kset, dtype, warm=warm)
    wdata = None if fkset is None else (_prepare(fkset, A_sw), b_sw, c_sw)
    return s, (ctx, b_s, c_s), wdata, scaling, c_w


def _seg_fold(state, data, *, kset):
    """The narrow state folded to its best iterates."""
    (s,) = state
    ctx, b, c = data
    return _fold_to_best(ctx, b, c, s, kset)


def _crossover_ctx(fctx, fkset, ckset, fdtype):
    """The crossover set's context, prepared from the wide context's A (in
    ``fdtype``: the scaled wide A that every set's ``prepare`` keeps)."""
    return fctx if ckset is fkset else _prepare(ckset, fctx.A.to(fdtype))


def _seg_wide_start(state, data, *, opts, fkset, ckset, fdtype):
    """The finish's start: the folded narrow state cast to ``fdtype``, its
    best trackers reset, then one wide basis solve that finishes accepted
    lanes as OPTIMAL and re-opens the rejects RUNNING for the IPM
    continuation (``finish_mode="crossover"``), or every lane not
    NUMERICAL re-opened."""
    (s,) = state
    fctx, b_sw, c_sw = data
    s = _cast_state(s, fdtype)
    s = s._replace(
        best_score=torch.full_like(s.best_score, torch.finfo(fdtype).max),
        best_k=_best_k_at(s),
    )
    if opts.finish_mode == "crossover":
        cctx = _crossover_ctx(fctx, fkset, ckset, fdtype)
        return _crossover_state(cctx, b_sw, c_sw, s, ckset, opts, opts.tol)
    return s._replace(status=torch.where(s.status != _NUMERICAL, _RUNNING, s.status))


def _seg_wide_cross(state, data, *, opts, fkset, ckset, fdtype):
    """After the wide IPM: the fold to the best iterates and the second
    crossover, its rejects left as they are (``reopen=False``)."""
    (s,) = state
    fctx, b_sw, c_sw = data
    s = _fold_to_best(fctx, b_sw, c_sw, s, fkset)
    cctx = _crossover_ctx(fctx, fkset, ckset, fdtype)
    return _crossover_state(cctx, b_sw, c_sw, s, ckset, opts, opts.tol, reopen=False)


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
    solution (chunk 0 from the blind start).  The carry and the final
    concatenation are segments.
    """
    A = _on(A, dev)
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
            carry = _seg(_seg_warm_carry, (out["x"], out["y"], out["z"], out["status"]), ())
        outs.append({k: out[k] for k in keys})
    return _seg(_seg_cat, tuple(outs), ())


def _seg_warm_carry(state, data):
    """The next chunk's warm point: this chunk's solution where its status
    is OPTIMAL, STALLED or ITERATION_LIMIT and it is finite, else the
    blind start."""
    x, y, z, status = state
    ok = (status == _OPTIMAL) | (status == _STALLED) | (status == _ITERATION_LIMIT)
    return _sanitize_carry(x, y, z, ok)


def _seg_cat(state, data):
    """The chunks' outputs ``state`` (dicts of one set of keys),
    concatenated lane-wise."""
    return {k: torch.cat([o[k] for o in state]) for k in state[0]}


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

    The gather and the scatter are segments around the phase's loop.
    """
    state2, b2, c2, idx, resumed = _seg(
        _seg_resume_gather, (sflat,), (ctx, b_sf, c_sf), opts=opts, kset=kset, dtype=dtype,
        bucket=bucket, restart=restart)
    if restart:
        opts = opts.replace(stall_patience=_NO_STALL)
    state2 = _run_phase(ctx, b2, c2, state2, opts, kset, dtype, tol, maxiter)
    return _seg(_seg_scatter, (sflat, state2, idx, resumed), ())


def _seg_resume_gather(state, data, *, opts, kset, dtype, bucket, restart):
    """:func:`_compact_resume`'s gather: the gathered state, its ``b`` and
    ``c``, the lanes and which of them resume."""
    (sflat,) = state
    ctx, b_sf, c_sf = data
    unfinished = _retry_mask(sflat.status) if restart else (sflat.status == _RUNNING)
    idx = _first_lanes(unfinished, bucket)
    state2 = _take(sflat, idx)
    resumed = unfinished[idx]
    b2, c2 = b_sf[idx], c_sf[idx]
    if restart:
        fresh = _fresh_state(ctx, b2, c2, opts.replace(init_point="mehrotra"), kset, dtype)
        stuck = (sflat.status == _STALLED) | (sflat.status == _NUMERICAL)
        # _restart_merge re-opens the stuck lanes and zeroes every lane's
        # stall clock; RUNNING overflow lanes keep their warm state
        state2 = _restart_merge(state2, fresh, stuck[idx])
    else:
        # restart the stall clock at the resume point: gathered lanes carry
        # a best_k from their own (earlier) clock, and k may have jumped
        # past it
        state2 = state2._replace(best_k=_best_k_at(state2))
    return state2, b2, c2, idx, resumed


def _seg_scatter(state, data):
    return _scatter(*state)


def _seg_concat(state, data, *, k):
    """The states of the chunks ``state``, concatenated lane-wise, with the
    shared loop counter ``k``."""
    dev = state[0].k.device
    return HSDState(**{
        f: _k_tensor(k, dev) if f == "k" else torch.cat([getattr(st, f) for st in state])
        for f in HSDState._fields
    })


def _seg_chunk_start(state, data, *, opts, kset, dtype):
    """A chunk's starting state; with ``state = (prev,)`` (``warm_chain``)
    warm from the previous chunk's end, lane by lane (chunk 0, ``prev``
    None, from the blind start's point)."""
    ctx, b_s, c_s = data
    carry = None
    if state:
        (prev,) = state
        if prev is None:
            (B, m), n = b_s.shape, c_s.shape[-1]
            dev = b_s.device
            carry = (torch.ones((B, n), dtype=dtype, device=dev),
                     torch.zeros((B, m), dtype=dtype, device=dev),
                     torch.ones((B, n), dtype=dtype, device=dev))
        else:
            # chunk k+1 lane j warm-starts from chunk k lane j's interior point
            tau_safe = prev.tau.clamp(min=torch.finfo(dtype).tiny)[..., None]
            carry = _sanitize_carry(prev.x / tau_safe, prev.y / tau_safe, prev.z / tau_safe,
                                    prev.status != _NUMERICAL)
    return _fresh_state(ctx, b_s, c_s, opts, kset, dtype, warm=carry)


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


def _scan_scaled_arrays(A, b3, c3, opts, wide):
    """Shared preamble of the scan stages' prologues: the scaled data in
    the WIDE dtype, from ``A``, ``b3``, ``c3`` on the device.

    With a finish configured the Ruiz scaling and the scaled data are
    computed in the WIDE dtype from the original inputs (the narrow
    stages cast them down), as in :func:`_hsd_solve_batched_impl`.
    Returns ``(scaling, A_sw, b_sfw, c_sfw, c_flat_w)``.
    """
    K, chunk, m = b3.shape
    n = c3.shape[-1]
    N = K * chunk
    A_w = A.to(wide)
    c_flat_w = c3.reshape(N, n).to(wide)
    b_flat_w = b3.reshape(N, m).to(wide)
    if opts.scale:
        scaling = ruiz_equilibrate(A_w)
        A_sw, b_sfw, c_sfw = scale_problem(A_w, b_flat_w, c_flat_w, scaling)
    else:
        scaling = None
        A_sw, b_sfw, c_sfw = A_w, b_flat_w, c_flat_w
    return scaling, A_sw, b_sfw, c_sfw, c_flat_w


def _scan_dtypes(A, b3, c3, opts):
    """The scan stages' narrow and wide dtypes."""
    dtype = _resolve_dtype(opts, A, b3, c3)
    return dtype, _finish_dtype(opts, dtype) or dtype


def _seg_narrow_prologue(state, data, *, opts, kset, dtype, wide):
    """The narrow stage's prologue: the scaling, the narrow set's context,
    the scaled ``b`` and ``c`` (flat, in ``dtype``) and ``c`` (flat, in
    ``wide``)."""
    A, b3, c3 = state
    scaling, A_sw, b_sfw, c_sfw, c_flat_w = _scan_scaled_arrays(A, b3, c3, opts, wide)
    return scaling, _prepare(kset, A_sw.to(dtype)), b_sfw.to(dtype), c_sfw.to(dtype), c_flat_w


def _seg_finish_prologue(state, data, *, opts, kset, fkset, ckset, dtype, wide):
    """The finish stage's prologue: the scaling, the narrow, wide and
    crossover sets' contexts (the crossover's None where it is the wide
    set), the scaled ``b`` and ``c`` and ``c`` (flat, in ``wide``)."""
    A, b3, c3 = state
    scaling, A_sw, b_sfw, c_sfw, c_flat_w = _scan_scaled_arrays(A, b3, c3, opts, wide)
    ctx = _prepare(kset, A_sw.to(dtype))
    fctx = _prepare(fkset, A_sw)
    cctx = None if ckset is fkset else _prepare(ckset, A_sw)
    return scaling, ctx, fctx, cctx, b_sfw, c_sfw, c_flat_w


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
    dtype, wide = _scan_dtypes(A, b3, c3, opts)
    K, chunk, _ = b3.shape
    scaling, ctx, b_sf, c_sf, c_flat_w = _seg(
        _seg_narrow_prologue, (_on(A, dev), b3, c3), (), borrow=True, opts=opts, kset=kset,
        dtype=dtype, wide=wide)
    tol = opts.tol

    # ---- stage 1: capped narrow chunks, in chunk order ----
    states = []
    for kk in range(K):
        rows = slice(kk * chunk, (kk + 1) * chunk)
        data = (ctx, b_sf[rows], c_sf[rows])
        prev = (states[-1] if states else None,) if warm_chain else ()
        state = _seg(_seg_chunk_start, prev, data, opts=opts, kset=kset, dtype=dtype)
        states.append(_run_narrow_phase(*data, state, opts, kset, dtype, tol, cap))
    # every still-RUNNING lane's chunk ran to exactly `cap` (an early-
    # exiting chunk has no running lanes), so stage 2 resumes at k = cap
    sflat = _seg(_seg_concat, tuple(states), (), k=cap)
    del states

    # ---- stage 2: compact the narrow tail, resume with full budget ----
    sflat = _compact_resume(ctx, b_sf, c_sf, sflat, opts, kset, dtype, tol, opts.maxiter, bucket)
    if keys is None:
        return sflat
    return _seg(_seg_package, (sflat, scaling, c_flat_w), (ctx, b_sf, c_sf), kset=kset,
                opts=opts, keys=keys, dtype=dtype)


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

    Between the host's reads (the IPM loops' predicates, the drain rounds'
    loop predicate and the reference's ``lax.cond`` predicates) the code
    runs as segments (:func:`_seg`).

    ``truncate`` ("pre", "stage3", "tier0" or "tier1"; the reference's
    ``PYCLLP_FINISH_TRUNCATE``) returns the packaged outputs right after
    the named stage, to split the finish's cost.
    """
    dtype, wide = _scan_dtypes(A, b3, c3, opts)
    fkset = kset.finish_kernels(opts.finish_kset)
    ckset = _crossover_kset(kset, fkset, opts)
    scaling, ctx, fctx, cctx, b_sfw, c_sfw, c_flat_w = _seg(
        _seg_finish_prologue, (_on(A, dev), b3, c3), (), borrow=True, opts=opts, kset=kset,
        fkset=fkset, ckset=ckset, dtype=dtype, wide=wide)
    cctx = fctx if cctx is None else cctx
    K = b3.shape[0]
    N = b_sfw.shape[0]
    wopts = _wide_opts(opts)
    fdata = (fctx, b_sfw, c_sfw)

    def packaged(s):
        return _package_bucketed(fctx, b_sfw, c_sfw, s, fkset, opts, scaling, c_flat_w,
                                 finish_bucket, tuple(keys))

    start = dict(kset=kset, dtype=dtype, wide=wide)
    if truncate == "pre":
        return packaged(_seg(_seg_finish_start, (sflat,), (ctx, b_sfw, c_sfw), reopen=False,
                             **start))

    # ---- stage 3: wide finish over ALL lanes, chunk by chunk ----
    if opts.finish_mode == "crossover":
        # ONE basis solve per lane: accepted lanes are OPTIMAL outright;
        # rejects re-open RUNNING and fall through to the drain tiers
        sflat = _seg(_seg_stage3_crossover, (sflat,), (ctx, cctx, b_sfw, c_sfw), ckset=ckset,
                     opts=opts, K=K, **start)
        base_k = 0
    else:
        sflat = _seg(_seg_finish_start, (sflat,), (ctx, b_sfw, c_sfw), reopen=True, **start)
        chunk = N // K
        parts = []
        for kk in range(K):  # each from k = 0
            rows = slice(kk * chunk, (kk + 1) * chunk)
            parts.append(_run_phase(fctx, b_sfw[rows], c_sfw[rows], _take(sflat, rows), wopts,
                                    fkset, wide, opts.tol, finish_cap))
        base_k = finish_cap
        sflat = _seg(_seg_concat, tuple(parts), (), k=base_k)
        del parts
    if truncate == "stage3":
        return packaged(sflat)

    if opts.finish_mode == "crossover":
        # ---- stage 4 (crossover): bounded draining rounds ----
        # tier 0: basis-repair rounds on the gathered rejects, mixed engine
        if opts.crossover_repair:  # without repair a re-cross of the
            # unchanged state would re-fail identically — skip the tier
            width = min(max(16384, 8 * finish_bucket), N)
            sflat = _drain(sflat, rounds, lambda s, treated: _seg(
                _seg_tier0_round, (s, treated), (cctx, b_sfw, c_sfw), width=width, opts=opts,
                ckset=ckset))
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
        def tier1(s, treated):
            st2, b2, c2, idx, resumed, budget = _seg(
                _seg_tier_gather, (s, treated), fdata, width=finish_bucket, budget=finish_cap)
            st2 = _run_phase(fctx, b2, c2, st2, wopts, fkset, wide, opts.tol, budget)
            return _seg(_seg_tier_scatter, (s, treated, st2, idx, resumed), fdata, fkset=fkset,
                        topts=topts, reopen=True)

        sflat = _drain(sflat, rounds, tier1)
        if truncate == "tier1":
            return packaged(sflat)

        # tier 2: narrow, deep — IPM to budget, restart, rescue.
        # reopen=False in the rescue keeps rejects STALLED, so each lane
        # gets the deep treatment exactly once
        def tier2(s, treated):
            st2, b2, c2, idx, resumed, budget = _seg(
                _seg_tier_gather, (s, treated), fdata, width=256, budget=opts.finish_maxiter)
            st2 = _run_phase(fctx, b2, c2, st2, wopts, fkset, wide, opts.tol, budget)
            if opts.finish_restart:
                st2 = _seg(_seg_tier_restart, (st2,), (fctx, b2, c2), opts=opts, fkset=fkset,
                           wide=wide)
                st2 = _run_phase(
                    fctx, b2, c2, st2, wopts.replace(stall_patience=_NO_STALL), fkset, wide,
                    opts.tol, opts.finish_maxiter + 10,
                )
            return _seg(_seg_tier_scatter, (s, treated, st2, idx, resumed), fdata, fkset=fkset,
                        topts=topts, reopen=False)

        sflat = _drain(sflat, rounds, tier2)
    else:
        # ---- stage 4 (ipm): two gated compact rounds.  A tail larger
        # than the bucket overflows round 1 — those lanes stay RUNNING and
        # round 2 gathers them; round 2 doubles as the fresh-restart
        # fallback for STALLED/NUMERICAL lanes.  Each round's budget
        # extends past the previous round's endpoint (k is shared). ----
        if _loop._read((sflat.status == _RUNNING).any()):
            sflat = _compact_resume(
                fctx, b_sfw, c_sfw, sflat, wopts, fkset, wide, opts.tol,
                base_k + opts.finish_maxiter, finish_bucket,
            )
        if _loop._read(_retry_mask(sflat.status).any()):
            sflat = _compact_resume(
                fctx, b_sfw, c_sfw, sflat, wopts, fkset, wide, opts.tol,
                base_k + 2 * opts.finish_maxiter, finish_bucket,
                restart=opts.finish_restart,
            )
    if any(k in ("rho_p", "rho_d", "rho_gap") for k in keys):
        return _seg(_seg_package, (sflat, scaling, c_flat_w), (fctx, b_sfw, c_sfw), kset=fkset,
                    opts=opts, keys=tuple(keys), dtype=wide)
    # ρ diagnostics not requested → finalize/classify only the gathered
    # non-terminal remainder (see _package_bucketed)
    return packaged(sflat)


def _seg_finish_start(state, data, *, kset, dtype, wide, reopen):
    """The finish's start: the narrow state folded to its best iterates,
    cast to ``wide``, its loop counter and best trackers reset; with
    ``reopen`` (the wide IPM's stage 3) every lane not NUMERICAL RUNNING."""
    (sflat,) = state
    ctx, b_sfw, c_sfw = data
    sflat = _fold_to_best(ctx, b_sfw.to(dtype), c_sfw.to(dtype), sflat, kset)
    sflat = _cast_state(sflat, wide)
    sflat = sflat._replace(
        k=torch.zeros_like(sflat.k),
        best_score=torch.full_like(sflat.best_score, torch.finfo(wide).max),
        best_k=torch.zeros_like(sflat.best_k),
    )
    if reopen:
        sflat = sflat._replace(
            status=torch.where(sflat.status != _NUMERICAL, _RUNNING, sflat.status)
        )
    return sflat


def _seg_stage3_crossover(state, data, *, kset, dtype, wide, ckset, opts, K):
    """The finish's start and stage 3 in crossover mode: one basis solve per
    lane, chunk by chunk.  Repair is 0 here: tier 0 applies
    ``opts.crossover_repair`` to the GATHERED rejects instead (same math, a
    fraction of the width)."""
    ctx, cctx, b_sfw, c_sfw = data
    sflat = _seg_finish_start(state, (ctx, b_sfw, c_sfw), kset=kset, dtype=dtype, wide=wide,
                              reopen=False)
    s3_opts = opts.replace(crossover_repair=0)
    chunk = b_sfw.shape[0] // K
    parts = []
    for kk in range(K):
        rows = slice(kk * chunk, (kk + 1) * chunk)
        parts.append(_crossover_state(cctx, b_sfw[rows], c_sfw[rows], _take(sflat, rows), ckset,
                                      s3_opts, opts.tol))
    return _seg_concat(tuple(parts), (), k=0)


def _drain(s, n_rounds: int, round_):
    """Bounded rounds of [gather → treat → scatter] over the RUNNING lanes,
    each lane treated AT MOST ONCE: a lane still RUNNING after a full tier
    treatment is masked out of later rounds.  Rounds repeat only to drain
    reject VOLUME beyond one bucket; the loop ends as soon as no untreated
    lane is RUNNING.  ``round_(s, treated)`` returns the new ``(s,
    treated)`` and the next round's predicate, which the host reads (the
    reference's ``round_cond``)."""
    treated = torch.zeros_like(s.status, dtype=torch.bool)
    more = (s.status == _RUNNING).any()
    for _ in range(n_rounds):
        if not _loop._read(more):
            break
        s, treated, more = round_(s, treated)
    return s


def _round_end(s, st2, treated, idx, resumed):
    """A drain round's end: ``st2`` scattered back over ``s[idx]`` where
    ``resumed``, those lanes marked treated, and the next round's
    predicate."""
    treated = treated.clone()
    treated[idx] = treated[idx] | resumed
    s = _scatter(s, st2, idx, resumed)
    return s, treated, ((s.status == _RUNNING) & ~treated).any()


def _gather_round(s, treated, width: int):
    """A drain round's gather: up to ``width`` untreated RUNNING lanes."""
    unfinished = (s.status == _RUNNING) & ~treated
    idx = _first_lanes(unfinished, width)
    return _take(s, idx), idx, unfinished[idx]


def _seg_tier0_round(state, data, *, width, opts, ckset):
    """A tier-0 round: basis-repair crossover on the gathered rejects."""
    s, treated = state
    cctx, b, c = data
    st2, idx, resumed = _gather_round(s, treated, width)
    st2 = _crossover_state(cctx, b[idx], c[idx], st2, ckset, opts, opts.tol)
    return _round_end(s, st2, treated, idx, resumed)


def _seg_tier_gather(state, data, *, width, budget):
    """A wide tier round's gather, before its IPM: the gathered state with
    its stall clock at ``k``, its ``b`` and ``c``, the lanes, which of them
    resume, and the IPM's budget ``k + budget``."""
    s, treated = state
    _, b, c = data
    st2, idx, resumed = _gather_round(s, treated, width)
    st2 = st2._replace(best_k=_best_k_at(st2))
    return st2, b[idx], c[idx], idx, resumed, st2.k + budget


def _seg_tier_restart(state, data, *, opts, fkset, wide):
    """Tier 2 between its phases: the STALLED/NUMERICAL lanes restarted
    from a cold Mehrotra start."""
    (st2,) = state
    fctx, b2, c2 = data
    stuck = (st2.status == _STALLED) | (st2.status == _NUMERICAL)
    fresh = _fresh_state(fctx, b2, c2, opts.replace(init_point="mehrotra"), fkset, wide)
    return _restart_merge(st2, fresh, stuck)


def _seg_tier_scatter(state, data, *, fkset, topts, reopen):
    """A wide tier round's end, after its IPM: fold to the best iterates,
    the wide crossover, the scatter."""
    s, treated, st2, idx, resumed = state
    fctx, b, c = data
    b2, c2 = b[idx], c[idx]
    st2 = _fold_to_best(fctx, b2, c2, st2, fkset)
    st2 = _crossover_state(fctx, b2, c2, st2, fkset, topts, topts.tol, reopen=reopen)
    return _round_end(s, st2, treated, idx, resumed)


@_loop._spanned("hsd_solve_scan")
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
    stderr (the reference's ``PYCLLP_SCAN_SYNC``).  The stages are marked
    ``narrow stage`` and ``finish stage`` for the profiler either way.
    """
    if getattr(A, "ndim", 2) != 2:
        raise ValueError("hsd_solve_scan requires shared 2-D A")
    dev = resolve_device(device)
    PREPARED_BYTES.clear()
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
            with torch.profiler.record_function("narrow stage"):
                res = _hsd_scan_narrow_core(
                    A, b3, c3, opts, kset, keys, int(compact_cap),
                    min(int(compact_bucket), K * chunk), dev, bool(warm_chain),
                )
        else:
            _check_finish_levels(kset, opts, A)
            phase1_tol = max(opts.tol, opts.switch_tol)
            t0 = time.perf_counter()
            with torch.profiler.record_function("narrow stage"):
                sflat = _hsd_scan_narrow_core(
                    A, b3, c3, _narrow_opts_view(opts, phase1_tol), kset, None,
                    int(compact_cap), min(int(compact_bucket), K * chunk), dev,
                    bool(warm_chain),
                )
            if stage_sync:
                _sync(dev)
                running = int((sflat.status == _RUNNING).sum())
                print(f"[scan] narrow stage: {time.perf_counter() - t0:.3f}s "
                      f"(sync; {running} lanes still RUNNING)", file=sys.stderr, flush=True)
                t0 = time.perf_counter()
            fb = min(int(finish_bucket or compact_bucket), K * chunk)
            with torch.profiler.record_function("finish stage"):
                res = _hsd_scan_finish_core(
                    A, b3, c3, sflat, _finish_opts_view(opts), kset, keys, int(finish_cap), fb,
                    dev,
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
