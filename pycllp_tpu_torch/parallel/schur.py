"""Column-sharded HSD for LPs larger than one device — batched.

Counterpart of :mod:`pycllp_tpu.parallel.schur`.  The variables (columns
of A) partition across the ranks of a model mesh: each rank holds
``A_loc (m, n/P)`` and its shards of x/z/c, while y/b and the m×m normal
matrix are the same on every rank.  A leading batch axis carries small
batches of big LPs (shared A, per-instance b/c).  Per iteration:

* ``M_b = Σ_p A_p D_{b,p} A_pᵀ`` — the local Gram matrices summed with ONE
  ``all_reduce(SUM)`` (the only collective of the factor);
* the Cholesky factor and its triangular solves run on the replicated
  (B, m, m) M on every rank (``factor="replicated"``), or on M's row
  blocks across the ranks (``factor="sharded"``,
  :mod:`pycllp_tpu_torch.parallel.dchol`);
* ``A@x`` all-reduces; ``Aᵀy`` is local; dot products and the ratio test
  reduce with SUM/MIN.

The accuracy playbook of the batched path is the reference's: Ruiz
equilibration of A (on every rank, folded into b/c), Mehrotra's
least-squares start, per-lane best-iterate tracking with a stall clock,
iterative refinement of each normal-equations solve in f32, and an
optional WIDE FINISH phase (``opts.finish_dtype``) that continues the
same sharded state in the wide dtype to the full ``opts.tol``.

What differs from the reference: its ``lax.while_loop`` is a host loop
here, one per rank.  The reference's predicate is replicated by
construction; the port's goes through one ``all_reduce(MAX)`` of the
any-running flag (:class:`pycllp_tpu_torch.parallel.CollectiveAny`), so
every rank leaves on the same iteration whatever its own reading, and
``k < maxiter`` (the same on every rank) is tested first.  The replicated
factor is ``torch.linalg.cholesky_ex`` with failed lanes set to NaN, as
``lax.linalg.cholesky`` answers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pycllp_tpu_torch.parallel.collectives import all_gather, make_mesh, pmax, pmin, psum
from pycllp_tpu_torch.parallel.dchol import cholesky_nan, rowshard_cholesky, rowshard_cholesky_solve
from pycllp_tpu_torch.parallel.shard import CollectiveAny
from pycllp_tpu_torch.solvers.hsd import (
    _finish_dtype,
    _full_precision_matmuls,
    _require_ported,
    _resolve_dtype,
    _to,
)
from pycllp_tpu_torch.solvers.options import SolverOptions, Status
from pycllp_tpu_torch.utils.device import resolve_device
from pycllp_tpu_torch.utils.scaling import ruiz_equilibrate, scale_problem

__all__ = ["column_sharded_hsd_solve", "model_mesh"]

_RUNNING = int(Status.RUNNING)
_OPTIMAL = int(Status.OPTIMAL)
_INFEASIBLE = int(Status.INFEASIBLE)
_UNBOUNDED = int(Status.UNBOUNDED)
_NUMERICAL = int(Status.NUMERICAL)
_STALLED = int(Status.STALLED)
_ITERATION_LIMIT = int(Status.ITERATION_LIMIT)


def model_mesh(n_devices: int | None = None, axis: str = "model"):
    """1-D mesh named ``"model"`` over the ranks of the default group."""
    return make_mesh(n_devices, axis)


class ColState(NamedTuple):
    x: torch.Tensor  # (B, n_loc)
    y: torch.Tensor  # (B, m) replicated
    z: torch.Tensor  # (B, n_loc)
    tau: torch.Tensor  # (B,)
    kappa: torch.Tensor  # (B,)
    status: torch.Tensor  # (B,) int32
    iterations: torch.Tensor  # (B,) int32
    k: int  # loop counter (host int, the same on every rank)
    rp0: torch.Tensor  # (B,) relative-indicator normalizers
    rd0: torch.Tensor
    rg0: torch.Tensor
    mu0: torch.Tensor
    best_x: torch.Tensor  # best-iterate insurance (f32 floor behaviour)
    best_y: torch.Tensor
    best_z: torch.Tensor
    best_tau: torch.Tensor
    best_kappa: torch.Tensor
    best_score: torch.Tensor
    best_k: torch.Tensor


class _Ops(NamedTuple):
    """The sharded linear operations of one dtype."""

    mv: object  # A @ x → (B, m), the same on every rank
    rmv: object  # Aᵀ y → this rank's (B, n_loc) shard
    pdot: object  # (B,) dot of column-sharded vectors
    dnorm: object  # (B,) 2-norm of column-sharded vectors
    make_factor: object  # dinv → msolve


def column_sharded_hsd_solve(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    mesh=None,
    factor: str = "replicated",
    *,
    device="cuda",
):
    """Solve a (batch of) equality-form LP(s) ``min cᵀx, Ax=b, x≥0`` with
    columns sharded over the mesh.  ``n`` must divide by the mesh size
    (the registry's ``schur`` solver pads).

    ``A`` is the whole (m, n) on every rank; ``b``/``c`` may be ``(m,)``/
    ``(n,)`` (single LP) or ``(B, m)``/``(B, n)``.  Returns dict(x, z, y,
    objective, status, iterations) of tensors on ``device``, x/z gathered
    over the columns, the batch axis matching the input.  Every rank of
    the mesh calls this together.

    ``opts.finish_dtype`` enables the wide finish: phase 1 runs in
    ``opts.dtype`` to ``opts.switch_tol``, then the SAME sharded state
    continues in the wide dtype to ``opts.tol`` with ``opts.finish_maxiter``
    more iterations.

    ``factor``: ``"replicated"`` (default) all-reduces the full (B, m, m)
    M and factors it on every rank — right for m ≪ n; ``"sharded"``
    partitions M's ROWS over the ranks and factors it with the blocked
    row-sharded Cholesky (per-rank memory O(B·m²/P); needs ``m`` divisible
    by the mesh size).
    """
    if mesh is None:
        mesh = model_mesh()
    n_dev = mesh.size()
    m, n = A.shape
    if n % n_dev:
        raise ValueError(f"n={n} not divisible by mesh size {n_dev}")
    if factor not in ("replicated", "sharded"):
        raise ValueError(f"unknown factor strategy {factor!r}")
    if factor == "sharded" and m % n_dev:
        raise ValueError(f"factor='sharded' needs m={m} divisible by {n_dev}")
    dev = resolve_device(device)
    with _full_precision_matmuls():
        out = _solve(A, b, c, opts, mesh, factor, dev)
    return out


def _solve(A, b, c, opts, mesh, factor, dev):
    n_dev = mesh.size()
    my = mesh.get_local_rank()
    m, n = A.shape
    dtype = _resolve_dtype(opts, A, b, c)
    _require_ported(opts, dtype)
    fdtype = _finish_dtype(opts, dtype)
    wide = fdtype or dtype
    # scaling and the wide-phase data derive from the ORIGINAL inputs in
    # the WIDE dtype; phase 1 sees rounded copies (the batched path's rule)
    A_w = _to(A, wide, dev)
    b_w = _to(b, wide, dev)
    c_w = _to(c, wide, dev)
    squeeze = b_w.dim() == 1
    if squeeze:
        b_w, c_w = b_w[None], c_w[None]
    if opts.scale:
        scaling = ruiz_equilibrate(A_w)
        A_sw, b_sw, c_sw = scale_problem(A_w, b_w, c_w, scaling)
        col_scale, row_scale = scaling.col, scaling.row
    else:
        A_sw, b_sw, c_sw = A_w, b_w, c_w
        col_scale = torch.ones((n,), dtype=wide, device=dev)
        row_scale = torch.ones((m,), dtype=wide, device=dev)
    cols = slice(my * (n // n_dev), (my + 1) * (n // n_dev))
    A_lw, c_lw, col_l, b_rw = A_sw[:, cols], c_sw[:, cols], col_scale[cols], b_sw
    B = b_rw.shape[0]
    phase1_tol = max(opts.tol, opts.switch_tol) if fdtype else opts.tol
    any_running = CollectiveAny(mesh)

    def make_ops(A_l) -> _Ops:
        dt = A_l.dtype
        reg_eps = opts.resolved_reg_eps(dt)
        refine = opts.resolved_refine_steps(dt)

        def mv(x_l):
            return psum(x_l @ A_l.T, mesh)

        def rmv(y_r):
            return y_r @ A_l

        def pdot(u_l, v_l):
            return psum((u_l * v_l).sum(-1), mesh)

        def dnorm(v_l):
            return psum((v_l * v_l).sum(-1), mesh).sqrt()

        def gram(A_rows, dinv):
            """Σ over ranks of A_rows·diag(dinv)·A_lᵀ → (B, rows, m)."""
            return psum((A_rows * dinv[:, None, :]) @ A_l.T, mesh)

        def make_factor(dinv):
            """Factor M = A·diag(dinv)·Aᵀ + δI → msolve."""
            if factor == "sharded":
                mb = m // n_dev
                mine = torch.arange(my * mb, (my + 1) * mb, device=dev)
                emask = (torch.arange(m, device=dev)[None, :] == mine[:, None]).to(dt)
                Mw = None
                for i in range(n_dev):
                    Gi = gram(A_l[i * mb:(i + 1) * mb], dinv)
                    if i == my:
                        Mw = Gi
                dloc = torch.einsum("bam,am->ba", Mw, emask)
                reg = reg_eps * pmax(dloc.amax(dim=-1), mesh)
                Mw = Mw + reg[:, None, None] * emask[None]
                Lw, kks = rowshard_cholesky(Mw, mesh, n_dev)

                def fsolve(r):
                    return rowshard_cholesky_solve(Lw, kks, r, mesh, n_dev)

            else:
                M = gram(A_l, dinv)
                reg = reg_eps * torch.diagonal(M, dim1=-2, dim2=-1).amax(dim=-1)
                M = M + reg[:, None, None] * torch.eye(m, dtype=dt, device=dev)
                L = cholesky_nan(M)

                def fsolve(r):
                    t = torch.linalg.solve_triangular(L, r[..., None], upper=False)
                    return torch.linalg.solve_triangular(L.mT, t, upper=True)[..., 0]

            def matvec_M(v):
                return mv(dinv * rmv(v)) + reg[:, None] * v

            def msolve(r):
                v = fsolve(r)
                for _ in range(refine):  # f32 insurance (dtype-resolved)
                    v = v + fsolve(r - matvec_M(v))
                return v

            return msolve

        return _Ops(mv, rmv, pdot, dnorm, make_factor)

    def residuals(ops, b_r, c_l, s):
        rp = b_r * s.tau[:, None] - ops.mv(s.x)
        rd = c_l * s.tau[:, None] - ops.rmv(s.y) - s.z
        rg = ops.pdot(c_l, s.x) - (b_r * s.y).sum(-1) + s.kappa
        mu = (ops.pdot(s.x, s.z) + s.tau * s.kappa) / (n + 1)
        return rp, rd, rg, mu

    def indicators(ops, b_r, s, rp, rd, rg):
        by = (b_r * s.y).sum(-1)
        rho_p = torch.linalg.vector_norm(rp, dim=-1) / s.rp0
        rho_d = ops.dnorm(rd) / s.rd0
        rho_g = rg.abs() / s.rg0
        rho_A = (rg - s.kappa).abs() / (s.tau + by.abs())
        return by, rho_p, rho_d, rho_g, rho_A

    def classify(ops, b_r, s, rp, rd, rg, mu, tol):
        by, rho_p, rho_d, rho_g, rho_A = indicators(ops, b_r, s, rp, rd, rg)
        optimal = (rho_p <= tol) & (rho_d <= tol) & (rho_A <= tol)
        inf1 = (
            (rho_p <= tol) & (rho_d <= tol) & (rho_g <= tol)
            & (s.tau <= tol * s.kappa.clamp(min=1.0))
        )
        inf2 = (mu / s.mu0 <= tol) & (s.tau <= tol * s.kappa.clamp(max=1.0))
        infs = torch.where(by > tol, _INFEASIBLE, _UNBOUNDED).to(torch.int32)
        running = s.status == _RUNNING
        return torch.where(
            running & optimal,
            _OPTIMAL,
            torch.where(running & (inf1 | inf2), infs, s.status),
        ).to(torch.int32)

    def score_of(ops, b_r, c_l, s):
        rp, rd, rg, mu = residuals(ops, b_r, c_l, s)
        _, rho_p, rho_d, _, rho_A = indicators(ops, b_r, s, rp, rd, rg)
        return torch.maximum(torch.maximum(rho_p, rho_d), rho_A)

    def max_step(x, dx, z, dz, tau, dtau, kappa, dkappa):
        big = torch.finfo(x.dtype).max

        def ratios(v, dv):
            return torch.where(dv < 0, v / torch.where(dv < 0, -dv, 1.0), big)

        a = pmin(torch.minimum(ratios(x, dx).amin(dim=-1), ratios(z, dz).amin(dim=-1)), mesh)
        a = torch.minimum(a, ratios(tau, dtau))
        return torch.minimum(a, ratios(kappa, dkappa))

    def mehrotra_start(ops, b_r, c_l):
        """Least-squares start (sharded twin of hsd._mehrotra_start)."""
        msolve0 = ops.make_factor(torch.ones_like(c_l))
        x_hat = ops.rmv(msolve0(b_r))
        y_hat = msolve0(ops.mv(c_l))
        z_hat = c_l - ops.rmv(y_hat)

        def gmin(v):
            return pmin(v.amin(dim=-1), mesh)

        dx = (-1.5 * gmin(x_hat)).clamp(min=0.0)[:, None]
        dz = (-1.5 * gmin(z_hat)).clamp(min=0.0)[:, None]
        xs = x_hat + dx
        zs = z_hat + dz
        dot = ops.pdot(xs, zs)
        sum_z = psum(zs.sum(-1), mesh).clamp(min=1e-8)
        sum_x = psum(xs.sum(-1), mesh).clamp(min=1e-8)
        x0 = (xs + (0.5 * dot / sum_z)[:, None]).clamp(min=1e-4)
        z0 = (zs + (0.5 * dot / sum_x)[:, None]).clamp(min=1e-4)
        return x0, y_hat, z0

    def fresh_state(ops, b_r, c_l):
        dt = c_l.dtype
        if opts.init_point == "mehrotra":
            x0, y0, z0 = mehrotra_start(ops, b_r, c_l)
        else:
            x0 = torch.ones_like(c_l)
            y0 = torch.zeros_like(b_r)
            z0 = torch.ones_like(c_l)
        ones = torch.ones((B,), dtype=dt, device=dev)
        izeros = torch.zeros((B,), dtype=torch.int32, device=dev)
        s = ColState(
            x0, y0, z0, ones, ones, torch.full_like(izeros, _RUNNING), izeros, 0,
            ones, ones, ones, ones,
            x0, y0, z0, ones, ones,
            torch.full((B,), torch.finfo(dt).max, dtype=dt, device=dev), izeros,
        )
        rp, rd, rg, mu = residuals(ops, b_r, c_l, s)
        return s._replace(
            rp0=torch.linalg.vector_norm(rp, dim=-1).clamp(min=1.0),
            rd0=ops.dnorm(rd).clamp(min=1.0),
            rg0=rg.abs().clamp(min=1.0),
            mu0=mu,
        )

    def step(ops, b_r, c_l, s, tol, patience):
        rp, rd, rg, mu = residuals(ops, b_r, c_l, s)
        status = classify(ops, b_r, s, rp, rd, rg, mu, tol)
        running = status == _RUNNING

        # best-iterate bookkeeping + stall clock (hsd twin)
        score = score_of(ops, b_r, c_l, s)
        was_running = (s.status == _RUNNING) & torch.isfinite(score)
        improved = was_running & (score < s.best_score)
        imn = improved[:, None]
        best_x = torch.where(imn, s.x, s.best_x)
        best_y = torch.where(imn, s.y, s.best_y)
        best_z = torch.where(imn, s.z, s.best_z)
        best_tau = torch.where(improved, s.tau, s.best_tau)
        best_kappa = torch.where(improved, s.kappa, s.best_kappa)
        best_score = torch.where(improved, score, s.best_score)
        if opts.stall_rtol:
            material = was_running & (score < s.best_score * (1.0 - opts.stall_rtol))
        else:
            material = improved
        best_k = torch.where(material, s.k, s.best_k).to(torch.int32)
        stalled = running & (s.k - best_k >= patience)
        status = torch.where(stalled, _STALLED, status).to(torch.int32)

        # capped at 1e30, as hsd._make_step_fn
        dinv = torch.clamp(s.x / s.z, max=1e30)  # (B, n_loc)
        msolve = ops.make_factor(dinv)
        mv, rmv, pdot = ops.mv, ops.rmv, ops.pdot

        def sym_solve(r1_l, r2_r):
            v = msolve(r2_r + mv(dinv * r1_l))
            u = dinv * (rmv(v) - r1_l)
            return u, v

        p, q = sym_solve(c_l, b_r)
        denom = s.kappa / s.tau + (b_r * q).sum(-1) - pdot(c_l, p)

        def newton(eta, gmu, dxa, dza, dta, dka):
            rxs = gmu[:, None] - s.x * s.z - dxa * dza
            rtk = gmu - s.tau * s.kappa - dta * dka
            r1 = eta[:, None] * rd - rxs / s.x
            u, v = sym_solve(r1, eta[:, None] * rp)
            dtau = (eta * rg + rtk / s.tau - ((b_r * v).sum(-1) - pdot(c_l, u))) / denom
            dx = u + p * dtau[:, None]
            dy = v + q * dtau[:, None]
            dz = (rxs - s.z * dx) / s.x
            dkappa = (rtk - s.kappa * dtau) / s.tau
            return dx, dy, dz, dtau, dkappa

        zero_l = torch.zeros_like(s.x)
        zero = torch.zeros_like(s.tau)
        one = torch.ones_like(s.tau)
        dxa, dya, dza, dta, dka = newton(one, zero, zero_l, zero_l, zero, zero)
        a_aff = max_step(s.x, dxa, s.z, dza, s.tau, dta, s.kappa, dka).clamp(max=1.0)
        aan = a_aff[:, None]
        mu_aff = (
            pdot(s.x + aan * dxa, s.z + aan * dza)
            + (s.tau + a_aff * dta) * (s.kappa + a_aff * dka)
        ) / (n + 1)
        gamma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
        dx, dy, dz, dtau, dkappa = newton(1.0 - gamma, gamma * mu, dxa, dza, dta, dka)
        alpha = (opts.alpha0 * max_step(s.x, dx, s.z, dz, s.tau, dtau, s.kappa, dkappa)).clamp(
            max=1.0)

        an = alpha[:, None]
        xn = s.x + an * dx
        yn = s.y + an * dy
        zn = s.z + an * dz
        taun = s.tau + alpha * dtau
        kappan = s.kappa + alpha * dkappa
        nonfinite = psum(
            (~torch.isfinite(xn)).sum(-1, dtype=torch.int32)
            + (~torch.isfinite(zn)).sum(-1, dtype=torch.int32),
            mesh,
        )
        finite = (nonfinite == 0) & torch.isfinite(taun) & (taun > 0)
        status = torch.where((status == _RUNNING) & ~finite, _NUMERICAL, status).to(torch.int32)
        take = status == _RUNNING
        tn = take[:, None]
        return s._replace(
            x=torch.where(tn, xn, s.x),
            y=torch.where(tn, yn, s.y),
            z=torch.where(tn, zn, s.z),
            tau=torch.where(take, taun, s.tau),
            kappa=torch.where(take, kappan, s.kappa),
            status=status,
            iterations=torch.where(take, s.iterations + 1, s.iterations),
            k=s.k + 1,
            best_x=best_x, best_y=best_y, best_z=best_z, best_tau=best_tau,
            best_kappa=best_kappa, best_score=best_score, best_k=best_k,
        )

    def run_phase(ops, b_r, c_l, s, tol, maxiter, patience):
        # k < maxiter first: k is the same on every rank, so every rank
        # reaches the collective any-running test on the same iteration
        while s.k < maxiter and any_running(s.status == _RUNNING):
            s = step(ops, b_r, c_l, s, tol, patience)
        return s

    def fold_to_best(ops, b_r, c_l, s):
        score = score_of(ops, b_r, c_l, s)
        sb = s._replace(x=s.best_x, y=s.best_y, z=s.best_z, tau=s.best_tau, kappa=s.best_kappa)
        score_b = score_of(ops, b_r, c_l, sb)
        use_best = ~torch.isfinite(score) | (torch.isfinite(score_b) & (score_b < score))
        ubn = use_best[:, None]
        return s._replace(
            x=torch.where(ubn, s.best_x, s.x),
            y=torch.where(ubn, s.best_y, s.y),
            z=torch.where(ubn, s.best_z, s.z),
            tau=torch.where(use_best, s.best_tau, s.tau),
            kappa=torch.where(use_best, s.best_kappa, s.kappa),
        )

    # ---- phase 1 (narrow) ----
    A_l1, b_r1, c_l1 = A_lw.to(dtype), b_rw.to(dtype), c_lw.to(dtype)
    ops1 = make_ops(A_l1)
    s = fresh_state(ops1, b_r1, c_l1)
    s = run_phase(ops1, b_r1, c_l1, s, phase1_tol, opts.maxiter, opts.stall_patience)

    if fdtype:
        # ---- phase 2 (wide): continue the SAME sharded state ----
        s = fold_to_best(ops1, b_r1, c_l1, s)
        s = ColState(*[v.to(wide) if isinstance(v, torch.Tensor) and v.is_floating_point()
                       else v for v in s])
        ops2 = make_ops(A_lw)
        s = s._replace(
            status=torch.where(s.status != _NUMERICAL, _RUNNING, s.status).to(torch.int32),
            best_score=torch.full_like(s.best_score, torch.finfo(wide).max),
            best_k=torch.full_like(s.best_k, s.k),
        )
        s = run_phase(ops2, b_rw, c_lw, s, opts.tol, opts.maxiter + opts.finish_maxiter,
                      opts.finish_patience)
        ops_f, b_rf, c_lf = ops2, b_rw, c_lw
    else:
        ops_f, b_rf, c_lf = ops1, b_r1, c_l1

    # ---- finalize on the best iterate ----
    s = fold_to_best(ops_f, b_rf, c_lf, s)
    rp, rd, rg, mu = residuals(ops_f, b_rf, c_lf, s)
    stalled = s.status == _STALLED
    numerical = s.status == _NUMERICAL
    status_open = torch.where(stalled | numerical, _RUNNING, s.status).to(torch.int32)
    status = classify(ops_f, b_rf, s._replace(status=status_open), rp, rd, rg, mu, opts.tol)
    still_open = torch.where(stalled, _STALLED, torch.where(numerical, _NUMERICAL,
                                                             _ITERATION_LIMIT))
    status = torch.where(status == _RUNNING, still_open, status).to(torch.int32)
    out_dt = s.x.dtype
    tau = s.tau.clamp(min=torch.finfo(out_dt).tiny)[:, None]
    # unscale (x̂ = s_col·x̃, ŷ = s_row·ỹ, ẑ = z̃/s_col) and report the
    # objective against the ORIGINAL c (c̃ᵀx̃ = cᵀx)
    col = col_l.to(out_dt)[None, :]
    out = {
        "x": all_gather(s.x / tau * col, mesh, dim=1),
        "z": all_gather(s.z / tau / col, mesh, dim=1),
        "y": s.y / tau * row_scale.to(out_dt)[None, :],
        "objective": psum((c_lw.to(out_dt) * (s.x / tau)).sum(-1), mesh),
        "status": status,
        "iterations": s.iterations,
    }
    if squeeze:
        out = {k: v[0] for k, v in out.items()}
    return out
