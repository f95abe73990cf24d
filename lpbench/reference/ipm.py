"""The plain reference that decides ``correct``: a batched primal-dual
interior-point method (Mehrotra's predictor-corrector) in float64 NumPy.

It solves the equality form ``min cᵀx  s.t.  Ax = b, x ≥ 0`` of each lane
from the inputs the benchmark made, independently of the program: no
import of the program, nothing it derived (scaling, prepared factors,
starting points).  Every lane of the benchmark's generators has a finite
optimum (a strictly feasible primal and dual point is planted), so a lane
that does not converge here is a failure of the reference, reported as
such, never a verdict on the program.

The iteration is the textbook one (Wright, *Primal-Dual Interior-Point
Methods*, ch. 10; Mehrotra 1992): normal equations ``A D Aᵀ`` with
``D = X S⁻¹``, separate primal and dual step lengths, and Mehrotra's
starting point.  It stops a lane when the relative primal and dual
residuals and the relative duality gap are all below ``tol``, so the
objective it returns is within about ``tol`` of the optimum, relative to
``max(1, |objective|)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["solve"]


def _normal(A, d):
    """``A diag(d) Aᵀ`` per lane: (B, m, m)."""
    return np.matmul(A[None] * d[:, None, :], A.T[None])


def _solve(M, r):
    return np.linalg.solve(M, r[..., None])[..., 0]


def _step(v, dv, frac: float = 1.0):
    """``min(1, frac · α_max)`` per lane, α_max the largest α with
    ``v + α dv ≥ 0``."""
    ratio = np.where(dv < 0, -v / np.where(dv < 0, dv, -1.0), np.inf)
    return np.minimum(1.0, frac * ratio.min(axis=1))


def solve(A, b, c, tol: float = 1e-11, accept: float = 1e-9, maxiter: int = 60,
          patience: int = 5) -> dict:
    """Solve ``min cᵀx, Ax = b, x ≥ 0`` for every lane, in float64.

    ``A`` (m, n) is shared by the lanes; ``b`` is (B, m) and ``c`` (B, n).
    A lane stops at a merit of ``tol``, after ``patience`` iterations
    without a better one, or at ``maxiter``; it has converged when its best
    merit is at most ``accept``.  Returns ``objective`` (B,; at the
    certified vertex where there is one, else at the best iterate),
    ``merit`` (B,), ``certified`` (B,) bool, ``converged`` (B,) bool (a
    certified vertex or a merit of at most ``accept``) and ``iterations``
    (B,).
    """
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    B, n = c.shape

    # Mehrotra's starting point: the least-norm x and least-squares (λ, s)
    M0 = _normal(A, np.ones((B, n)))
    x = _solve(M0, b) @ A
    lam = _solve(M0, c @ A.T)
    s = c - lam @ A
    x = x + np.maximum(-1.5 * x.min(axis=1), 0.0)[:, None]
    s = s + np.maximum(-1.5 * s.min(axis=1), 0.0)[:, None]
    xs = (x * s).sum(axis=1)
    x = x + (0.5 * xs / s.sum(axis=1))[:, None]
    s = s + (0.5 * xs / x.sum(axis=1))[:, None]

    bnorm = 1.0 + np.linalg.norm(b, axis=1)
    cnorm = 1.0 + np.linalg.norm(c, axis=1)
    # each lane keeps its best iterate by the merit max(relative primal
    # residual, relative dual residual, relative gap): close to the optimum
    # the normal equations lose digits, and a step can make a lane worse
    best = np.full(B, np.inf)
    best_obj = np.zeros(B)
    since = np.zeros(B, np.int64)  # iterations since the lane's best improved
    iters = np.zeros(B, np.int64)
    live = np.ones(B, bool)
    for _ in range(maxiter + 1):
        rp = b - x @ A.T
        rd = c - lam @ A - s
        pobj = (c * x).sum(axis=1)
        dobj = (b * lam).sum(axis=1)
        merit = np.maximum.reduce([np.linalg.norm(rp, axis=1) / bnorm,
                                   np.linalg.norm(rd, axis=1) / cnorm,
                                   np.abs(pobj - dobj) / (1.0 + np.abs(pobj))])
        better = live & (merit < best)
        best = np.where(better, merit, best)
        best_obj = np.where(better, pobj, best_obj)
        since = np.where(better, 0, since + 1)
        live &= (best > tol) & (since < patience) & (iters < maxiter)
        if not live.any():
            break
        iters += live
        xl, sl, ll = x[live], s[live], lam[live]
        rpl, rdl = rp[live], rd[live]
        d = xl / sl
        M = _normal(A, d)
        mu = (xl * sl).sum(axis=1) / n

        def direction(rc):
            # M dλ = r_p + A (D r_d − S⁻¹ r_c); dx = D Aᵀdλ + S⁻¹ r_c − D r_d
            dl = _solve(M, rpl + (d * rdl - rc / sl) @ A.T)
            atdl = dl @ A
            return d * atdl + rc / sl - d * rdl, dl, rdl - atdl

        # predictor (affine scaling), then the centred corrector
        dx_a, _, ds_a = direction(-xl * sl)
        ap, ad = _step(xl, dx_a), _step(sl, ds_a)
        mu_aff = ((xl + ap[:, None] * dx_a) * (sl + ad[:, None] * ds_a)).sum(axis=1) / n
        sigma = (mu_aff / mu) ** 3
        dx, dl, ds = direction(sigma[:, None] * mu[:, None] - xl * sl - dx_a * ds_a)
        ap, ad = _step(xl, dx, 0.995), _step(sl, ds, 0.995)
        x[live] = xl + ap[:, None] * dx
        lam[live] = ll + ad[:, None] * dl
        s[live] = sl + ad[:, None] * ds
    vertex, certified = _vertex(A, b, c, x / s)
    return {"objective": np.where(certified, vertex, best_obj), "merit": best,
            "certified": certified, "converged": certified | (best <= accept),
            "iterations": iters}


def _vertex(A, b, c, ratio, feas: float = 1e-9) -> tuple:
    """The vertex of each lane's optimal basis guessed from its last
    iterate (the ``m`` columns of largest ``x_j / s_j``), and whether it is
    certified optimal: ``x_B = B⁻¹b ≥ 0`` and ``c − Aᵀ B⁻ᵀ c_B ≥ 0`` to
    ``feas`` relative.  A certified vertex's objective ``c_Bᵀ x_B`` is the
    optimum to rounding, whatever digits the iterates had lost."""
    Bn, n = c.shape
    m = b.shape[1]
    cols = np.argsort(-ratio, axis=1)[:, :m]
    Bt = A.T[cols]  # (lanes, m, m): the basis columns, as rows
    B = np.swapaxes(Bt, 1, 2)
    cB = np.take_along_axis(c, cols, axis=1)
    with np.errstate(all="ignore"):
        try:
            xB = _solve(B, b)
            y = _solve(Bt, cB)
        except np.linalg.LinAlgError:
            return np.zeros(Bn), np.zeros(Bn, bool)
        red = c - y @ A
        ok = ((xB >= -feas * (1.0 + np.abs(xB).max(axis=1, keepdims=True))).all(axis=1)
              & (red >= -feas * (1.0 + np.abs(c).max(axis=1, keepdims=True))).all(axis=1)
              & np.isfinite(xB).all(axis=1) & np.isfinite(red).all(axis=1))
    return (cB * xB).sum(axis=1), ok
