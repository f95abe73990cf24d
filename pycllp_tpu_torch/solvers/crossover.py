"""Vertex crossover finish: basis identification + ONE wide basis solve.

Counterpart of :mod:`pycllp_tpu.solvers.crossover`, function by function.
The narrow interior point identifies the optimal basis B (the m largest
complementarity ratios x/z), and the exact vertex is recovered from the
basis normal equations with the 0/1 basis indicator as the diagonal:

    M   = A·diag(e_B)·Aᵀ  =  B·Bᵀ
    x_B = Bᵀ M⁻¹ b                      (then  B x_B = b  exactly)
    y   = M⁻¹ B c_B                     (then  Bᵀ y  = c_B exactly)
    z   = c − Aᵀ y                      (z_B ≈ 0, z_N = reduced costs)

``refine`` sweeps against the TRUE residuals (computed in f64) remove the
κ² amplification and the regularization shift.  Acceptance is verified
per lane: finiteness, primal residual, x ≥ 0 and z ≥ 0.  A rejected lane
falls back to the wide IPM continuation — crossover is an accelerator,
never a correctness gate.  The reference's ``lax.fori_loop`` sweeps and
repair rounds are Python loops here.
"""

from __future__ import annotations

import torch

__all__ = ["basis_indicator", "vertex_candidate", "crossover_candidate"]


def _top_m_indicator(score, m: int):
    """0/1 indicator of the m largest scores per lane.

    Sort-cutoff formulation, as the reference: the m-th largest value per
    lane is read from a row-wise sort, strict winners take it directly,
    and ties at the cutoff are broken left-to-right by a cumsum.  The sort
    runs on an f32 VIEW of the scores (only the ordering matters); f64
    scores are first clamped to ±3e38, strictly below the ±inf pins of
    the repair rounds, so a finite score above f32 max cannot become a pin.
    """
    n = score.shape[-1]
    if score.dtype == torch.float64:
        s32 = torch.where(torch.isinf(score), score, score.clamp(-3.0e38, 3.0e38))
        s32 = s32.to(torch.float32)
    else:
        s32 = score
    cut = torch.sort(s32, dim=-1).values[..., n - m][..., None]
    gt = s32 > cut
    need = m - gt.sum(dim=-1, keepdim=True)
    eq = s32 == cut
    take = eq & (torch.cumsum(eq, dim=-1) <= need)
    return (gt | take).to(score.dtype)


def _ratio_scores(x, z):
    """x/z per entry, NaN ratios mapped to −∞ (they sort last)."""
    ratio = x / z.clamp(min=torch.finfo(x.dtype).tiny)
    return torch.where(torch.isnan(ratio), -torch.inf, ratio)


def basis_indicator(x, z, m: int):
    """0/1 indicator of the m largest complementarity ratios x/z per lane.

    NaN ratios (numerically broken lanes) sort last; those lanes fail the
    candidate verification downstream either way.
    """
    return _top_m_indicator(_ratio_scores(x, z), m)


def vertex_candidate(fctx, b, c, d, fkset, *, reg_eps: float = 1e-12, refine: int = 2,
                     feas_tol: float = 1e-9):
    """Solve the basis normal equations for indicator ``d``; verify per lane.

    Returns ``(xv, yv, zv, ok, rp)`` with xv/zv UNCLAMPED (the repair
    rounds read their signs); ``ok`` is the finiteness/residual/sign test.
    """
    fac = fkset.factor(fctx, d, reg_eps)
    w, yv = fkset.solve(fac, (b, fkset.mv(fctx, d * c)))
    xv = d * fkset.rmv(fctx, w)
    for _ in range(refine):
        rp = b - fkset.mv(fctx, xv)
        rd_b = d * (c - fkset.rmv(fctx, yv))
        dw, dy = fkset.solve(fac, (rp, fkset.mv(fctx, rd_b)))
        xv, yv = xv + d * fkset.rmv(fctx, dw), yv + dy
    zv = c - fkset.rmv(fctx, yv)

    rp = b - fkset.mv(fctx, xv)
    bscale = b.abs().amax(dim=-1).clamp(min=1.0)
    xscale = xv.amax(dim=-1).clamp(min=1.0)
    zscale = zv.abs().amax(dim=-1).clamp(min=1.0)
    ok = (
        torch.isfinite(xv).all(dim=-1)
        & torch.isfinite(yv).all(dim=-1)
        & torch.isfinite(zv).all(dim=-1)
        & (rp.abs().amax(dim=-1) <= feas_tol * bscale)
        & (xv.amin(dim=-1) >= -feas_tol * xscale)
        & (zv.amin(dim=-1) >= -feas_tol * zscale)
    )
    return xv, yv, zv, ok, rp


def crossover_candidate(fctx, b, c, x, z, fkset, *, reg_eps: float = 1e-12, refine: int = 2,
                        feas_tol: float = 1e-9, repair: int = 0):
    """Compute the vertex candidate and its per-lane acceptance mask.

    Parameters are in SCALED equality coordinates, wide dtype; ``x``/``z``
    are the de-embedded interior point (x/τ, z/τ).

    ``repair``: batched basis-repair rounds for rejected lanes.  A wrong
    candidate names its own error: a basic variable with xv < 0 must
    leave, a nonbasic one with zv < 0 must enter.  Each round pins those
    scores to ∓∞, re-selects the top-m basis, re-solves and re-verifies;
    accepted lanes keep their first accepted candidate, and pins
    accumulate across rounds.

    Returns ``(xv, yv, zv, ok, rp, rd)``: xv/zv clamped nonnegative, rp
    the accepted round's true primal residual, rd = min(z_unclamped, 0)
    (z is exactly c − Aᵀy, so the clamp's residue is the only dual
    residual).
    """
    m = b.shape[-1]
    score = _ratio_scores(x, z)
    d = _top_m_indicator(score, m)

    xv, yv, zv, ok, rp = vertex_candidate(
        fctx, b, c, d, fkset, reg_eps=reg_eps, refine=refine, feas_tol=feas_tol
    )
    xa, ya, za, acc, rpa = xv, yv, zv, ok, rp
    for _ in range(repair):
        xscale = xv.amax(dim=-1).clamp(min=1.0)[..., None]
        zscale = zv.abs().amax(dim=-1).clamp(min=1.0)[..., None]
        leave = (d > 0.5) & (xv < -feas_tol * xscale)
        enter = (d < 0.5) & (zv < -feas_tol * zscale)
        score = torch.where(leave, -torch.inf, torch.where(enter, torch.inf, score))
        d = _top_m_indicator(score, m)
        xv, yv, zv, ok, rp = vertex_candidate(
            fctx, b, c, d, fkset, reg_eps=reg_eps, refine=refine, feas_tol=feas_tol
        )
        newly = ok & ~acc
        nn = newly[..., None]
        xa = torch.where(nn, xv, xa)
        ya = torch.where(nn, yv, ya)
        za = torch.where(nn, zv, za)
        rpa = torch.where(nn, rp, rpa)
        acc = acc | newly
    return xa.clamp(min=0.0), ya, za.clamp(min=0.0), acc, rpa, za.clamp(max=0.0)
