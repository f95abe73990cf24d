"""Mixed-precision kernel set: f32 CUDA factorizations, f64 refinement.

Counterpart of :mod:`pycllp_tpu.ops.mixed`.  Two roles, as in the
reference:

* **The crossover basis-solve engine** (``SolverOptions.crossover_kset``
  default ``"mixed1"``): the vertex crossover solves ``B·Bᵀ`` systems
  whose diagonal is a 0/1 basis indicator, so cond(M) = κ(B)² stays
  moderate and the f32-factor + f64-refinement scheme converges well past
  the 1e-9 vertex verification bound.
* **A recorded negative result for the wide IPM finish**
  (``finish_kset="mixed"``): for the late-IPM normal matrix the f32
  factor's PSD-safety shift makes refinement stagnate (~3e-4 in the
  reference's measurement); the IPM finish uses the df64 set instead.
  It is ported because it is the same class as ``"mixed1"``.

The set implements the :class:`KernelSet` contract at f64 working
precision while every factorization and triangular substitution runs in
the f32 batch-last CUDA kernels (:func:`~pycllp_tpu_torch.ops.batchlast.chol_bl`,
:func:`~pycllp_tpu_torch.ops.batchlast.solve_bl`).  Each solve is
iterative refinement:

    v₀ = P⁻¹ r                      (P = f32 Cholesky of M+δI)
    vₖ₊₁ = vₖ + P⁻¹ (r − M̂ vₖ)      (residual in f64, M̂ = A·D·Aᵀ + δI)

Shared-A f64 matvecs are Ozaki products (:mod:`pycllp_tpu_torch.ops.df64`),
``mv_bits`` wide (the reference's ``PYCLLP_OZAKI_MV_BITS``).
"""

from __future__ import annotations

import typing

import torch

from pycllp_tpu_torch.ops import df64
from pycllp_tpu_torch.ops.reference import KernelSet, _mv, _rmv

__all__ = ["MixedPrecisionKernels", "MIXED_FINISH_KERNELS", "MIXED_IR1_KERNELS"]


class PreparedMixed(typing.NamedTuple):
    """Wide-precision operator data + the base kernel set's f32 context."""

    A: typing.Any  # (…, m, n) wide (f64) — residual/matvec precision
    Asq: typing.Any  # (…, m, n) wide, elementwise A² for diag(M)
    lo: typing.Any  # base.prepare(A.to(f32)) — factorization context
    Amv: typing.Any = None  # OzakiOperand of A / Aᵀ (groups and packed
    Armv: typing.Any = None  # slices): exact f64 matvecs for a shared 2-D f64 A


class MixedFactor(typing.NamedTuple):
    ctx: PreparedMixed
    fac_lo: typing.Any  # base kernel set's f32 factorization
    d: typing.Any  # (…, n) wide scaling at factorization
    reg: typing.Any  # (…,) wide diagonal shift δ (same relative ε as f32)
    s: typing.Any = None  # (…, m) wide Jacobi row scale of the f32 factor
    # (None = unscaled): the factor holds chol(S·M·S + δI) and the
    # preconditioner application is P⁻¹r = S·(LLᵀ)⁻¹·(S·r)


class MixedPrecisionKernels(KernelSet):
    """f64-interface kernels whose O(m³) work runs in the f32 base set."""

    name = "mixed_finish"

    def __init__(
        self,
        base: KernelSet,
        ir_steps: int = 3,
        lo_reg_floor: float = 2e-6,
        jacobi: bool = True,
        *,
        mv_bits: int = df64.OZAKI_MV_BITS,
    ):
        self.base = base
        self.ir_steps = ir_steps
        # the f32 factor needs enough diagonal shift to stay PSD under f32
        # rounding however tiny the wide phase's δ is; refinement then
        # converges THROUGH the floor (the factor is only a preconditioner)
        self.lo_reg_floor = lo_reg_floor
        # Jacobi equilibration of the f32 factor: factor S·M·S + δI with
        # S = diag(M)^(-1/2), which removes scaling-induced conditioning
        # from the ε_f32·κ contraction and makes the PSD shift relative
        # per row (shared-A batch-last contexts only)
        self.jacobi = jacobi
        # the width of the Ozaki matvecs (shared 2-D f64 A)
        self.mv_bits = df64.check_ozaki_width(mv_bits, "mv_bits")
        widths = "" if self.mv_bits == df64.OZAKI_MV_BITS else f", mv_bits={self.mv_bits}"
        self.name = (f"mixed_finish({base.name}, ir={ir_steps}"
                     f"{', jacobi' if jacobi else ''}{widths})")

    def check_ozaki_levels(self, m: int, n: int) -> None:
        df64.check_ozaki_levels(n, self.mv_bits, "mv_bits")
        df64.check_ozaki_levels(m, self.mv_bits, "mv_bits")

    # -- wide-precision operator ------------------------------------------
    def prepare(self, A):
        Amv = Armv = None
        if A.dim() == 2 and A.dtype == torch.float64:
            m, n = A.shape
            self.check_ozaki_levels(m, n)
            sm, nm, cm = df64.ozaki_mv_params(n, self.mv_bits)
            sr, nr, cr = df64.ozaki_mv_params(m, self.mv_bits)
            Amv = df64._ozaki_prepare(A, s=sm, n_slices=nm, cut=cm)
            Armv = df64._ozaki_prepare(A.T, s=sr, n_slices=nr, cut=cr)
        return PreparedMixed(
            A=A, Asq=A * A, lo=self.base.prepare(A.to(torch.float32)), Amv=Amv, Armv=Armv,
        )

    def mv(self, ctx, x):
        if getattr(ctx, "Amv", None) is None or x.dim() != 2:
            return _mv(ctx.A, x)
        s, n_slices, cut = df64.ozaki_mv_params(ctx.A.shape[-1], self.mv_bits)
        return df64._ozaki_matmul(ctx.Amv, x, s=s, n_slices=n_slices, cut=cut).T

    def rmv(self, ctx, y):
        if getattr(ctx, "Armv", None) is None or y.dim() != 2:
            return _rmv(ctx.A, y)
        s, n_slices, cut = df64.ozaki_mv_params(ctx.A.shape[-2], self.mv_bits)
        return df64._ozaki_matmul(ctx.Armv, y, s=s, n_slices=n_slices, cut=cut).T

    # -- factor in f32, refine in f64 --------------------------------------
    def factor(self, ctx, d, reg_eps):
        if not isinstance(ctx, PreparedMixed):  # plain context (oracle path)
            ctx = PreparedMixed(A=ctx.A, Asq=ctx.Asq, lo=self.base.prepare(ctx.A.to(torch.float32)))
        diag = _mv(ctx.Asq, d)
        reg = reg_eps * diag.amax(dim=-1)
        lo = ctx.lo
        if self.jacobi and getattr(lo, "W", None) is not None:
            # shared-A batch-last context: form the f32 normal matrix via
            # the W-trick, equilibrate, factor with the CUDA Cholesky.
            # (Per-instance 3-D A and other bases fall through to the
            # unscaled base factor below.)
            from pycllp_tpu_torch.ops.batchlast import BLFactor, chol_bl

            m = lo.A.shape[0]
            B = d.shape[0]
            tiny = torch.finfo(d.dtype).tiny
            s = 1.0 / torch.sqrt(diag.clamp(min=tiny))
            sT = s.to(torch.float32).T
            M = (lo.W @ d.to(torch.float32).T).reshape(m, m, B)
            M = M * sT[:, None, :] * sT[None, :, :]
            # scaled diag(SMS) = 1 exactly → the PSD-safety shift is the
            # relative floor itself
            shift = torch.full((B,), max(reg_eps, self.lo_reg_floor),
                               dtype=torch.float32, device=d.device)
            L, dinv = chol_bl(M, shift)
            fac_lo = BLFactor(ctx=lo, L=L, dinv_diag=dinv, d=d.to(torch.float32), reg=shift)
            return MixedFactor(ctx=ctx, fac_lo=fac_lo, d=d, reg=reg, s=s)
        fac_lo = self.base.factor(lo, d.to(torch.float32), max(reg_eps, self.lo_reg_floor))
        return MixedFactor(ctx=ctx, fac_lo=fac_lo, d=d, reg=reg)

    def _lo_solve(self, fac, rs):
        """Apply the f32 preconditioner to wide residuals (f32 out).

        Unscaled: (M+δI)⁻¹ via the base solve.  Jacobi: the factor holds
        chol(S·M·S + δI), so P⁻¹r = S·(LLᵀ)⁻¹·(S·r).
        """
        if fac.s is None:
            return self.base.solve(fac.fac_lo, tuple(r.to(torch.float32) for r in rs))
        s32 = fac.s.to(torch.float32)
        vs = self.base.solve(fac.fac_lo, tuple((r * fac.s).to(torch.float32) for r in rs))
        return tuple(v * s32 for v in vs)

    def solve(self, fac, rs):
        wide = rs[0].dtype
        k = len(rs)
        vs = tuple(v.to(wide) for v in self._lo_solve(fac, rs))
        if not self.ir_steps:
            return vs
        if k > 1 and fac.ctx.A.dim() != 2:
            # per-instance (B, m, n) A: the stacked sweep below would pair
            # the batch B against k·B — refine each RHS through matvec_M
            for _ in range(self.ir_steps):
                es = tuple(r - self.matvec_M(fac, v) for r, v in zip(rs, vs))
                cs = self._lo_solve(fac, es)
                vs = tuple(v + c.to(wide) for v, c in zip(vs, cs))
            return vs
        # one stacked IR residual per sweep: the k RHS share A and d, so
        # M·[v₁;…;vₖ] is one (k·B)-batch mv/rmv pair instead of k
        d_k = torch.cat([fac.d] * k, dim=0) if k > 1 else fac.d
        reg_k = torch.cat([fac.reg] * k, dim=0) if k > 1 else fac.reg
        ctx = fac.ctx
        B = rs[0].shape[0]
        R = torch.cat(rs, dim=0) if k > 1 else rs[0]
        for _ in range(self.ir_steps):
            V = torch.cat(vs, dim=0) if k > 1 else vs[0]
            MV = self.mv(ctx, d_k * self.rmv(ctx, V)) + reg_k[..., None] * V
            E = R - MV
            es = tuple(E[i * B:(i + 1) * B] for i in range(k))
            cs = self._lo_solve(fac, es)
            vs = tuple(v + c.to(wide) for v, c in zip(vs, cs))
        return vs

    # matvec_M: inherited — runs in wide precision via self.mv/rmv on
    # fac.ctx (A, d, reg all wide), defining the system IR converges to.


def _default_mixed(ir_steps: int = 3):
    from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS

    return MixedPrecisionKernels(BATCHLAST_KERNELS, ir_steps=ir_steps)


MIXED_FINISH_KERNELS = _default_mixed()
# crossover-economy sibling: the vertex crossover layers its own
# true-residual refinement sweeps on top of each solve, so one inner IR
# sweep suffices
MIXED_IR1_KERNELS = _default_mixed(ir_steps=1)
