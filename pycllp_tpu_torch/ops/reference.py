"""Reference (plain PyTorch) implementation of the IPM hot-path kernel set.

Counterpart of :mod:`pycllp_tpu.ops.reference`, which uses ``lax.linalg``;
this set uses ``torch.linalg.cholesky_ex`` and ``solve_triangular``.  It is
the plain path for f64 and for the parity tests; the hand-written CUDA
kernels live behind the same interface in :mod:`pycllp_tpu_torch.ops.batchlast`.

Interface (all tensors carry a leading instance axis ``...`` unless
stated; ``A`` may omit it — shared structure across scenarios):

* ``prepare(A) -> ctx`` — once per structure, outside the IPM loop.
* ``mv(ctx, x)`` / ``rmv(ctx, y)`` — ``A @ x`` / ``Aᵀ @ y``.
* ``factor(ctx, d, reg_eps) -> fac`` — factorize the normal matrix
  ``M = A·diag(d)·Aᵀ + δI`` with ``δ = reg_eps · max(diag)`` per
  instance.  ``fac`` is opaque.
* ``solve(fac, rs) -> tuple`` — apply ``M⁻¹`` to each RHS in the tuple
  (multi-RHS so factorization traffic is shared).
* ``matvec_M(fac, v)`` — apply ``M`` (for iterative refinement), via
  the identity ``M v = A(d ⊙ Aᵀv) + δv`` so M is never materialised.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["KernelSet", "ReferenceKernels", "REFERENCE_KERNELS"]


class PreparedA(NamedTuple):
    A: Any  # (..., m, n)
    Asq: Any  # (..., m, n) — elementwise A², for diag(M) = A²·d


class NormalFactor(NamedTuple):
    ctx: PreparedA
    L: Any  # (..., m, m) lower Cholesky factor
    d: Any  # (..., n) scaling at factorization
    reg: Any  # (...,) diagonal shift δ


def _mv(A, x):
    """``A @ x`` for a shared (m, n) or per-instance (B, m, n) A."""
    if A.dim() == 2:
        return x @ A.T
    return torch.einsum("...mn,...n->...m", A, x)


def _rmv(A, y):
    """``Aᵀ @ y`` for a shared (m, n) or per-instance (B, m, n) A."""
    if A.dim() == 2:
        return y @ A
    return torch.einsum("...mn,...m->...n", A, y)


class KernelSet:
    """Abstract hot-path kernel bundle consumed by the HSD core.

    Implementations are stateless singletons.
    """

    name = "abstract"

    def prepare(self, A) -> PreparedA:
        raise NotImplementedError

    def mv(self, ctx: PreparedA, x):
        raise NotImplementedError

    def rmv(self, ctx: PreparedA, y):
        raise NotImplementedError

    def factor(self, ctx: PreparedA, d, reg_eps: float) -> NormalFactor:
        raise NotImplementedError

    def solve(self, fac: NormalFactor, rs: tuple) -> tuple:
        raise NotImplementedError

    def factor_and_solve(self, ctx: PreparedA, d, reg_eps: float, rs: tuple):
        """Factorize and solve the first RHS batch; implementations may
        fuse the two."""
        fac = self.factor(ctx, d, reg_eps)
        return fac, self.solve(fac, rs)

    def matvec_M(self, fac: NormalFactor, v):
        ctx = fac.ctx
        return self.mv(ctx, fac.d * self.rmv(ctx, v)) + fac.reg[..., None] * v

    def finish_kernels(self, which: str = "df64") -> "KernelSet":
        """Kernel set for the wide-dtype finish phase (default: self)."""
        return self

    def __repr__(self):
        return f"KernelSet({self.name})"


class ReferenceKernels(KernelSet):
    """Plain PyTorch implementation: matmuls + batched ``torch.linalg``."""

    name = "reference"

    def prepare(self, A) -> PreparedA:
        return PreparedA(A=A, Asq=A * A)

    def mv(self, ctx, x):
        return _mv(ctx.A, x)

    def rmv(self, ctx, y):
        return _rmv(ctx.A, y)

    def factor(self, ctx, d, reg_eps):
        A = ctx.A
        M = (A * d[..., None, :]) @ A.mT
        diag = _mv(ctx.Asq, d)
        reg = reg_eps * diag.amax(dim=-1)
        m = M.shape[-1]
        M = M + reg[..., None, None] * torch.eye(m, dtype=M.dtype, device=M.device)
        L, info = torch.linalg.cholesky_ex(M)
        # like lax.linalg.cholesky, a factorization that fails (non-PD
        # M) yields NaN for that instance instead of raising; the
        # solver's numerical guard catches the lane
        L = torch.where((info != 0)[..., None, None], torch.nan, L)
        return NormalFactor(ctx=ctx, L=L, d=d, reg=reg)

    def solve(self, fac, rs):
        L = fac.L
        out = []
        for r in rs:
            t = torch.linalg.solve_triangular(L, r[..., None], upper=False)
            v = torch.linalg.solve_triangular(L.mT, t, upper=True)
            out.append(v[..., 0])
        return tuple(out)


REFERENCE_KERNELS = ReferenceKernels()
