"""Ruiz equilibration for LP data, on tensors.

Counterpart of :mod:`pycllp_tpu.utils.scaling`: iteratively scale rows
and columns of A toward unit max-norm, folding the scaling into b, c, and
the recovered solution.  f32 insurance for the narrow solve.  Pure
function of the problem data; runs once per structure (not per scenario)
when A is shared.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["RuizScaling", "ruiz_equilibrate", "scale_problem", "unscale_solution"]


class RuizScaling(NamedTuple):
    row: torch.Tensor  # (..., m) row scale factors r
    col: torch.Tensor  # (..., n) column scale factors s


def ruiz_equilibrate(A: torch.Tensor, iters: int = 10, eps: float = 1e-12) -> RuizScaling:
    """Compute r, s such that diag(r)·A·diag(s) has ~unit max row/col norms."""
    r = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    s = torch.ones(A.shape[:-2] + A.shape[-1:], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        As = A * r[..., :, None] * s[..., None, :]
        row_norm = As.abs().amax(dim=-1)
        col_norm = As.abs().amax(dim=-2)
        # all-zero rows/columns (e.g. padding in heterogeneous batches)
        # keep scale 1 rather than blowing up by 1/sqrt(eps)
        r = r / torch.where(row_norm > eps, row_norm.sqrt(), 1.0)
        s = s / torch.where(col_norm > eps, col_norm.sqrt(), 1.0)
    return RuizScaling(row=r, col=s)


def scale_problem(A, b, c, scaling: RuizScaling):
    """Apply equilibration to the equality form min cᵀx, Ax=b, x≥0.

    x̃ = x / s  ⇒  Ã = R A S, b̃ = R b, c̃ = S c  (R=diag(row), S=diag(col)).
    """
    r, s = scaling
    A_s = A * r[..., :, None] * s[..., None, :]
    b_s = b * r
    c_s = c * s
    return A_s, b_s, c_s


def unscale_solution(x, y, z, scaling: RuizScaling):
    """Map the scaled-problem solution back: x = S x̃, y = R ỹ, z = z̃/s."""
    r, s = scaling
    return x * s, y * r, z / s
