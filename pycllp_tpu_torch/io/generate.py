"""Random LP generators with guaranteed solvability certificates.

Counterpart of :mod:`pycllp_tpu.io.generate`, numpy only: the same seed
gives bit-identical arrays in both packages.  The recipe plants strictly
feasible primal AND dual points, so an optimal solution exists and
interior-point iterations are well-posed.
"""

from __future__ import annotations

import numpy as np

from pycllp_tpu_torch.models import StandardLP

__all__ = ["random_standard_lp", "random_equality_lp"]


def random_standard_lp(
    m: int,
    n: int,
    nlp: int = 0,
    seed: int = 0,
    dtype=np.float64,
    shared_A: bool = True,
) -> StandardLP:
    """Random Vanderbei-form LP: ``max cᵀx s.t. Ax ≤ b, x ≥ 0``.

    Planted certificates: x0 > 0 with slack s0 > 0 gives b = A·x0 + s0
    (strict primal interior); y0 > 0, z0 > 0 give c = Aᵀy0 − z0 (strict
    dual interior) — so every instance has a finite optimum.

    ``nlp`` = 0 → unbatched; > 0 → batched b/c (and batched A when
    ``shared_A`` is False).
    """
    rng = np.random.default_rng(seed)
    batch = () if nlp == 0 else (nlp,)
    a_batch = () if (nlp == 0 or shared_A) else (nlp,)
    A = rng.normal(size=a_batch + (m, n)).astype(dtype)
    x0 = rng.uniform(0.1, 1.0, size=batch + (n,)).astype(dtype)
    s0 = rng.uniform(0.1, 1.0, size=batch + (m,)).astype(dtype)
    y0 = rng.uniform(0.1, 1.0, size=batch + (m,)).astype(dtype)
    z0 = rng.uniform(0.1, 1.0, size=batch + (n,)).astype(dtype)
    b = np.einsum("...mn,...n->...m", A, x0) + s0
    c = np.einsum("...mn,...m->...n", A, y0) - z0
    return StandardLP(A=A, b=b, c=c)


def random_equality_lp(
    m: int,
    n: int,
    nlp: int = 0,
    seed: int = 0,
    dtype=np.float64,
    shared_A: bool = True,
):
    """Random equality-form data ``min cᵀx s.t. Ax = b, x ≥ 0`` (n > m).

    Certificates: x0 > 0 → b = A·x0; free y0 and z0 > 0 → c = Aᵀy0 + z0.
    Returns (A, b, c) arrays.
    """
    if n <= m:
        raise ValueError("equality form needs n > m for a nontrivial feasible set")
    rng = np.random.default_rng(seed)
    batch = () if nlp == 0 else (nlp,)
    a_batch = () if (nlp == 0 or shared_A) else (nlp,)
    A = rng.normal(size=a_batch + (m, n)).astype(dtype)
    x0 = rng.uniform(0.1, 1.0, size=batch + (n,)).astype(dtype)
    y0 = rng.normal(size=batch + (m,)).astype(dtype)
    z0 = rng.uniform(0.1, 1.0, size=batch + (n,)).astype(dtype)
    b = np.einsum("...mn,...n->...m", A, x0)
    c = np.einsum("...mn,...m->...n", A, y0) + z0
    return A, b, c
