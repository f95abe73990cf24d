"""The benchmark's own copies of the generators its cells need, in plain
NumPy.  They are frozen here so that a change to the program's ``io/`` or
``models/`` cannot move the yardstick; a test holds them bit for bit to
the program's current versions at small sizes.

* :func:`random_standard_lp`: a random Vanderbei-form LP batch
  ``max cᵀx, Ax ≤ b, x ≥ 0`` with planted strictly feasible primal and
  dual points, so every lane has a finite optimum (the program's
  ``io/generate.random_standard_lp``).
* :func:`equality_form`: ``[A | I]``, ``[−c; 0]`` (``models/lp.py``'s
  ``StandardLP.to_equality_form``).
* :func:`netlib_fixture`: the deterministic synthetic stand-ins at the
  netlib problems' exact sizes (``io/netlib.load_fixture``'s synthetic
  path, which round-trips them through MPS text without changing a bit).
* :func:`bucket_problems`, :func:`pad_and_mask`: the netlib batching
  (``io/netlib``).
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["random_standard_lp", "equality_form", "netlib_fixture", "bucket_problems",
           "pad_and_mask"]


def random_standard_lp(m: int, n: int, nlp: int = 0, seed: int = 0, dtype=np.float64) -> tuple:
    """(A, b, c) of ``max cᵀx s.t. Ax ≤ b, x ≥ 0``: ``b = A x0 + s0`` and
    ``c = Aᵀ y0 − z0`` with x0, s0, y0, z0 uniform in [0.1, 1).  ``nlp`` = 0
    gives one LP, > 0 a batch of b and c over one shared A."""
    rng = np.random.default_rng(seed)
    batch = () if nlp == 0 else (nlp,)
    A = rng.normal(size=(m, n)).astype(dtype)
    x0 = rng.uniform(0.1, 1.0, size=batch + (n,)).astype(dtype)
    s0 = rng.uniform(0.1, 1.0, size=batch + (m,)).astype(dtype)
    y0 = rng.uniform(0.1, 1.0, size=batch + (m,)).astype(dtype)
    z0 = rng.uniform(0.1, 1.0, size=batch + (n,)).astype(dtype)
    # the program's einsum, for its rounding
    b = np.einsum("...mn,...n->...m", A, x0) + s0
    c = np.einsum("...mn,...m->...n", A, y0) - z0
    return A, b, c


def equality_form(A, b, c) -> tuple:
    """``min c̃ᵀx̃ s.t. Ãx̃ = b, x̃ ≥ 0`` with ``Ã = [A | I]``, ``c̃ = [−c; 0]``,
    for a shared (m, n) ``A``."""
    A = np.asarray(A)
    m = A.shape[0]
    A_eq = np.concatenate([A, np.eye(m, dtype=A.dtype)], axis=-1)
    c = np.asarray(c)
    c_eq = np.concatenate([-c, np.zeros(c.shape[:-1] + (m,), dtype=c.dtype)], axis=-1)
    return A_eq, b, c_eq


def netlib_fixture(name: str, rows: int, cols: int) -> tuple:
    """The synthetic stand-in for netlib's ``name`` at ``rows`` × ``cols``:
    (A, b, c) in float64 of ``max cᵀx, Ax ≤ b, x ≥ 0``."""
    return random_standard_lp(rows, cols, seed=zlib.crc32(name.encode()) % (2**31))


def bucket_problems(shapes: list, round_rows: int = 8, round_cols: int = 8) -> dict:
    """``{(rows, cols) rounded up: [index, ...]}`` of problems of the given
    (rows, cols) shapes; every problem in exactly one bucket."""
    up = lambda v, r: -(-v // r) * r  # noqa: E731
    buckets: dict = {}
    for i, (m, n) in enumerate(shapes):
        buckets.setdefault((up(m, round_rows), up(n, round_cols)), []).append(i)
    return buckets


def pad_and_mask(problems: list, dtype=np.float32) -> tuple:
    """Pad (A, b, c) problems of ``max cᵀx, Ax ≤ b`` to a common (m, n):
    extra rows get b = 1 and zero coefficients, extra columns c = −1 and
    zero coefficients, so neither changes the optimum.  Returns (A, b, c,
    row_mask, col_mask)."""
    m = max(p[0].shape[0] for p in problems)
    n = max(p[0].shape[1] for p in problems)
    B = len(problems)
    A = np.zeros((B, m, n), dtype)
    b = np.ones((B, m), dtype)
    c = -np.ones((B, n), dtype)
    row_mask = np.zeros((B, m), bool)
    col_mask = np.zeros((B, n), bool)
    for k, (Ak, bk, ck) in enumerate(problems):
        mi, ni = Ak.shape
        A[k, :mi, :ni] = np.asarray(Ak, dtype)
        b[k, :mi] = np.asarray(bk, dtype)
        c[k, :ni] = np.asarray(ck, dtype)
        row_mask[k, :mi] = True
        col_mask[k, :ni] = True
    return A, b, c, row_mask, col_mask
