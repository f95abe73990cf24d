"""Netlib-style LP fixtures.

Counterpart of :mod:`pycllp_tpu.io.netlib` (numpy only): the fixtures,
buckets and padded batches are bit-identical to the reference's.
BASELINE.json config 4 calls for a netlib subset (afiro, adlittle,
sc50a) batched with padding/masking.  As in the reference (see its
module docstring for the disposition on real netlib data):

* real netlib MPS/SIF files are loaded from ``PYCLLP_NETLIB_DIR``
  whenever a user provides them, through the same reader, and
* otherwise deterministic synthetic stand-ins at the exact netlib scales
  (rows×cols: afiro 27×32, adlittle 56×97, sc50a 50×48) with PINNED
  optimal objectives (``FIXTURE_OBJECTIVES``, verified against
  ``scipy.optimize.linprog``) stand in, round-tripped through the MPS
  writer and reader.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from pycllp_tpu_torch.io.generate import random_standard_lp
from pycllp_tpu_torch.io.mps import MPSProblem, read_mps, write_mps
from pycllp_tpu_torch.models import GeneralLP, StandardLP

__all__ = [
    "NETLIB_SCALES",
    "FIXTURE_OBJECTIVES",
    "REAL_NETLIB_OBJECTIVES",
    "load_fixture",
    "fixture_names",
    "pad_and_mask",
    "bucket_problems",
]

NETLIB_SCALES = {
    # name -> (rows, cols) of the real netlib problem it stands in for
    "afiro": (27, 32),
    "adlittle": (56, 97),
    "sc50a": (50, 48),
}

# Pinned optima of the SYNTHETIC stand-ins (max-form objective of the
# StandardLP produced by ``load_fixture(name).lp.to_standard_form()``),
# verified against scipy.optimize.linprog(method="highs") on f64.
# Regression anchors for the full model→solver chain; NOT the published
# netlib optima (see the module docstring's disposition).  The real
# problems' published optima, for when PYCLLP_NETLIB_DIR supplies them:
# afiro -464.75314286, adlittle +225494.96316, sc50a -64.575077059.
FIXTURE_OBJECTIVES = {
    "afiro": -1.9398662763559709,
    "adlittle": 28.093108065754983,
    "sc50a": -7.350643059808046,
}
REAL_NETLIB_OBJECTIVES = {
    "afiro": -464.75314286,
    "adlittle": 225494.96316,
    "sc50a": -64.575077059,
}


def fixture_names() -> list[str]:
    return sorted(NETLIB_SCALES)


def load_fixture(name: str) -> MPSProblem:
    """Real netlib MPS if available in $PYCLLP_NETLIB_DIR, else the
    synthetic stand-in of the same dimensions (round-tripped through the
    MPS writer/reader so IO is exercised either way)."""
    directory = os.environ.get("PYCLLP_NETLIB_DIR")
    if directory:
        for candidate in (f"{name}.mps", f"{name.upper()}.SIF", f"{name}.sif"):
            path = os.path.join(directory, candidate)
            if os.path.exists(path):
                return read_mps(path)
    if name not in NETLIB_SCALES:
        raise KeyError(f"unknown fixture {name!r}; have {fixture_names()}")
    m, n = NETLIB_SCALES[name]
    # zlib.crc32, NOT hash(): str hash is salted per process, which made
    # the "deterministic" fixtures differ between runs (round-3 find)
    std = random_standard_lp(m, n, seed=zlib.crc32(name.encode()) % (2**31))
    glp = GeneralLP(
        A=np.asarray(std.A),
        row_ub=np.asarray(std.b),
        c=np.asarray(std.c),
        sense="max",
    )
    text = write_mps(glp, name=f"SYN-{name.upper()}")
    return read_mps(text)


def bucket_problems(
    problems: list[StandardLP], round_rows: int = 8, round_cols: int = 8
) -> dict:
    """Group heterogeneous problems into padded-size buckets
    (SURVEY.md §7 hard part 4: pad-to-BUCKET, not pad-to-global-max).

    Problems whose (rows, cols) round up to the same multiple share a
    bucket; a 27×32 LP no longer pays a 56×97 pad because one large
    problem is in the batch (the O((m_max/m_i)³) factorization blow-up
    dominated the round-1 netlib bench).  Within a bucket, callers
    should additionally detect identical A across instances and take
    the shared-structure fast path.

    Returns ``{(m_pad, n_pad): [problem_index, ...]}`` with indices into
    ``problems``; every problem appears in exactly one bucket.
    """
    up = lambda v, r: -(-v // r) * r  # noqa: E731
    buckets: dict[tuple, list] = {}
    for i, p in enumerate(problems):
        key = (up(p.nrows, round_rows), up(p.ncols, round_cols))
        buckets.setdefault(key, []).append(i)
    return buckets


def pad_and_mask(problems: list[StandardLP], dtype=np.float32):
    """Pad heterogeneous StandardLPs to a common (m, n) with validity
    masks (SURVEY.md §7 hard part 4).

    Padding scheme: extra rows get b = 1 with zero coefficients (slack
    rows, trivially feasible, never binding); extra columns get c = -1
    with zero coefficients (never enter the optimal basis of the max
    problem).  Returns (A (B,m,n), b (B,m), c (B,n), row_mask (B,m),
    col_mask (B,n)).
    """
    m = max(p.nrows for p in problems)
    n = max(p.ncols for p in problems)
    B = len(problems)
    A = np.zeros((B, m, n), dtype)
    b = np.ones((B, m), dtype)
    c = -np.ones((B, n), dtype)
    row_mask = np.zeros((B, m), bool)
    col_mask = np.zeros((B, n), bool)
    for k, p in enumerate(problems):
        mi, ni = p.nrows, p.ncols
        A[k, :mi, :ni] = np.asarray(p.A, dtype)
        b[k, :mi] = np.asarray(p.b, dtype)
        c[k, :ni] = np.asarray(p.c, dtype)
        row_mask[k, :mi] = True
        col_mask[k, :ni] = True
    return A, b, c, row_mask, col_mask
