"""Port parity: config 5's lane 584269, the one lane of chip_smoke.py's wide
audit of config 5 that ends OPTIMAL above the 1e-6 contract.

BASELINE.md config 5 is bench.py's run_sweep with BENCH_TOTAL=1000000:
1,000,000 LPs of 64×64 from ``random_standard_lp(seed=3)``, shared A, at
bench.py's default options.  The lane is regenerated alone, by advancing
the seed's stream to its rows (pinned here against ``random_standard_lp``),
and solved on the CPU in both packages on their reference kernel sets, in
two batches: alone, and in the 64 lanes around it.

In both packages and both batches the lane ends OPTIMAL as a wide-IPM point,
not a crossover vertex: its candidate vertex is rejected, and the IPM stops
at ρ_p ≈ 4e-7, which passes the ρ test at tol = 1e-6.  That test does not
bound the objective error by tol, and where the IPM stops is set by the f32
narrow stage's rounding, which the batch width changes.  The readings
(relative objective error against scipy highs, iterations 8 in all):

=========  ===============  ======================
batch      JAX reference    port, reference set
=========  ===============  ======================
alone      2.98e-7          9.75e-7
64 lanes   1.70e-6          4.38e-6
=========  ===============  ======================

So the JAX reference itself ends this lane above the contract, and the
port's reading differs from it as the reference's own readings differ
between batches.  The test holds both packages to the same status,
iteration count and kind of end point, every reading within 1e-5, and the
reference's reading on the two sides of 1e-6.

The audit past the grid (``chip_smoke.py``'s off-grid audit of 120,000
lanes) found two more OPTIMAL lanes above 1e-6 on the card: 380766
(1.40e-6) and 819372 (1.23e-6).  Regenerated the same way:

======  =====  ===================================  ==========================
lane    batch  JAX reference                        port, reference set
======  =====  ===================================  ==========================
380766  alone  1.33e-6 (IPM end point, 12 its)      1.36e-6 (IPM end point)
380766  64     1.38e-6 (IPM end point, 12 its)      1.32e-6 (IPM end point)
819372  alone  3.23e-6 (IPM end point, 9 its)       4.39e-7 (IPM end point)
819372  64     5.5e-14 (crossover vertex, 10 its)   1.98e-6 (IPM end point, 9)
======  =====  ===================================  ==========================

The reference ends each above the contract in at least one batch, so both
are named with it; the test holds both packages OPTIMAL, every reading
within 1e-5, and the reference's reading on its recorded side of 1e-6.
"""

import numpy as np
import pytest
from scipy.optimize import linprog

import pycllp_tpu as ref_pkg
from pycllp_tpu.io.generate import random_standard_lp
from pycllp_tpu.ops.reference import REFERENCE_KERNELS as REF_KS
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import SolverOptions, Status
from pycllp_tpu_torch.io.generate import StandardLP
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS
from pycllp_tpu_torch.solvers import hsd as port_hsd

CONFIG5_N, CONFIG5_LANE = 1_000_000, 584269
CONTRACT = 1e-6
BAND = 1e-5  # the readings of an IPM end point at tol 1e-6 on this lane
# bench.py's bench_options() at its defaults (BENCH_FINISH=1)
BENCH_OPTIONS = dict(
    tol=1e-6, maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, kkt_warmup=0, gondzio_correctors=0,
    init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5, finish_maxiter=20,
    finish_gondzio=0, finish_mode="crossover", crossover_kset="mixed1", crossover_repair=2,
    crossover_refine=2, crossover_feas_tol=1e-9, finish_kkt_refine=0,
)
KEYS = ("objective", "status", "iterations", "rho_p", "rho_d")


def lane_of_random_lp(m: int, n: int, nlp: int, seed: int, lane: int):
    """Lane ``lane`` of ``random_standard_lp(m, n, nlp, seed, float32)``
    (shared A) without drawing the other lanes: each uniform double takes
    one step of the generator, so x0, s0, y0, z0's rows are reached by
    advancing the stream past A.  Returns A (m, n), b (m,), c (n,)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    bits = rng.bit_generator
    after_A = bits.state
    rows, start = [], 0
    for width in (n, m, m, n):  # x0, s0, y0, z0
        bits.state = after_A
        bits.advance(start + lane * width)
        rows.append(np.random.Generator(bits).uniform(0.1, 1.0, size=(1, width))
                    .astype(np.float32))
        start += nlp * width
    x0, s0, y0, z0 = rows
    b = np.einsum("...mn,...n->...m", A, x0) + s0
    c = np.einsum("...mn,...m->...n", A, y0) - z0
    return A, b[0], c[0]


@pytest.mark.parametrize("lane", [0, 537, 999])
def test_one_lane_regenerates_the_batch(lane):
    lp = random_standard_lp(64, 64, nlp=1000, seed=3, dtype=np.float32)
    A, b, c = lane_of_random_lp(64, 64, 1000, 3, lane)
    np.testing.assert_array_equal(A, lp.A)
    np.testing.assert_array_equal(b, lp.b[lane])
    np.testing.assert_array_equal(c, lp.c[lane])


def _numpy(out):
    return {k: np.asarray(v.cpu().numpy() if hasattr(v, "cpu") else v) for k, v in out.items()}


def _solve_around(lane: int, width: int):
    """Config 5's lanes around ``lane`` (``width`` of them, ``lane`` at
    width // 2) solved on the CPU in both packages at bench.py's options on
    their reference sets: (reference, port, scipy's result for ``lane``)."""
    lanes = [lane - width // 2 + j for j in range(width)]
    rows = [lane_of_random_lp(64, 64, CONFIG5_N, 3, i) for i in lanes]
    lp = StandardLP(A=rows[0][0], b=np.stack([r[1] for r in rows]),
                    c=np.stack([r[2] for r in rows]))
    eq = lp.to_equality_form()
    A, b, c = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))
    kw = dict(chunk=width, keys=KEYS, compact_cap=12, compact_bucket=max(width // 2, 1),
              finish_cap=3, finish_bucket=max(width // 4, 1))
    ref = _numpy(ref_hsd.hsd_solve_scan(A, b, c, ref_pkg.SolverOptions(**BENCH_OPTIONS),
                                        REF_KS, **kw))
    port = _numpy(port_hsd.hsd_solve_scan(A, b, c, SolverOptions(**BENCH_OPTIONS),
                                          REFERENCE_KERNELS, device="cpu", **kw))
    j = width // 2
    res = linprog(-np.asarray(lp.c[j], np.float64), A_ub=np.asarray(lp.A, np.float64),
                  b_ub=np.asarray(lp.b[j], np.float64), bounds=[(0, None)] * 64, method="highs")
    assert res.status == 0
    return ref, port, res


@pytest.mark.parametrize("width", [1, 64])
def test_config5_lane_over_contract(width):
    ref, port, res = _solve_around(CONFIG5_LANE, width)
    j = width // 2
    rel = {}
    for name, out in (("reference", ref), ("port", port)):
        assert int(out["status"][j]) == int(Status.OPTIMAL), name
        # an IPM end point accepted by the ρ test, not a crossover vertex
        assert 1e-9 < float(out["rho_p"][j]) <= BENCH_OPTIONS["tol"], name
        assert float(out["rho_d"][j]) <= BENCH_OPTIONS["tol"], name
        obj = -float(out["objective"][j])  # the equality form minimises −cᵀx
        rel[name] = abs(obj + res.fun) / max(1.0, abs(res.fun))
    assert int(ref["iterations"][j]) == int(port["iterations"][j])
    assert max(rel.values()) < BAND, rel
    if width == 1:
        assert rel["reference"] <= CONTRACT, rel
    else:
        assert rel["reference"] > CONTRACT, rel


# the reference's reading on the CPU above the contract?  (the table above)
OFF_GRID_REFERENCE_ABOVE = {(380766, 1): True, (380766, 64): True, (819372, 1): True,
                            (819372, 64): False}


@pytest.mark.parametrize("lane,width", sorted(OFF_GRID_REFERENCE_ABOVE))
def test_config5_off_grid_lane_over_contract(lane, width):
    ref, port, res = _solve_around(lane, width)
    j = width // 2
    rel = {}
    for name, out in (("reference", ref), ("port", port)):
        assert int(out["status"][j]) == int(Status.OPTIMAL), name
        assert float(out["rho_p"][j]) <= BENCH_OPTIONS["tol"], name
        rel[name] = abs(-float(out["objective"][j]) + res.fun) / max(1.0, abs(res.fun))
    assert max(rel.values()) < BAND, rel
    assert (rel["reference"] > CONTRACT) == OFF_GRID_REFERENCE_ABOVE[lane, width], rel
