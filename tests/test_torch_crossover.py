"""Port parity: the vertex crossover (solvers/crossover.py).

* ``basis_indicator``: the cases of tests/test_crossover.py (separated
  partition, exactly m per lane, NaN ratios), plus ±inf repair pins and
  f64 scores above f32 max, each equal to the JAX function's indicator;
* ``crossover_candidate`` on the reference kernel sets of both packages,
  from one identical numpy interior point: identical ``ok`` masks and
  vertices within 1e-9, with and without repair rounds; the known-vertex
  cases of tests/test_crossover.py on the port;
* the mixed engine (f32 factor + f64 refinement, run on the CPU through
  the plain versions of the CUDA kernels) accepts what the f64 reference
  set accepts, with the same vertices (tests/test_crossover.py's bounds);
  its solves are held to the JAX mixed engine's in tests/test_torch_df64.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pycllp_tpu import SolverOptions as RefOptions
from pycllp_tpu.io.generate import random_standard_lp
from pycllp_tpu.ops.reference import REFERENCE_KERNELS as REF_KS
from pycllp_tpu.solvers import crossover as ref_cx
from pycllp_tpu.solvers.hsd import hsd_solve_batched as ref_solve
from pycllp_tpu.utils.scaling import ruiz_equilibrate, scale_problem
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS
from pycllp_tpu_torch.solvers import crossover as cx

# min -x1-x2  s.t. x1+2x2<=2, 3x1+x2<=3  → vertex x=(0.8, 0.6)
KNOWN_A = np.array([[1.0, 2.0, 1.0, 0.0], [3.0, 1.0, 0.0, 1.0]])
KNOWN_B = np.array([[2.0, 3.0]])
KNOWN_C = np.array([[-1.0, -1.0, 0.0, 0.0]])


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _both_indicators(x, z, m):
    got = cx.basis_indicator(*_t(x, z), m).numpy()
    ref = np.asarray(ref_cx.basis_indicator(jnp.asarray(x), jnp.asarray(z), m))
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize(
    "case", ["separated", "exactly_m", "nan_ratios", "inf_pins", "above_f32_max", "ties"]
)
def test_basis_indicator_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "separated":
        x = np.array([[1.0, 2.0, 1e-8, 1e-9, 3.0]])
        z = np.array([[1e-8, 1e-9, 1.0, 2.0, 1e-7]])
        np.testing.assert_array_equal(_both_indicators(x, z, 3), [[1.0, 1.0, 0.0, 0.0, 1.0]])
    elif case == "exactly_m":
        x, z = rng.uniform(size=(7, 12)), rng.uniform(size=(7, 12))
        np.testing.assert_array_equal(_both_indicators(x, z, 5).sum(-1), np.full(7, 5.0))
    elif case == "nan_ratios":
        x = np.array([[np.nan, 1.0, 2.0, np.nan]])
        z = np.ones((1, 4))
        # the finite ratios win the top-m over the NaN-poisoned ones
        np.testing.assert_array_equal(_both_indicators(x, z, 2), [[0.0, 1.0, 1.0, 0.0]])
    elif case == "inf_pins":
        # a repair round's pins: +inf must enter, -inf must leave
        score = np.array([[5.0, np.inf, 3.0, -np.inf, 9.0, 1.0]])
        got = cx._top_m_indicator(torch.from_numpy(score), 3).numpy()
        ref = np.asarray(ref_cx._top_m_indicator(jnp.asarray(score), 3))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, [[1.0, 1.0, 0.0, 0.0, 1.0, 0.0]])
    elif case == "above_f32_max":
        # finite f64 scores beyond f32 range stay below a +inf pin (3e38 clamp)
        score = np.array([[1e45, 5e47, np.inf, 2.0, 1e300]])
        got = cx._top_m_indicator(torch.from_numpy(score), 1).numpy()
        ref = np.asarray(ref_cx._top_m_indicator(jnp.asarray(score), 1))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, [[0.0, 0.0, 1.0, 0.0, 0.0]])
    else:
        # scores that collide at f32 resolution: the cumsum tie-break takes
        # the leftmost, keeping exactly m
        score = np.array([[1.0, 1.0 + 1e-12, 1.0 - 1e-12, 0.5, 1.0]])
        got = cx._top_m_indicator(torch.from_numpy(score), 2).numpy()
        ref = np.asarray(ref_cx._top_m_indicator(jnp.asarray(score), 2))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, [[1.0, 1.0, 0.0, 0.0, 0.0]])


def test_known_vertex_recovered_and_wrong_basis_rejected():
    A, b, c = _t(KNOWN_A, KNOWN_B, KNOWN_C)
    ctx = REFERENCE_KERNELS.prepare(A)
    # a near-converged interior point: basic {x1, x2}, nonbasic slacks
    x, z = _t(np.array([[0.8, 0.6, 1e-7, 1e-7]]), np.array([[1e-7, 1e-7, 0.2, 0.2]]))
    xv, yv, zv, ok, _, _ = cx.crossover_candidate(ctx, b, c, x, z, REFERENCE_KERNELS, refine=2)
    assert bool(ok[0])
    np.testing.assert_allclose(xv[0].numpy(), [0.8, 0.6, 0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(zv[0, :2].numpy(), 0.0, atol=1e-12)
    assert (zv[0, 2:] >= -1e-12).all()
    # the slack basis: feasible but not optimal, its reduced costs negative
    x, z = _t(np.array([[1e-7, 1e-7, 2.0, 3.0]]), np.array([[0.2, 0.2, 1e-7, 1e-7]]))
    assert not bool(cx.crossover_candidate(ctx, b, c, x, z, REFERENCE_KERNELS)[3][0])
    # an off-by-one basis guess {x1, s1}: rejected without repair, fixed by it
    x, z = _t(np.array([[0.9, 1e-6, 0.4, 1e-7]]), np.array([[1e-7, 1e-5, 1e-7, 0.3]]))
    assert not bool(cx.crossover_candidate(ctx, b, c, x, z, REFERENCE_KERNELS, repair=0)[3][0])
    xv, _, _, ok, _, _ = cx.crossover_candidate(ctx, b, c, x, z, REFERENCE_KERNELS, repair=2)
    assert bool(ok[0])
    np.testing.assert_allclose(xv[0].numpy(), [0.8, 0.6, 0.0, 0.0], atol=1e-10)


def _half_converged(m, n, nlp, seed, tol, maxiter):
    """A scaled f64 problem and an interior point from a truncated f64 solve."""
    lp = random_standard_lp(m, n, nlp=nlp, seed=seed, dtype=np.float32)
    eq = lp.to_equality_form()
    A, b, c = (np.asarray(v, np.float64) for v in (eq.A, eq.b, eq.c))
    out = ref_solve(A, b, c, RefOptions(tol=tol, maxiter=maxiter, dtype="float64"))
    sc = ruiz_equilibrate(A)
    A_s, b_s, c_s = (np.asarray(v) for v in scale_problem(A, b, c, sc))
    xs = np.asarray(out["x"]) / np.asarray(sc.col)
    zs = np.asarray(out["z"]) * np.asarray(sc.col)
    return A_s, b_s, c_s, xs, zs


@pytest.mark.parametrize("repair", [0, 3])
def test_crossover_candidate_matches_jax_reference_sets(repair):
    A, b, c, x, z = _half_converged(16, 24, 64, seed=11, tol=1e-2, maxiter=7)
    ref = ref_cx.crossover_candidate(
        REF_KS.prepare(jnp.asarray(A)), *(jnp.asarray(v) for v in (b, c, x, z)), REF_KS,
        refine=2, feas_tol=1e-9, repair=repair,
    )
    At, bt, ct, xt, zt = _t(A, b, c, x, z)
    got = cx.crossover_candidate(REFERENCE_KERNELS.prepare(At), bt, ct, xt, zt, REFERENCE_KERNELS,
                                 refine=2, feas_tol=1e-9, repair=repair)
    ok, ref_ok = got[3].numpy(), np.asarray(ref[3])
    np.testing.assert_array_equal(ok, ref_ok)
    assert 0 < ok.sum() < len(ok)  # both accepting and rejecting lanes
    for name, a, r in zip(("xv", "yv", "zv", "ok", "rp", "rd"), got, ref):
        if name == "ok":
            continue
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(r)[ok], rtol=0, atol=1e-9,
                                   err_msg=name)


def test_repair_raises_acceptance():
    A, b, c, x, z = _half_converged(16, 24, 64, seed=11, tol=1e-2, maxiter=7)
    ctx = REFERENCE_KERNELS.prepare(_t(A)[0])
    accs = [
        int(cx.crossover_candidate(ctx, *_t(b, c, x, z), REFERENCE_KERNELS, repair=rep)[3].sum())
        for rep in (0, 3)
    ]
    assert accs[1] > accs[0], accs


def test_mixed_engine_accepts_what_the_reference_accepts():
    lp = random_standard_lp(24, 36, nlp=32, seed=12, dtype=np.float32)
    eq = lp.to_equality_form()
    A, b, c = (np.asarray(v, np.float64) for v in (eq.A, eq.b, eq.c))
    out = ref_solve(A, b, c, RefOptions(tol=1e-5, dtype="float64"))
    x, z = np.asarray(out["x"]), np.asarray(out["z"])
    At, bt, ct, xt, zt = _t(A, b, c, x, z)
    port_mixed = BATCHLAST_KERNELS.finish_kernels("mixed")
    xr, _, _, okr, _, _ = cx.crossover_candidate(
        REFERENCE_KERNELS.prepare(At), bt, ct, xt, zt, REFERENCE_KERNELS, refine=2, repair=2)
    xm, _, _, okm, _, _ = cx.crossover_candidate(
        port_mixed.prepare(At), bt, ct, xt, zt, port_mixed, refine=2, repair=2)
    okr, okm = okr.numpy(), okm.numpy()
    assert okr.mean() > 0.8, okr.mean()
    # the mixed engine must accept (nearly) everything the oracle accepts…
    assert (okm & okr).sum() / max(okr.sum(), 1) >= 0.95, (okr.sum(), okm.sum())
    # …with the same vertices, to f64-refinement accuracy
    both = okm & okr
    np.testing.assert_allclose(xm.numpy()[both], xr.numpy()[both], atol=1e-8)
