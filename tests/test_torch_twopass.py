"""Port parity: the two-pass compacted solve (solvers/twopass.py).

* shared 2-D A (delegated to the compact sweep) and per-instance 3-D A
  (the host ladder: capped pass 1, power-of-two remnant buckets padded
  by repeating the last lane, pass 2 from scratch) against
  ``pycllp_tpu.solvers.twopass`` in f64 on the reference kernel sets:
  equal statuses and iteration counts, objectives to 1e-9 relative;
* the shared-A delegation equals the port's ``hsd_solve_scan`` bitwise;
* the 3-D ladder on the port's ``BATCHLAST_KERNELS`` in f32 (the plain
  versions on the CPU) agrees in status with one full-budget
  ``hsd_solve_batched`` on ≥ 99% of lanes;
* ``reduce_any=`` raises ``ValueError`` on shared A, as the reference; on
  3-D A a recording ``reduce_any`` is called by every pass-1 and pass-2
  solve's loop predicate, and the results equal the default's and the
  JAX two-pass's;
* a chunk that does not divide the batch raises ``ValueError``.
"""

import numpy as np
import pytest

from pycllp_tpu import SolverOptions as RefOptions
from pycllp_tpu.io.generate import random_equality_lp
from pycllp_tpu.solvers import twopass as ref_twopass
from pycllp_tpu_torch import SolverOptions, Status
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.solvers.hsd import hsd_solve_batched, hsd_solve_scan
from pycllp_tpu_torch.solvers.twopass import hsd_solve_two_pass

KEYS = ("objective", "status", "iterations")


@pytest.fixture(scope="module")
def shared_problem():
    """tests/test_twopass.py's batch: m=6, n=15, B=48, one shared A."""
    m, n, B = 6, 15, 48
    A, _, _ = random_equality_lp(m, n, seed=50)
    rng = np.random.default_rng(51)
    b = rng.uniform(0.1, 1.0, size=(B, n)) @ A.T
    c = rng.normal(size=(B, m)) @ A + rng.uniform(0.1, 1.0, size=(B, n))
    return A, b, c


@pytest.fixture(scope="module")
def batched_problem():
    """tests/test_twopass.py's per-instance batch: m=5, n=12, B=24."""
    m, n, B = 5, 12, 24
    rng = np.random.default_rng(52)
    As, bs, cs = [], [], []
    for i in range(B):
        A, _, _ = random_equality_lp(m, n, seed=100 + i)
        As.append(A)
        bs.append(A @ rng.uniform(0.1, 1.0, size=n))
        cs.append(rng.normal(size=m) @ A + rng.uniform(0.1, 1.0, size=n))
    return np.stack(As), np.stack(bs), np.stack(cs)


def _assert_same(port, ref):
    np.testing.assert_array_equal(port["status"], ref["status"])
    np.testing.assert_array_equal(port["iterations"], ref["iterations"])
    np.testing.assert_allclose(port["objective"], ref["objective"], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("chunk", [None, 16])
def test_shared_A_matches_jax(shared_problem, chunk):
    A, b, c = shared_problem
    kw = dict(chunk=chunk, pass1_maxiter=6, min_bucket=4, keys=KEYS)
    ref = ref_twopass.hsd_solve_two_pass(A, b, c, RefOptions(tol=1e-8, maxiter=60), **kw)
    port = hsd_solve_two_pass(A, b, c, SolverOptions(tol=1e-8, maxiter=60), **kw, device="cpu")
    assert set(port) == set(KEYS)
    assert all(isinstance(v, np.ndarray) for v in port.values())
    _assert_same(port, {k: np.asarray(v) for k, v in ref.items()})
    assert (port["iterations"] > 6).any(), "the cap must bite"


def test_shared_A_delegation_equals_scan_bitwise(shared_problem):
    A, b, c = shared_problem
    opts = SolverOptions(tol=1e-8, maxiter=60)
    port = hsd_solve_two_pass(A, b, c, opts, chunk=16, pass1_maxiter=6, keys=KEYS, device="cpu")
    scan = hsd_solve_scan(A, b, c, opts, chunk=16, keys=KEYS, compact_cap=6, compact_bucket=48,
                          device="cpu")
    for k in KEYS:
        np.testing.assert_array_equal(port[k], scan[k].numpy())


def test_batched_A_matches_jax(batched_problem):
    A, b, c = batched_problem
    kw = dict(pass1_maxiter=6, min_bucket=4)
    ref = ref_twopass.hsd_solve_two_pass(A, b, c, RefOptions(tol=1e-8, maxiter=60), **kw)
    port = hsd_solve_two_pass(A, b, c, SolverOptions(tol=1e-8, maxiter=60), **kw, device="cpu")
    assert set(port) == set(ref)
    _assert_same(port, {k: np.asarray(v) for k, v in ref.items()})
    for k in ("x", "y", "z", "rho_p"):
        np.testing.assert_allclose(port[k], np.asarray(ref[k]), rtol=1e-7, atol=1e-9)
    # the remnant lanes re-solved from scratch with the full budget
    assert (port["iterations"] > 6).any()
    assert (port["status"] == int(Status.OPTIMAL)).all()


def test_batched_A_batchlast_f32_matches_full_budget(batched_problem):
    A, b, c = (v.astype(np.float32) for v in batched_problem)
    opts = SolverOptions(tol=1e-5, maxiter=40, dtype="float32")
    port = hsd_solve_two_pass(A, b, c, opts, BATCHLAST_KERNELS, pass1_maxiter=6, min_bucket=4,
                              keys=KEYS, device="cpu")
    full = hsd_solve_batched(A, b, c, opts, BATCHLAST_KERNELS, device="cpu")
    assert (port["status"] == full["status"].numpy()).mean() >= 0.99
    assert (port["iterations"] > 6).any()


def test_reduce_any_raises(shared_problem):
    A, b, c = shared_problem
    with pytest.raises(ValueError, match="shared-A"):
        hsd_solve_two_pass(A, b, c, SolverOptions(), reduce_any=any, device="cpu")
    with pytest.raises(ValueError, match="shared-A"):
        ref_twopass.hsd_solve_two_pass(A, b, c, RefOptions(), reduce_any=any)


def test_reduce_any_reaches_every_batched_A_solve(batched_problem, monkeypatch):
    """3-D A: the recording reduce_any answers every loop predicate of
    every pass-1 and pass-2 solve (one call per host iteration, plus one
    that ends each loop its lanes finish; a loop at its cap ends on
    ``k < maxiter`` alone), and changes no result."""
    from pycllp_tpu_torch.solvers import hsd as port_hsd

    A, b, c = batched_problem
    kw = dict(chunk=8, pass1_maxiter=6, min_bucket=4)
    opts = SolverOptions(tol=1e-8, maxiter=60)
    phases = []
    run_phase = port_hsd._run_phase

    def counted(*args, **kwargs):
        phases.append(args[9] if len(args) > 9 else kwargs.get("reduce_any"))
        return run_phase(*args, **kwargs)

    calls = []

    def reduce_any(mask):
        calls.append(mask.shape[0])
        return bool(mask.any())

    monkeypatch.setattr(port_hsd, "_run_phase", counted)
    port_hsd.HOST_STEPS = 0
    out = hsd_solve_two_pass(A, b, c, opts, reduce_any=reduce_any, **kw, device="cpu")
    steps = port_hsd.HOST_STEPS
    assert phases and all(r is reduce_any for r in phases)
    assert steps < len(calls) <= steps + len(phases)
    # 3 pass-1 chunks of 8 lanes, then the pass-2 buckets
    assert calls.count(8) >= 3 and set(calls) - {8}
    default = hsd_solve_two_pass(A, b, c, opts, **kw, device="cpu")
    for k in default:
        np.testing.assert_array_equal(out[k], default[k])
    ref = ref_twopass.hsd_solve_two_pass(A, b, c, RefOptions(tol=1e-8, maxiter=60), **kw)
    _assert_same(out, {k: np.asarray(v) for k, v in ref.items()})


def test_bad_chunk_raises(shared_problem):
    A, b, c = shared_problem
    with pytest.raises(ValueError, match="multiple of chunk"):
        hsd_solve_two_pass(A, b, c, SolverOptions(), chunk=13, device="cpu")
