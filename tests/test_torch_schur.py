"""Port parity: the column-sharded big LP (``parallel/schur.py``), its
row-sharded Cholesky (``parallel/dchol.py``) and the registry's ``schur``
solver (``solvers/schur_solver.py``).

One module-scoped group of 4 gloo ranks on the CPU computes every
port-side result (each rank writes its results to a file); the tests hold
them against the JAX package run on ``model_mesh(4)`` of the 8 virtual CPU
devices (``tests/conftest.py``), on the same numpy inputs:

* ``column_sharded_hsd_solve`` with the replicated and the row-sharded
  factor (``tests/test_schur.py``'s m=32, n=128, B=4 batch, f64, tol
  1e-8): statuses equal, objectives to 1e-8 relative, and to 1e-6 against
  scipy; an infeasible lane beside an optimal one;
* the f32 + f64-finish contract case (m=256, n=2048, B=2) against scipy
  (≤ 1e-6 per lane);
* ``rowshard_cholesky`` / ``rowshard_cholesky_solve`` against
  ``torch.linalg.cholesky`` and a dense solve (1e-12, f64);
* the ``schur`` solver padding n=30 columns to 32; indivisible n, and
  indivisible m under ``factor="sharded"``, raise on every rank;
* without a group: a size-1 model mesh against the port's unsharded
  ``hsd_solve`` (1e-9), and the registry names.

The ranks import only torch and the port: JAX is imported inside the
fixtures.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import pycllp_tpu_torch as port_pkg
from pycllp_tpu_torch import SolverOptions, Status
from pycllp_tpu_torch.io.generate import random_equality_lp, random_standard_lp
from pycllp_tpu_torch.parallel import column_sharded_hsd_solve, initialize, model_mesh
from pycllp_tpu_torch.parallel.dchol import rowshard_cholesky, rowshard_cholesky_solve
from pycllp_tpu_torch.solvers.hsd import hsd_solve

WORLD = 4
OPTIMAL = int(Status.OPTIMAL)
FINISH = dict(tol=1e-6, dtype="float32", maxiter=60, init_point="mehrotra", stall_patience=6,
              finish_dtype="float64", switch_tol=1e-4, finish_maxiter=30)


def big_batch():
    """tests/test_schur.py's sharded-factor batch: m=32, n=128, B=4."""
    m, n, B = 32, 128, 4
    A, b0, c0 = random_equality_lp(m, n, seed=5)
    rng = np.random.default_rng(6)
    b = np.stack([b0 * (1 + 0.1 * rng.random(m)) for _ in range(B)])
    c = np.stack([c0 + 0.05 * rng.random(n) for _ in range(B)])
    return A, b, c


def infeasible_pair():
    """Σx = −1 (infeasible) beside Σx = 1 (optimal), 8 columns."""
    return np.ones((1, 8)), np.array([[-1.0], [1.0]]), np.ones((2, 8))


def finish_batch():
    """tests/test_schur.py's f32 + f64-finish case: m=256, n=2048, B=2."""
    m, n, B = 256, 2048, 2
    rng = np.random.default_rng(0)
    A, b0, c0 = random_equality_lp(m, n, seed=9)
    b = np.stack([b0 * (1 + 0.05 * rng.random(m)) for _ in range(B)]).astype(np.float32)
    c = np.stack([c0 + 0.02 * rng.random(n) for _ in range(B)]).astype(np.float32)
    return A.astype(np.float32), b, c, A


def spd_batch():
    m, B = 64, 3
    rng = np.random.default_rng(0)
    X = rng.normal(size=(B, m, 2 * m))
    return np.einsum("bij,bkj->bik", X, X) + m * np.eye(m), rng.normal(size=(B, m))


def _np(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def _rank_main(rank: int, init_file: str, out_dir: str) -> None:
    """One rank of the 4-rank group: every port-side column-sharded result."""
    torch.set_num_threads(1)
    initialize(f"file://{init_file}", world_size=WORLD, rank=rank, backend="gloo", timeout_s=120)
    mesh = model_mesh()
    res = {}
    opts = SolverOptions(tol=1e-8, scale=False)
    A, b, c = big_batch()
    for factor in ("replicated", "sharded"):
        out = _np(column_sharded_hsd_solve(A, b, c, opts, mesh=mesh, factor=factor, device="cpu"))
        for k in ("objective", "status", "x", "iterations"):
            res[f"{factor}_{k}"] = out[k]
    out = _np(column_sharded_hsd_solve(*infeasible_pair(), opts, mesh=mesh, device="cpu"))
    res["infeasible_status"], res["infeasible_objective"] = out["status"], out["objective"]
    A32, b32, c32, _ = finish_batch()
    out = _np(column_sharded_hsd_solve(A32, b32, c32, SolverOptions(**FINISH), mesh=mesh,
                                       device="cpu"))
    res["finish_status"], res["finish_objective"] = out["status"], out["objective"]

    for name, (A, b, c), kw in (
        ("indivisible_n", random_equality_lp(5, 14, seed=3), {}),
        ("indivisible_m", random_equality_lp(10, 48, seed=3), {"factor": "sharded"}),
    ):
        try:
            column_sharded_hsd_solve(A, b, c, SolverOptions(), mesh=mesh, device="cpu", **kw)
            res[name] = ""
        except ValueError as e:
            res[name] = str(e)

    M, r = spd_batch()
    mb = M.shape[1] // WORLD
    Mw = torch.from_numpy(M[:, rank * mb:(rank + 1) * mb].copy())
    Lw, kks = rowshard_cholesky(Mw, mesh, WORLD)
    res["Lw"], res["kks"] = Lw.numpy(), kks.numpy()
    res["dchol_x"] = rowshard_cholesky_solve(Lw, kks, torch.from_numpy(r), mesh, WORLD).numpy()

    lp = random_standard_lp(9, 21, nlp=3, seed=17)
    s = port_pkg.get_solver("schur", tol=1e-8, mesh=mesh, device="cpu")
    s.init(lp)
    sol = s.solve()
    res["schur_x"], res["schur_objective"], res["schur_status"] = sol.x, sol.objective, sol.status
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' result files, loaded: a list indexed by rank."""
    d = tmp_path_factory.mktemp("schur")
    mp.spawn(_rank_main, args=(str(d / "rendezvous"), str(d)), nprocs=WORLD, join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_column_sharded():
    """The JAX package's column-sharded solves on model_mesh(4), as numpy."""
    from pycllp_tpu import SolverOptions as RefOptions
    from pycllp_tpu.parallel import column_sharded_hsd_solve as ref_solve
    from pycllp_tpu.parallel import model_mesh as ref_model_mesh

    mesh = ref_model_mesh(4)
    opts = RefOptions(tol=1e-8, scale=False)
    out = {f: ref_solve(*big_batch(), opts, mesh=mesh, factor=f) for f in ("replicated", "sharded")}
    out["infeasible"] = ref_solve(*infeasible_pair(), opts, mesh=mesh)
    return {k: {f: np.asarray(v[f]) for f in ("objective", "status", "iterations")}
            for k, v in out.items()}


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("factor", ["replicated", "sharded"])
def test_column_sharded_matches_jax(ranks, jax_column_sharded, factor):
    status = _same_on_every_rank(ranks, f"{factor}_status")
    obj = _same_on_every_rank(ranks, f"{factor}_objective")
    ref = jax_column_sharded[factor]
    assert (status == OPTIMAL).all(), status
    np.testing.assert_array_equal(status, ref["status"])
    np.testing.assert_allclose(obj, ref["objective"], rtol=1e-8, atol=1e-9)
    assert np.abs(ranks[0][f"{factor}_iterations"] - ref["iterations"]).max() <= 1


@pytest.mark.parametrize("factor", ["replicated", "sharded"])
def test_column_sharded_matches_scipy(ranks, factor):
    from scipy.optimize import linprog

    A, b, c = big_batch()
    x = _same_on_every_rank(ranks, f"{factor}_x")
    assert x.shape == (4, 128)
    for i in range(4):
        res = linprog(c[i], A_eq=A, b_eq=b[i], bounds=[(0, None)] * 128, method="highs")
        np.testing.assert_allclose(ranks[0][f"{factor}_objective"][i], res.fun, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(A @ x[i], b[i], rtol=1e-6, atol=1e-6)


def test_infeasible_lane(ranks, jax_column_sharded):
    status = _same_on_every_rank(ranks, "infeasible_status")
    assert status.tolist() == [int(Status.INFEASIBLE), OPTIMAL]
    np.testing.assert_array_equal(status, jax_column_sharded["infeasible"]["status"])
    np.testing.assert_allclose(ranks[0]["infeasible_objective"][1],
                               jax_column_sharded["infeasible"]["objective"][1], rtol=1e-8)


def test_f32_finish_meets_contract(ranks):
    from scipy.optimize import linprog

    _, b, c, A = finish_batch()
    status = _same_on_every_rank(ranks, "finish_status")
    assert (status == OPTIMAL).all(), status
    for i in range(2):
        res = linprog(c[i].astype(np.float64), A_eq=A, b_eq=b[i].astype(np.float64),
                      bounds=[(0, None)] * A.shape[1], method="highs")
        rel = abs(float(ranks[0]["finish_objective"][i]) - res.fun) / max(1, abs(res.fun))
        assert rel < 1e-6, (i, rel)


@pytest.mark.parametrize("name", ["indivisible_n", "indivisible_m"])
def test_indivisible_raises(ranks, name):
    assert all("divisible" in str(r[name]) for r in ranks)


def test_rowshard_cholesky_matches_torch(ranks):
    M, r = spd_batch()
    L = torch.linalg.cholesky(torch.from_numpy(M)).numpy()
    Lw = np.concatenate([res["Lw"] for res in ranks], axis=1)
    np.testing.assert_allclose(Lw, L, rtol=1e-12, atol=1e-12)
    kks = _same_on_every_rank(ranks, "kks")
    mb = M.shape[1] // WORLD
    for k in range(WORLD):
        np.testing.assert_allclose(kks[k], L[:, k * mb:(k + 1) * mb, k * mb:(k + 1) * mb],
                                   rtol=1e-12, atol=1e-12)
    x = _same_on_every_rank(ranks, "dchol_x")
    np.testing.assert_allclose(x, np.linalg.solve(M, r[..., None])[..., 0], rtol=1e-12,
                               atol=1e-12)


def test_rowshard_cholesky_nans_a_failed_lane():
    """One row block, no group: a lane that is not positive definite comes
    back NaN (lax.linalg.cholesky's answer), the others intact."""
    M, r = spd_batch()
    M[1] = -M[1]
    Lw, kks = rowshard_cholesky(torch.from_numpy(M), model_mesh(1), 1)
    assert torch.isnan(Lw[1]).all() and torch.isfinite(Lw[[0, 2]]).all()
    x = rowshard_cholesky_solve(Lw, kks, torch.from_numpy(r), model_mesh(1), 1).numpy()
    np.testing.assert_allclose(x[[0, 2]], np.linalg.solve(M[[0, 2]], r[[0, 2], :, None])[..., 0],
                               rtol=1e-12, atol=1e-12)


def test_schur_solver_pads_columns(ranks):
    from scipy.optimize import linprog

    lp = random_standard_lp(9, 21, nlp=3, seed=17)
    x = _same_on_every_rank(ranks, "schur_x")
    assert x.shape == (3, 21)
    assert (_same_on_every_rank(ranks, "schur_status") == OPTIMAL).all()
    for i in range(3):
        res = linprog(-np.asarray(lp.c)[i], A_ub=np.asarray(lp.A), b_ub=np.asarray(lp.b)[i],
                      bounds=[(0, None)] * 21, method="highs")
        np.testing.assert_allclose(ranks[0]["schur_objective"][i], -res.fun, rtol=1e-6, atol=1e-6)


def test_one_device_matches_unsharded():
    A, b, c = random_equality_lp(12, 48, seed=61)
    opts = SolverOptions(tol=1e-9, scale=False)
    ref = hsd_solve(A, b, c, opts, device="cpu")
    out = column_sharded_hsd_solve(A, b, c, opts, mesh=model_mesh(1), device="cpu")
    assert out["x"].shape == (48,) and int(out["status"]) == OPTIMAL
    np.testing.assert_allclose(float(out["objective"]), float(ref["objective"]), rtol=1e-9)
    assert int(out["iterations"]) <= int(ref["iterations"]) + 2


def test_registry_and_errors():
    assert {"schur", "column_sharded", "big_lp"} <= set(port_pkg.solvers.solver_registry)
    s = port_pkg.get_solver("big_lp", device="cpu")
    assert s.name == "schur" and s.mesh is None
    A, b, c = random_equality_lp(4, 8, nlp=2, seed=1, shared_A=False)
    with pytest.raises(ValueError, match="3-D"):
        s._solve_impl(A, b, c)
    with pytest.raises(ValueError, match="unknown factor"):
        column_sharded_hsd_solve(A[0], b, c, SolverOptions(), mesh=model_mesh(1), factor="x",
                                 device="cpu")
