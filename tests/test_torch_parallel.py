"""Port parity: the scenario-sharded layer (``parallel/shard.py``,
``parallel/distributed.py``, ``parallel/collectives.py``).

One module-scoped group of 4 gloo ranks on the CPU (``torch.distributed``,
a ``file://`` rendezvous under ``tmp_path``, one thread a rank) computes
every port-side result; each rank writes its results to a file, and the
tests hold them against the JAX package run on ``scenario_mesh(4)`` of
the 8 virtual CPU devices (``tests/conftest.py``), on the same numpy
inputs (the two packages' generators are bit-identical):

* ``sharded_hsd_solve``, collective and local termination
  (``tests/test_shard.py``'s batch, f64, tol 1e-8): statuses equal,
  objectives to 1e-8 relative; collective mode steps every rank through
  the same number of host-loop iterations, the unsharded solve's;
* per-instance (3-D) A sharded with the batch; mixed statuses across
  ranks (every 4th lane infeasible);
* ``sharded_hsd_solve_scan`` against the JAX sharded scan (statuses
  bitwise, objectives to 1e-9), and its f32 + f64-crossover case against
  scipy (≤ 1e-6);
* ``CollectiveAny``, ``host_local_batch`` and the errors (indivisible
  batch) on the ranks; a size-1 mesh, ``initialize``/``is_distributed``
  and ``host_local_batch`` for 3 ranks without a group.

The ranks import only torch and the port: JAX is imported inside the
fixtures.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pycllp_tpu_torch import SolverOptions, Status
from pycllp_tpu_torch.io.generate import random_equality_lp, random_standard_lp
from pycllp_tpu_torch.parallel import (
    CollectiveAny,
    global_scenario_mesh,
    host_local_batch,
    initialize,
    is_distributed,
    scenario_mesh,
    sharded_hsd_solve,
    sharded_hsd_solve_scan,
)
from pycllp_tpu_torch.solvers import hsd as port_hsd

WORLD = 4
OPTIMAL = int(Status.OPTIMAL)
INFEASIBLE = int(Status.INFEASIBLE)
SCAN_F64 = dict(tol=1e-8, maxiter=40, dtype="float64")
SCAN_F64_KW = dict(chunk=8, compact_cap=6, compact_bucket=64)
CROSSOVER = dict(
    tol=2e-7, maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05, refine_steps=0,
    init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5, finish_mode="crossover",
)
CROSSOVER_KW = dict(chunk=8, compact_cap=8, compact_bucket=8, finish_cap=3, finish_bucket=8)


def shared_batch():
    """tests/test_shard.py's batch: m=8, n=20, B=32, one shared A."""
    m, n, B = 8, 20, 32
    A, _, _ = random_equality_lp(m, n, seed=17)
    rng = np.random.default_rng(18)
    x0 = rng.uniform(0.1, 1.0, size=(B, n))
    y0 = rng.normal(size=(B, m))
    z0 = rng.uniform(0.1, 1.0, size=(B, n))
    return A, x0 @ A.T, y0 @ A + z0


def batched_A():
    return random_equality_lp(5, 12, nlp=16, seed=9, shared_A=False)


def mixed_batch():
    """Every 4th lane infeasible (tests/test_shard.py)."""
    B = 16
    rng = np.random.default_rng(0)
    bs = rng.uniform(0.5, 2.0, size=(B, 1))
    bs[::4] = -1.0
    cs = np.broadcast_to(np.array([1.0, 2.0]), (B, 2)).copy()
    return np.broadcast_to(np.array([[1.0, 1.0]]), (B, 1, 2)).copy(), bs, cs


def scan_lp(seed, m, n, dtype):
    return random_standard_lp(m, n, nlp=64, seed=seed, dtype=dtype)


def _np(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def _rank_main(rank: int, init_file: str, out_dir: str) -> None:
    """One rank of the 4-rank group: every port-side sharded result."""
    torch.set_num_threads(1)
    assert initialize(f"file://{init_file}", world_size=WORLD, rank=rank, backend="gloo",
                      timeout_s=120)
    res = {"is_distributed": is_distributed(), "initialize_again": initialize()}
    mesh = scenario_mesh()
    res["mesh_size"] = mesh.size()
    res["host_local_batch"] = np.array(host_local_batch(10))
    mask = torch.zeros(3, dtype=torch.bool)
    res["any_none"] = CollectiveAny(mesh)(mask)
    res["any_one"] = CollectiveAny(mesh)(mask | (rank == 2))

    A, b, c = shared_batch()
    opts = SolverOptions(tol=1e-8)
    for term in ("collective", "local"):
        port_hsd.HOST_STEPS = 0
        out = _np(sharded_hsd_solve(A, b, c, opts, mesh=mesh, termination=term, device="cpu"))
        res[f"{term}_steps"] = port_hsd.HOST_STEPS
        for k in ("objective", "status", "x"):
            res[f"{term}_{k}"] = out[k]
    for name, (A, b, c) in (("batched", batched_A()), ("mixed", mixed_batch())):
        out = _np(sharded_hsd_solve(A, b, c, opts, mesh=mesh, device="cpu"))
        res[f"{name}_objective"], res[f"{name}_status"] = out["objective"], out["status"]
    A, b, c = random_equality_lp(5, 12, nlp=10, seed=2, shared_A=False)
    try:
        sharded_hsd_solve(A, b, c, opts, mesh=mesh, device="cpu")
        res["indivisible"] = ""
    except ValueError as e:
        res["indivisible"] = str(e)

    eq = scan_lp(21, 12, 18, np.float64).to_equality_form()
    out = _np(sharded_hsd_solve_scan(eq.A, eq.b, eq.c, SolverOptions(**SCAN_F64), mesh=mesh,
                                     device="cpu", **SCAN_F64_KW))
    res["scan_objective"], res["scan_status"] = out["objective"], out["status"]
    eq = scan_lp(22, 16, 24, np.float32).to_equality_form()
    A, b, c = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))
    out = _np(sharded_hsd_solve_scan(A, b, c, SolverOptions(**CROSSOVER), mesh=mesh,
                                     device="cpu", **CROSSOVER_KW))
    res["crossover_objective"], res["crossover_status"] = out["objective"], out["status"]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' result files, loaded: a list indexed by rank."""
    d = tmp_path_factory.mktemp("parallel")
    mp.spawn(_rank_main, args=(str(d / "rendezvous"), str(d)), nprocs=WORLD, join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_mesh4():
    from pycllp_tpu.parallel import scenario_mesh as ref_scenario_mesh

    return ref_scenario_mesh(4)


@pytest.fixture(scope="module")
def jax_sharded(jax_mesh4):
    """The JAX package's sharded solves on scenario_mesh(4), as numpy."""
    from pycllp_tpu import SolverOptions as RefOptions
    from pycllp_tpu.parallel import sharded_hsd_solve as ref_solve
    from pycllp_tpu.parallel import sharded_hsd_solve_scan as ref_scan

    opts = RefOptions(tol=1e-8)
    out = {}
    for term in ("collective", "local"):
        out[term] = ref_solve(*shared_batch(), opts, mesh=jax_mesh4, termination=term)
    out["batched"] = ref_solve(*batched_A(), opts, mesh=jax_mesh4)
    out["mixed"] = ref_solve(*mixed_batch(), opts, mesh=jax_mesh4)
    eq = scan_lp(21, 12, 18, np.float64).to_equality_form()
    out["scan"] = ref_scan(eq.A, eq.b, eq.c, RefOptions(**SCAN_F64), mesh=jax_mesh4, **SCAN_F64_KW)
    return {k: {f: np.asarray(v[f]) for f in ("objective", "status")} for k, v in out.items()}


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("termination", ["collective", "local"])
def test_sharded_solve_matches_jax(ranks, jax_sharded, termination):
    status = _same_on_every_rank(ranks, f"{termination}_status")
    obj = _same_on_every_rank(ranks, f"{termination}_objective")
    ref = jax_sharded[termination]
    assert (status == OPTIMAL).all()
    np.testing.assert_array_equal(status, ref["status"])
    np.testing.assert_allclose(obj, ref["objective"], rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("termination", ["collective", "local"])
def test_sharded_solve_matches_unsharded_port(ranks, termination):
    A, b, c = shared_batch()
    port_hsd.HOST_STEPS = 0
    ref = _np(port_hsd.hsd_solve_batched(A, b, c, SolverOptions(tol=1e-8), device="cpu"))
    steps = port_hsd.HOST_STEPS
    np.testing.assert_array_equal(ranks[0][f"{termination}_status"], ref["status"])
    np.testing.assert_allclose(ranks[0][f"{termination}_objective"], ref["objective"], rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_allclose(ranks[0][f"{termination}_x"], ref["x"], rtol=1e-6, atol=1e-8)
    counts = [int(r[f"{termination}_steps"]) for r in ranks]
    if termination == "collective":
        # lockstep: every rank runs the unsharded loop's iterations
        assert counts == [steps] * WORLD, (counts, steps)
    else:
        assert max(counts) <= steps, (counts, steps)


def test_batched_A_shards(ranks, jax_sharded):
    status = _same_on_every_rank(ranks, "batched_status")
    assert (status == OPTIMAL).all()
    np.testing.assert_array_equal(status, jax_sharded["batched"]["status"])
    np.testing.assert_allclose(ranks[0]["batched_objective"], jax_sharded["batched"]["objective"],
                               rtol=1e-8, atol=1e-9)


def test_mixed_statuses_across_shards(ranks, jax_sharded):
    status = _same_on_every_rank(ranks, "mixed_status")
    assert (status[::4] == INFEASIBLE).all()
    mask = np.ones(16, bool)
    mask[::4] = False
    assert (status[mask] == OPTIMAL).all()
    np.testing.assert_array_equal(status, jax_sharded["mixed"]["status"])
    np.testing.assert_allclose(ranks[0]["mixed_objective"][mask],
                               jax_sharded["mixed"]["objective"][mask], rtol=1e-8, atol=1e-9)


def test_indivisible_batch_raises(ranks):
    assert all("divisible" in str(r["indivisible"]) for r in ranks)


def test_sharded_scan_matches_jax(ranks, jax_sharded):
    status = _same_on_every_rank(ranks, "scan_status")
    np.testing.assert_array_equal(status, jax_sharded["scan"]["status"])
    np.testing.assert_allclose(ranks[0]["scan_objective"], jax_sharded["scan"]["objective"],
                               rtol=1e-9, atol=1e-10)


def test_sharded_scan_finish_crossover_meets_contract(ranks):
    from scipy.optimize import linprog

    lp = scan_lp(22, 16, 24, np.float32)
    status = _same_on_every_rank(ranks, "crossover_status")
    obj = ranks[0]["crossover_objective"]
    assert (status == OPTIMAL).all(), np.unique(status, return_counts=True)
    rels = []
    for i in range(0, 64, 8):
        res = linprog(-np.asarray(lp.c)[i], A_ub=np.asarray(lp.A), b_ub=np.asarray(lp.b)[i],
                      bounds=[(0, None)] * 24, method="highs")
        rels.append(abs(-float(obj[i]) + res.fun) / max(1, abs(res.fun)))
    assert max(rels) <= 1e-6, max(rels)


def test_collective_any_and_rank_helpers(ranks):
    for r, res in enumerate(ranks):
        assert bool(res["is_distributed"]) and bool(res["initialize_again"])
        assert int(res["mesh_size"]) == WORLD
        assert not bool(res["any_none"]) and bool(res["any_one"])
        assert tuple(res["host_local_batch"]) == (min(3 * r, 10), min(3, max(0, 10 - 3 * r)))


def test_single_device_mesh_degrades():
    mesh1 = scenario_mesh(1)
    assert mesh1.size() == 1 and mesh1.mesh_dim_names == ("scenario",)
    A, b, c = random_equality_lp(5, 12, nlp=4, seed=2, shared_A=False)
    opts = SolverOptions(tol=1e-8)
    out = _np(sharded_hsd_solve(A, b, c, opts, mesh=mesh1, device="cpu"))
    ref = _np(port_hsd.hsd_solve_batched(A, b, c, opts, device="cpu"))
    assert (out["status"] == OPTIMAL).all()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
    with pytest.raises(ValueError, match="process group"):
        scenario_mesh(2)


def test_no_group_helpers(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    assert is_distributed() is False
    mesh = global_scenario_mesh()
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("scenario",)
    assert host_local_batch(100) == (0, 100)


def test_host_local_batch_three_ranks_matches_jax(monkeypatch):
    """The contiguous split for 3 ranks, against the reference's for 3
    processes (each package's rank query patched)."""
    import jax

    from pycllp_tpu.parallel import host_local_batch as ref_host_local_batch

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    for r in range(3):
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=r: r)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        for total in (100, 7, 2, 0):
            assert host_local_batch(total) == ref_host_local_batch(total), (r, total)
    assert [host_local_batch(100)] == [(68, 32)]
