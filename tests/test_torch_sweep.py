"""Port parity: the checkpointed scenario sweep (``utils/sweep.py``).

The cases of tests/test_sweep.py, run on the port and held against the
JAX package's sweep on the same numpy inputs (f64, reference kernel
sets): statuses and iteration counts equal, objectives to 1e-9.  Both
packages write the same sweep directory format, so a sweep started by one
is finished by the other.  The sharded sweep (``mesh=``) runs on 2 gloo
ranks on the CPU: it equals the unsharded sweep, its resumed run equals
its uninterrupted one, and a mismatched directory raises on both ranks.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import pycllp_tpu as ref_pkg
from pycllp_tpu.io.generate import random_equality_lp
from pycllp_tpu.utils.sweep import scenario_sweep as ref_sweep
from pycllp_tpu_torch import SolverOptions, Status
from pycllp_tpu_torch.io.generate import random_equality_lp as port_random_equality_lp
from pycllp_tpu_torch.parallel import initialize, scenario_mesh
from pycllp_tpu_torch.utils.sweep import scenario_sweep


def sweep(*args, **kw):
    return scenario_sweep(*args, device="cpu", **kw)


@pytest.fixture(scope="module")
def sweep_problem():
    m, n, N = 6, 15, 50
    A, _, _ = random_equality_lp(m, n, seed=40)
    rng = np.random.default_rng(41)
    b = rng.uniform(0.1, 1.0, size=(N, n)) @ A.T
    c = rng.normal(size=(N, m)) @ A + rng.uniform(0.1, 1.0, size=(N, n))
    return A, b, c


@pytest.fixture(scope="module")
def jax_whole(sweep_problem):
    """The JAX package's uninterrupted sweep (chunk 16, tol 1e-8)."""
    A, b, c = sweep_problem
    return ref_sweep(A, b, c, ref_pkg.SolverOptions(tol=1e-8), chunk=16)


def assert_same(res, ref, rtol=1e-9):
    np.testing.assert_array_equal(res.status, ref.status)
    np.testing.assert_array_equal(res.iterations, ref.iterations)
    np.testing.assert_allclose(res.objective, ref.objective, rtol=rtol, atol=1e-12)


def test_chunked_matches_single(sweep_problem, jax_whole):
    A, b, c = sweep_problem
    opts = SolverOptions(tol=1e-8)
    res16 = sweep(A, b, c, opts, chunk=16)
    res50 = sweep(A, b, c, opts, chunk=50)
    assert res16.n_chunks == 4
    np.testing.assert_allclose(res16.objective, res50.objective, rtol=1e-9)
    assert (res16.status == int(Status.OPTIMAL)).all()
    assert_same(res16, jax_whole)


def test_resume_skips_completed(sweep_problem, jax_whole, tmp_path):
    A, b, c = sweep_problem
    opts = SolverOptions(tol=1e-8)
    d = str(tmp_path / "sweep")
    first = sweep(A, b, c, opts, chunk=16, out_dir=d)
    assert first.n_resumed == 0
    second = sweep(A, b, c, opts, chunk=16, out_dir=d)
    assert second.n_resumed == 4
    np.testing.assert_allclose(first.objective, second.objective)
    assert_same(second, jax_whole)


def test_partial_resume(sweep_problem, jax_whole, tmp_path):
    A, b, c = sweep_problem
    opts = SolverOptions(tol=1e-8)
    d = str(tmp_path / "sweep")
    full = sweep(A, b, c, opts, chunk=16, out_dir=d)
    # delete one chunk: only that chunk should recompute
    (tmp_path / "sweep" / "chunk_000002.npz").unlink()
    redo = sweep(A, b, c, opts, chunk=16, out_dir=d)
    assert redo.n_resumed == 3
    np.testing.assert_allclose(full.objective, redo.objective, rtol=1e-9)
    assert_same(redo, jax_whole)


def test_config_mismatch_raises(sweep_problem, tmp_path):
    A, b, c = sweep_problem
    d = str(tmp_path / "sweep")
    sweep(A, b, c, SolverOptions(tol=1e-8), chunk=16, out_dir=d)
    with pytest.raises(ValueError, match="different configuration"):
        sweep(A, b, c, SolverOptions(tol=1e-6), chunk=16, out_dir=d)
    # the manifest is the reference's, field for field
    ref_d = str(tmp_path / "ref")
    ref_sweep(A, b[:16], c[:16], ref_pkg.SolverOptions(tol=1e-8, dtype="float64"), chunk=16,
              out_dir=ref_d)
    sweep(A, b[:16], c[:16], SolverOptions(tol=1e-8, dtype="float64"), chunk=16,
          out_dir=str(tmp_path / "port"))
    with open(os.path.join(ref_d, "manifest.json")) as f:
        ref_manifest = json.load(f)
    with open(tmp_path / "port" / "manifest.json") as f:
        assert json.load(f) == ref_manifest
    with open(tmp_path / "sweep" / "manifest.json") as f:
        assert json.load(f)["dtype"] == "float64"  # a numpy dtype name, from b


def test_save_x(sweep_problem, tmp_path):
    A, b, c = sweep_problem
    d = str(tmp_path / "sweep")
    sweep(A, b, c, SolverOptions(tol=1e-8), chunk=25, out_dir=d, save_x=True)
    ref_d = str(tmp_path / "ref")
    ref_sweep(A, b, c, ref_pkg.SolverOptions(tol=1e-8), chunk=25, out_dir=ref_d, save_x=True)
    data = np.load(tmp_path / "sweep" / "chunk_000000.npz")
    ref = np.load(os.path.join(ref_d, "chunk_000000.npz"))
    assert data["x"].shape == (25, A.shape[1])
    assert sorted(data.files) == sorted(ref.files)
    for key in ref.files:
        assert data[key].dtype == ref[key].dtype, key
    np.testing.assert_allclose(data["x"], ref["x"], rtol=1e-7, atol=1e-9)


def test_window_sizes_agree(sweep_problem):
    A, b, c = sweep_problem
    opts = SolverOptions(tol=1e-8)
    one = sweep(A, b, c, opts, chunk=16, window_chunks=1)
    win = sweep(A, b, c, opts, chunk=16, window_chunks=4)
    # the tail chunk is padded differently (2-lane vs 16-lane batch),
    # which changes the reduction order — tolerance-level, not exact
    np.testing.assert_allclose(one.objective, win.objective, rtol=1e-6)
    np.testing.assert_array_equal(one.status, win.status)
    ref_one = ref_sweep(A, b, c, ref_pkg.SolverOptions(tol=1e-8), chunk=16, window_chunks=1)
    assert_same(one, ref_one)


def test_window_with_compaction(sweep_problem, tmp_path):
    A, b, c = sweep_problem
    opts = SolverOptions(tol=1e-8, maxiter=60)
    d = str(tmp_path / "sweep")
    kw = dict(chunk=16, compact_cap=6, compact_bucket=50)
    plain = sweep(A, b, c, opts, chunk=16)
    comp = sweep(A, b, c, opts, out_dir=d, **kw)
    # warm resume is trajectory-identical
    np.testing.assert_array_equal(plain.objective, comp.objective)
    # interleaved partial resume across a window boundary
    (tmp_path / "sweep" / "chunk_000001.npz").unlink()
    (tmp_path / "sweep" / "chunk_000003.npz").unlink()
    redo = sweep(A, b, c, opts, out_dir=d, **kw)
    assert redo.n_resumed == 2
    np.testing.assert_array_equal(plain.objective, redo.objective)
    ref = ref_sweep(A, b, c, ref_pkg.SolverOptions(tol=1e-8, maxiter=60), **kw)
    assert_same(redo, ref)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_directory_carries_across_packages(sweep_problem, jax_whole, tmp_path, first):
    """A sweep directory written partly by one package is finished by the
    other, and the result is the JAX package's whole run."""
    A, b, c = sweep_problem
    d = str(tmp_path / "sweep")
    ref_opts, opts = ref_pkg.SolverOptions(tol=1e-8), SolverOptions(tol=1e-8)
    if first == "jax":
        ref_sweep(A, b, c, ref_opts, chunk=16, out_dir=d)
        for k in (1, 3):
            (tmp_path / "sweep" / f"chunk_00000{k}.npz").unlink()
        res = sweep(A, b, c, opts, chunk=16, out_dir=d)
    else:
        sweep(A, b, c, opts, chunk=16, out_dir=d)
        for k in (1, 3):
            (tmp_path / "sweep" / f"chunk_00000{k}.npz").unlink()
        res = ref_sweep(A, b, c, ref_opts, chunk=16, out_dir=d)
    assert res.n_resumed == 2
    assert_same(res, jax_whole)


class _Interrupt(Exception):
    pass


def test_interrupted_sweep_resumes(sweep_problem, jax_whole, tmp_path):
    """A sweep stopped from its progress callback after the first window
    leaves that window's chunks and no half-written file; a restart
    resumes from them."""
    A, b, c = sweep_problem
    opts = SolverOptions(tol=1e-8)
    d = str(tmp_path / "sweep")
    seen = []

    def stop_after_first_window(done, total):
        seen.append((done, total))
        raise _Interrupt

    with pytest.raises(_Interrupt):
        sweep(A, b, c, opts, chunk=8, window_chunks=3, out_dir=d, progress=stop_after_first_window)
    assert seen == [(3, 7)]
    assert sorted(os.listdir(d)) == ["chunk_000000.npz", "chunk_000001.npz", "chunk_000002.npz",
                                     "manifest.json"]
    progress = []
    res = sweep(A, b, c, opts, chunk=8, window_chunks=3, out_dir=d,
                progress=lambda done, total: progress.append(done))
    assert res.n_resumed == 3 and res.n_chunks == 7 and progress == [3, 6, 7]
    np.testing.assert_array_equal(res.status, jax_whole.status)
    np.testing.assert_allclose(res.objective, jax_whole.objective, rtol=1e-9, atol=1e-12)


def test_custom_solve_fn_pads_the_tail_chunk(sweep_problem, jax_whole):
    A, b, c = sweep_problem
    widths = []

    def solve_fn(Ab, bb, cb):
        widths.append(bb.shape[0])
        from pycllp_tpu_torch.solvers.hsd import hsd_solve_batched

        return hsd_solve_batched(Ab, bb, cb, SolverOptions(tol=1e-8), device="cpu")

    res = sweep(A, b, c, SolverOptions(tol=1e-8), chunk=16, solve_fn=solve_fn)
    assert widths == [16, 16, 16, 16]  # one chunk per call, the tail padded
    np.testing.assert_array_equal(res.status, jax_whole.status)
    np.testing.assert_allclose(res.objective, jax_whole.objective, rtol=1e-9, atol=1e-12)


def _problem():
    """sweep_problem's arrays from the port's generator (bit-identical),
    for the ranks, which import no JAX."""
    m, n, N = 6, 15, 50
    A, _, _ = port_random_equality_lp(m, n, seed=40)
    rng = np.random.default_rng(41)
    b = rng.uniform(0.1, 1.0, size=(N, n)) @ A.T
    c = rng.normal(size=(N, m)) @ A + rng.uniform(0.1, 1.0, size=(N, n))
    return A, b, c


def _sweep_rank(rank: int, init_file: str, out_dir: str) -> None:
    """One of 2 ranks: a sharded sweep uninterrupted, then one stopped
    after its first window and resumed, then a mismatched directory."""
    torch.set_num_threads(1)
    initialize(f"file://{init_file}", world_size=2, rank=rank, backend="gloo", timeout_s=120)
    mesh = scenario_mesh()
    A, b, c = _problem()
    opts = SolverOptions(tol=1e-8)
    whole = sweep(A, b, c, opts, chunk=16, mesh=mesh)
    d = os.path.join(out_dir, "sweep")

    def stop(done, total):
        raise _Interrupt

    try:
        sweep(A, b, c, opts, chunk=16, mesh=mesh, out_dir=d, progress=stop)
    except _Interrupt:
        pass
    files_after_stop = sorted(os.listdir(d))
    resumed = sweep(A, b, c, opts, chunk=16, mesh=mesh, out_dir=d)
    try:
        sweep(A, b, c, SolverOptions(tol=1e-6), chunk=16, mesh=mesh, out_dir=d)
        mismatch = ""
    except ValueError as e:
        mismatch = str(e)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             whole_objective=whole.objective, whole_status=whole.status,
             whole_iterations=whole.iterations, resumed_objective=resumed.objective,
             resumed_status=resumed.status, n_resumed=resumed.n_resumed,
             files_after_stop=np.array(files_after_stop), mismatch=mismatch)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_sweep")
    mp.spawn(_sweep_rank, args=(str(d / "rendezvous"), str(d)), nprocs=2, join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


def test_sharded_sweep_matches_unsharded(sweep_problem, sharded_ranks, jax_whole):
    A, b, c = sweep_problem
    plain = sweep(A, b, c, SolverOptions(tol=1e-8), chunk=16)
    for res in sharded_ranks:
        np.testing.assert_array_equal(res["whole_status"], plain.status)
        np.testing.assert_allclose(res["whole_objective"], plain.objective, rtol=1e-8, atol=1e-9)
        np.testing.assert_array_equal(res["whole_status"], jax_whole.status)
        # resumed equals uninterrupted, bitwise
        np.testing.assert_array_equal(res["resumed_objective"], res["whole_objective"])
        np.testing.assert_array_equal(res["resumed_status"], res["whole_status"])
        assert int(res["n_resumed"]) == 1
    # rank 0 wrote the first chunk and the manifest before its stop (rank 1
    # may have looked before rank 0 got there: it reads only after rank 0's
    # broadcast)
    files = list(sharded_ranks[0]["files_after_stop"])
    assert files == ["chunk_000000.npz", "manifest.json"]


def test_mesh_raises(sharded_ranks):
    """A sharded sweep into a directory of another configuration raises
    on every rank (rank 0 checks, the verdict is broadcast)."""
    for res in sharded_ranks:
        assert "different configuration" in str(res["mismatch"])
