"""Port parity: the netlib fixtures (io/netlib.py) and config 4's solves.

* fixtures, ``bucket_problems`` and ``pad_and_mask`` are bit-identical
  across the packages (the fixtures are seeded by ``zlib.crc32`` through
  ``io/generate.random_standard_lp``), and ``PYCLLP_NETLIB_DIR`` is
  honoured by both;
* the full GeneralLP → StandardLP → registry chain on ``device="cpu"``
  reaches the pinned ``FIXTURE_OBJECTIVES`` to 1e-6 relative;
* padding is benign: the padded per-instance batch reproduces each
  fixture's optimum to 1e-6, pad columns stay at zero (1e-7);
* ``bench.py``'s ``run_netlib`` at 8 replicas per fixture: one shared-A
  narrow + f64 crossover finish solve per bucket on the port's
  ``BATCHLAST_KERNELS`` (their plain versions on the CPU) against the
  reference's ``BATCHLAST_KERNELS`` (Pallas in interpret mode): equal
  statuses, objectives to 1e-6 relative.  The JAX side runs its finish
  on the reference sets (``finish_kset``/``crossover_kset="reference"``):
  interpret-mode Pallas in the mixed1 and df64 finish costs ~100 s of
  compile per fixture on the CPU, so its narrow stage is the one held
  kernel for kernel (the port runs the same option pair too, and the
  bench's own mixed1/df64 finish, both held to 1e-6).  The padded
  per-instance batch of the same replicas on the port's set equals the
  bucketed objectives to 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pycllp_tpu as ref_pkg
import pycllp_tpu_torch as port_pkg
from pycllp_tpu.io import netlib as ref_netlib
from pycllp_tpu.ops.batchlast import BATCHLAST_KERNELS as REF_BL
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import interop
from pycllp_tpu_torch.io import mps as port_mps
from pycllp_tpu_torch.io import netlib
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.solvers.hsd import hsd_solve_batched

NAMES = netlib.fixture_names()

# bench.py's bench_options() at its defaults (BENCH_FINISH=1)
BENCH_OPTIONS = dict(
    tol=1e-6, maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, kkt_warmup=0, gondzio_correctors=0,
    init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5, finish_maxiter=20,
    finish_gondzio=0, finish_mode="crossover", crossover_kset="mixed1", crossover_repair=2,
    crossover_refine=2, crossover_feas_tol=1e-9, finish_kkt_refine=0,
)


def _stds(mod):
    return [mod.load_fixture(nm).lp.to_standard_form()[0] for nm in NAMES]


def _rel(a, ref):
    return abs(a - ref) / max(1.0, abs(ref))


def test_constants_match_reference():
    assert netlib.NETLIB_SCALES == ref_netlib.NETLIB_SCALES
    assert netlib.FIXTURE_OBJECTIVES == ref_netlib.FIXTURE_OBJECTIVES
    assert netlib.REAL_NETLIB_OBJECTIVES == ref_netlib.REAL_NETLIB_OBJECTIVES
    assert NAMES == ref_netlib.fixture_names()
    with pytest.raises(KeyError, match="unknown fixture"):
        netlib.load_fixture("no_such_lp")


@pytest.mark.parametrize("name", NAMES)
def test_fixture_bit_identical(name):
    port, ref = netlib.load_fixture(name), ref_netlib.load_fixture(name)
    assert (port.name, port.row_names, port.col_names) == (ref.name, ref.row_names, ref.col_names)
    for f in ("A", "row_lb", "row_ub", "c", "lb", "ub"):
        np.testing.assert_array_equal(getattr(port.lp, f), getattr(ref.lp, f), err_msg=f)
    ps, rs = port.lp.to_standard_form()[0], ref.lp.to_standard_form()[0]
    for f in ("A", "b", "c"):
        np.testing.assert_array_equal(np.asarray(getattr(ps, f)), np.asarray(getattr(rs, f)))
    assert (ps.nrows, ps.ncols) == netlib.NETLIB_SCALES[name]


def test_netlib_dir_lookup(tmp_path, monkeypatch):
    """A file in PYCLLP_NETLIB_DIR replaces the stand-in, in both packages."""
    lp = port_pkg.GeneralLP(A=[[1.0, 2.0], [3.0, 1.0]], row_lb=[2.0, 3.0], c=[1.0, 1.0])
    (tmp_path / "afiro.mps").write_text(port_mps.write_mps(lp, name="REAL-AFIRO"))
    monkeypatch.setenv("PYCLLP_NETLIB_DIR", str(tmp_path))
    port, ref = netlib.load_fixture("afiro"), ref_netlib.load_fixture("afiro")
    assert port.name == ref.name == "REAL-AFIRO"
    np.testing.assert_array_equal(port.lp.A, ref.lp.A)
    # a name the directory lacks still falls back to the stand-in
    assert netlib.load_fixture("sc50a").shape == netlib.NETLIB_SCALES["sc50a"]


def test_buckets_and_padding_bit_identical():
    port, ref = _stds(netlib), _stds(ref_netlib)
    assert netlib.bucket_problems(port) == ref_netlib.bucket_problems(ref)
    assert netlib.bucket_problems(port, 16, 32) == ref_netlib.bucket_problems(ref, 16, 32)
    for dtype in (np.float32, np.float64):
        for p, r in zip(netlib.pad_and_mask(port, dtype), ref_netlib.pad_and_mask(ref, dtype)):
            assert p.dtype == r.dtype
            np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_optimum_through_full_chain(name):
    prob = netlib.load_fixture(name)
    solver = port_pkg.get_solver("hsd", tol=1e-9, device="cpu")
    solver.init(prob.lp)  # GeneralLP → StandardLP → equality form inside
    sol = solver.solve()
    assert int(sol.status) == int(port_pkg.Status.OPTIMAL)
    assert _rel(float(sol.objective), netlib.FIXTURE_OBJECTIVES[name]) < 1e-6


def _padded_equality(stds, dtype):
    """pad_and_mask, then a slack per row: per-instance (B, m, n + m) A."""
    A, b, c, _, col_mask = netlib.pad_and_mask(stds, dtype)
    B, m, _ = A.shape
    eye = np.broadcast_to(np.eye(m, dtype=dtype), (B, m, m))
    return (np.concatenate([A, eye], axis=2), b,
            np.concatenate([-c, np.zeros((B, m), dtype)], axis=1), col_mask)


def test_padding_is_benign():
    stds = _stds(netlib)
    A_eq, b, c_eq, col_mask = _padded_equality(stds, np.float64)
    out = hsd_solve_batched(A_eq, b, c_eq, port_pkg.SolverOptions(tol=1e-9), device="cpu")
    assert (out["status"] == int(port_pkg.Status.OPTIMAL)).all()
    n = col_mask.shape[1]
    for k, nm in enumerate(NAMES):
        assert _rel(-float(out["objective"][k]), netlib.FIXTURE_OBJECTIVES[nm]) < 1e-6
        pad_x = out["x"][k, :n][~torch.from_numpy(col_mask[k])]
        if pad_x.numel():
            assert float(pad_x.abs().max()) < 1e-7


REPS = 8


def _replicas():
    """bench.py's run_netlib data: per bucket (one fixture each), REPS
    replicas with b scaled by 1 + 0.1·U (default_rng(7)), in f32."""
    stds = _stds(netlib)
    rng = np.random.default_rng(7)
    buckets = netlib.bucket_problems(stds)
    staged = []
    for _, idxs in sorted(buckets.items()):
        assert len(idxs) == 1  # the three fixtures land in three buckets
        eq = stds[idxs[0]].to_equality_form()
        scale = (1.0 + 0.1 * rng.random((REPS, 1))).astype(np.float32)
        b = np.asarray(eq.b, np.float32).reshape(1, -1) * scale
        c = np.broadcast_to(np.asarray(eq.c, np.float32).reshape(1, -1), (REPS, eq.c.shape[-1]))
        staged.append((idxs[0], np.asarray(eq.A, np.float32), b, np.ascontiguousarray(c), scale))
    return stds, staged


def test_bench_netlib_batchlast_matches_jax_interpret():
    ref_opts = ref_pkg.SolverOptions(
        **BENCH_OPTIONS).replace(finish_kset="reference", crossover_kset="reference")
    ref_set_opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    opts = port_pkg.SolverOptions(**BENCH_OPTIONS)
    stds, staged = _replicas()
    bucketed = {}
    for i, A, b, c, scale in staged:
        ref = ref_hsd.hsd_solve_batched(A, b, c, ref_opts, REF_BL)
        ref_obj = np.asarray(ref["objective"])
        for o in (ref_set_opts, opts):
            out = hsd_solve_batched(A, b, c, o, BATCHLAST_KERNELS, device="cpu")
            st = out["status"].numpy()
            np.testing.assert_array_equal(st, np.asarray(ref["status"]), err_msg=NAMES[i])
            assert (st == int(port_pkg.Status.OPTIMAL)).all(), NAMES[i]
            obj = out["objective"].numpy()
            np.testing.assert_allclose(obj, ref_obj, rtol=1e-6, atol=1e-6, err_msg=NAMES[i])
        bucketed[i] = obj

    # the padded heterogeneous batch of the same replicas: per-instance A
    reps = [(i, s) for i, _, _, _, scale in staged for s in scale[:, 0]]
    A_eq, b, c_eq, _ = _padded_equality([stds[i] for i, _ in reps], np.float32)
    b = b * np.array([s for _, s in reps], np.float32)[:, None]
    # padded rows keep b = 1: only the real rows carry the replica's scale
    for k, (i, s) in enumerate(reps):
        b[k, stds[i].nrows:] = 1.0
    out = hsd_solve_batched(A_eq, b, c_eq, opts, BATCHLAST_KERNELS, device="cpu")
    assert (out["status"] == int(port_pkg.Status.OPTIMAL)).all()
    padded = out["objective"].numpy()
    for k, (i, _) in enumerate(reps):
        assert _rel(padded[k], bucketed[i][k % REPS]) < 1e-6, (NAMES[i], k)
