"""Port parity: the wide f64 finish of the HSD solve (solvers/hsd.py).

* ``hsd_solve_batched`` with a finish, crossover and ipm modes, on the
  reference kernel sets of both packages: statuses agree on ≥ 98% of
  lanes, objectives agree to 1e-7 relative where the statuses agree, and
  every lane is within 1e-6 of scipy;
* ``hsd_solve_scan`` with a finish (stage 3 per chunk, the drain tiers or
  the gated compact rounds, the bucketed packaging), same bounds;
* ``_compact_resume(restart=True)`` and ``_package_bucketed`` with an
  overflowing bucket, from one numpy state carried across with
  ``interop.state_from_numpy``: the same statuses as the JAX functions,
  including ``_package_bucketed``'s status divergence from ``_package``
  for lanes beyond the bucket;
* one composed run of ``bench.py``'s default options: the port's CUDA
  kernel set on the CPU (the plain versions of chol/solve, the FP64
  factor/solve and the slicing; the mixed1, Ozaki and df64 sets) against
  the JAX ``BATCHLAST_KERNELS`` with Pallas in interpret mode: statuses
  agree on ≥ 98% of lanes, objectives to 1e-6 where both are OPTIMAL.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

import jax.numpy as jnp

import pycllp_tpu as ref_pkg
import pycllp_tpu_torch as port_pkg
from pycllp_tpu.io.generate import random_equality_lp, random_standard_lp
from pycllp_tpu.ops.batchlast import BATCHLAST_KERNELS as REF_BL
from pycllp_tpu.ops.reference import REFERENCE_KERNELS as REF_KS
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import interop
from pycllp_tpu_torch.ops import df64
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS
from pycllp_tpu_torch.solvers import hsd as port_hsd

OPTIMAL = int(port_pkg.Status.OPTIMAL)
STALLED = int(port_pkg.Status.STALLED)
RUNNING = int(port_pkg.Status.RUNNING)
NUMERICAL = int(port_pkg.Status.NUMERICAL)
ITERATION_LIMIT = int(port_pkg.Status.ITERATION_LIMIT)

# bench.py's bench_options() at its defaults (BENCH_FINISH=1)
BENCH_OPTIONS = dict(
    tol=1e-6, maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, kkt_warmup=0, gondzio_correctors=0,
    init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5, finish_maxiter=20,
    finish_gondzio=0, finish_mode="crossover", crossover_kset="mixed1", crossover_repair=2,
    crossover_refine=2, crossover_feas_tol=1e-9, finish_kkt_refine=0,
)


def _finish_opts(mode, **kw):
    """tests/test_crossover.py's finish options, in both packages."""
    ref = ref_pkg.SolverOptions(
        tol=2e-7, maxiter=40, dtype="float32", finish_dtype="float64", switch_tol=1e-5,
        stall_patience=3, stall_rtol=0.05, refine_steps=0, init_point="mehrotra",
        finish_mode=mode, **kw,
    )
    return ref, interop.options_from_reference(dataclasses.asdict(ref))


def _eq32(lp):
    eq = lp.to_equality_form()
    return tuple(np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _scipy_rel_errs(lp, objective):
    """Relative objective error of every lane against scipy highs."""
    n = np.asarray(lp.A).shape[1]
    rels = []
    for i in range(np.asarray(lp.b).shape[0]):
        res = linprog(-np.asarray(lp.c, np.float64)[i], A_ub=np.asarray(lp.A, np.float64),
                      b_ub=np.asarray(lp.b, np.float64)[i], bounds=[(0, None)] * n,
                      method="highs")
        assert res.status == 0
        rels.append(abs(-float(objective[i]) + res.fun) / max(1.0, abs(res.fun)))
    return np.asarray(rels)


def _assert_agree(ref_out, port_out, obj_rtol, both_optimal=False):
    rs, ps = _np(ref_out["status"]), _np(port_out["status"])
    same = rs == ps
    assert same.mean() >= 0.98, (np.unique(rs, return_counts=True), np.unique(ps, return_counts=True))
    mask = same & (rs == OPTIMAL) if both_optimal else same
    ro, po = _np(ref_out["objective"]), _np(port_out["objective"])
    np.testing.assert_allclose(po[mask], ro[mask], rtol=obj_rtol, atol=obj_rtol)


@pytest.mark.parametrize("mode", ["crossover", "ipm"])
def test_batched_finish_matches_jax_reference_sets(mode):
    lp = random_standard_lp(24, 36, nlp=48, seed=5, dtype=np.float32)
    A, b, c = _eq32(lp)
    ref_opts, opts = _finish_opts(mode)
    ref_out = ref_hsd.hsd_solve_batched(A, b, c, ref_opts, REF_KS)
    port_out = port_hsd.hsd_solve_batched(A, b, c, opts, REFERENCE_KERNELS, device="cpu")
    assert port_out["x"].dtype == torch.float64  # the answer comes from the wide phase
    _assert_agree(ref_out, port_out, 1e-7)
    assert (_np(port_out["status"]) == OPTIMAL).all()
    assert _scipy_rel_errs(lp, _np(port_out["objective"])).max() <= 1e-6


@pytest.mark.parametrize("mode", ["crossover", "ipm"])
def test_scan_finish_matches_jax_reference_sets(mode):
    lp = random_standard_lp(24, 36, nlp=64, seed=6, dtype=np.float32)
    A, b, c = _eq32(lp)
    ref_opts, opts = _finish_opts(mode)
    kw = dict(chunk=32, compact_cap=8, compact_bucket=32, finish_cap=3, finish_bucket=16,
              keys=("objective", "status", "iterations"))
    ref_out = ref_hsd.hsd_solve_scan(A, b, c, ref_opts, REF_KS, **kw)
    port_out = port_hsd.hsd_solve_scan(A, b, c, opts, REFERENCE_KERNELS, device="cpu", **kw)
    _assert_agree(ref_out, port_out, 1e-7)
    assert (_np(port_out["status"]) == OPTIMAL).all()
    assert _scipy_rel_errs(lp, _np(port_out["objective"])).max() <= 1e-6


def _mid_state(maxiter, tol=1e-8):
    """An f64 HSD state of the reference after ``maxiter`` iterations, as numpy."""
    A, b, c = random_equality_lp(10, 22, nlp=40, seed=21)
    opts = ref_pkg.SolverOptions(tol=tol, init_point="mehrotra")
    ctx = REF_KS.prepare(jnp.asarray(A))
    bj, cj = jnp.asarray(b), jnp.asarray(c)
    state = ref_hsd._fresh_state(ctx, bj, cj, opts, REF_KS, jnp.float64)
    state = ref_hsd._run_phase(ctx, bj, cj, state, opts, REF_KS, jnp.float64, tol, maxiter, jnp.any)
    return (A, b, c), opts, {f: np.array(v) for f, v in state._asdict().items()}


def _pair(data, fields):
    """The same problem and state in both packages."""
    A, b, c = data
    ref = (REF_KS.prepare(jnp.asarray(A)), jnp.asarray(b), jnp.asarray(c),
           ref_hsd.HSDState(**{f: jnp.asarray(v) for f, v in fields.items()}))
    port = (REFERENCE_KERNELS.prepare(torch.from_numpy(A)), torch.from_numpy(b),
            torch.from_numpy(c), interop.state_from_numpy(fields, device="cpu"))
    return ref, port


def test_compact_resume_restart_matches_jax():
    data, ref_opts, fields = _mid_state(maxiter=5)
    status = fields["status"]
    assert (status == RUNNING).all()
    status[:8] = STALLED  # stuck lanes: cold Mehrotra restart
    status[8:12] = NUMERICAL
    status[30:] = OPTIMAL  # finished lanes stay out of the bucket
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    (rctx, rb, rc, rstate), (pctx, pb, pc, pstate) = _pair(data, fields)
    # bucket 24 of 30 retry lanes: the last 6 RUNNING lanes overflow
    ref = ref_hsd._compact_resume(rctx, rb, rc, rstate, ref_opts, REF_KS, jnp.float64, 1e-8, 25, 24,
                                  restart=True)
    port = port_hsd._compact_resume(pctx, pb, pc, pstate, opts, REFERENCE_KERNELS, torch.float64,
                                    1e-8, 25, 24, restart=True)
    np.testing.assert_array_equal(port.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(port.iterations.numpy(), np.asarray(ref.iterations))
    assert port.k == int(ref.k)
    st = port.status.numpy()
    assert (st[:24] == OPTIMAL).all()  # restarted or resumed, then converged
    assert (st[24:30] == RUNNING).all() and (st[30:] == OPTIMAL).all()  # overflow / untouched
    np.testing.assert_array_equal(port.x.numpy()[24:], fields["x"][24:])
    # late-IPM iterates amplify rounding-order differences (1.5e-7 seen);
    # the objectives they give agree far closer
    x, ref_x = port.x.numpy()[:24], np.asarray(ref.x)[:24]
    np.testing.assert_allclose(x, ref_x, rtol=0, atol=1e-6)
    c, tau, ref_tau = data[2][:24], port.tau.numpy()[:24], np.asarray(ref.tau)[:24]
    np.testing.assert_allclose((c * x).sum(-1) / tau, (c * ref_x).sum(-1) / ref_tau, rtol=1e-9)


def test_package_bucketed_overflow_matches_jax():
    data, ref_opts, fields = _mid_state(maxiter=40)
    assert (fields["status"] == OPTIMAL).all()
    fields["status"][:12] = STALLED  # converged iterates, labelled STALLED
    fields["status"][12:16] = RUNNING
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    (rctx, rb, rc, rstate), (pctx, pb, pc, pstate) = _pair(data, fields)
    bucket = 6  # 16 non-terminal lanes overflow it
    c_orig = data[2]
    ref = ref_hsd._package_bucketed(rctx, rb, rc, rstate, REF_KS, ref_opts, None,
                                    jnp.asarray(c_orig), bucket)
    port = port_hsd._package_bucketed(pctx, pb, pc, pstate, REFERENCE_KERNELS, opts, None,
                                      torch.from_numpy(c_orig), bucket)
    st = port["status"].numpy()
    np.testing.assert_array_equal(st, np.asarray(ref["status"]))
    np.testing.assert_allclose(port["objective"].numpy(), np.asarray(ref["objective"]), rtol=1e-12)
    assert "rho_p" not in port
    # the divergence from _package, reproduced: the gathered lanes are
    # reclassified OPTIMAL, the STALLED lanes beyond the bucket keep their
    # status and the RUNNING ones become ITERATION_LIMIT
    full = port_hsd._package(pctx, pb, pc, pstate, REFERENCE_KERNELS, opts, None,
                             torch.from_numpy(c_orig))["status"].numpy()
    assert (full == OPTIMAL).all()
    assert (st[:bucket] == OPTIMAL).all()
    assert (st[bucket:12] == STALLED).all() and (st[12:16] == ITERATION_LIMIT).all()
    assert (st[16:] == OPTIMAL).all()


def test_composed_bench_options_match_jax_pallas_interpret():
    """The main path's configuration end to end: the port's CUDA kernel set
    (plain versions on the CPU) against the JAX Pallas kernels (interpret)."""
    lp = random_standard_lp(6, 6, nlp=128, seed=3, dtype=np.float32)
    A, b, c = _eq32(lp)
    ref_opts = ref_pkg.SolverOptions(**BENCH_OPTIONS)
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    assert opts == port_pkg.SolverOptions(**BENCH_OPTIONS)
    kw = dict(chunk=64, compact_cap=12, compact_bucket=32, finish_cap=3, finish_bucket=16,
              keys=("objective", "status", "iterations"))
    ref_out = ref_hsd.hsd_solve_scan(A, b, c, ref_opts, REF_BL, **kw)
    port_out = port_hsd.hsd_solve_scan(A, b, c, opts, BATCHLAST_KERNELS, device="cpu", **kw)
    _assert_agree(ref_out, port_out, 1e-6, both_optimal=True)
    assert (_np(port_out["status"]) == OPTIMAL).mean() >= 0.98


def test_drain_tiers_and_registry_finish_on_cpu(capsys, monkeypatch):
    """A batch whose rejects reach the df64 drain tiers, through the
    registry with a finish and through hsd_solve_scan with stage_sync."""
    factors = []

    def counted(M, reg):
        factors.append(M.shape[-1])
        return df64._df_chol_bl_plain(M, reg)

    monkeypatch.setattr(df64, "df_chol_bl", counted)
    lp = random_standard_lp(16, 16, nlp=96, seed=1, dtype=np.float32)
    A, b, c = _eq32(lp)
    opts = port_pkg.SolverOptions(**BENCH_OPTIONS)
    # stage 3 only: rejects are still RUNNING, the tiers have work to do
    dtype = torch.float32
    b3, c3 = torch.from_numpy(b).reshape(2, 48, -1), torch.from_numpy(c).reshape(2, 48, -1)
    with port_hsd._full_precision_matmuls():
        sflat = port_hsd._hsd_scan_narrow_core(
            A, b3, c3, port_hsd._narrow_opts_view(opts, 1e-5), BATCHLAST_KERNELS, None, 12, 32,
            torch.device("cpu"))
        assert sflat.x.dtype == dtype
        stage3 = port_hsd._hsd_scan_finish_core(
            A, b3, c3, sflat, port_hsd._finish_opts_view(opts), BATCHLAST_KERNELS,
            ("status",), 3, 16, torch.device("cpu"), truncate="stage3")
    assert (stage3["status"] != OPTIMAL).any()
    # without repair, tier 0 is skipped and the stage-3 rejects go to the
    # df64 tiers 1-2
    out = port_hsd.hsd_solve_scan(A, b, c, opts.replace(crossover_repair=0), BATCHLAST_KERNELS,
                                  chunk=48, compact_cap=12, compact_bucket=32, finish_cap=3,
                                  finish_bucket=16, keys=("objective", "status"), device="cpu",
                                  stage_sync=True)
    err = capsys.readouterr().err
    assert "[scan] narrow stage:" in err and "[scan] finish stage:" in err
    assert factors and max(factors) <= 16  # the df64 tiers ran, on gathered buckets
    assert (_np(out["status"]) == OPTIMAL).all()
    assert _scipy_rel_errs(lp, _np(out["objective"])).max() <= 1e-6
    # the registry's scan path with a finish (finish_cap / finish_bucket at
    # their defaults, as the reference's registry leaves them)
    kw = {k: v for k, v in BENCH_OPTIONS.items()}
    solver = port_pkg.get_solver("hsd_pallas", device="cpu", chunk=48, compact_cap=12,
                                 compact_bucket=32, **kw)
    solver.init(lp)
    sol = solver.solve()
    assert (np.asarray(sol.status) == OPTIMAL).all()
    assert sol.x.dtype == np.float64
    assert _scipy_rel_errs(lp, -sol.objective).max() <= 1e-6


def test_batched_A_crossover_finish_on_cpu():
    """Per-instance (B, m, n) A through the default crossover config: the
    mixed1 engine refines each RHS of its k=2 solves separately."""
    lp = random_standard_lp(12, 18, nlp=6, seed=8, dtype=np.float32)
    A2, b, c = _eq32(lp)
    A3 = np.broadcast_to(A2, (6,) + A2.shape).copy()
    _, opts = _finish_opts("crossover")
    out = port_hsd.hsd_solve_batched(A3, b, c, opts, BATCHLAST_KERNELS, device="cpu")
    assert (_np(out["status"]) == OPTIMAL).all()
    assert _scipy_rel_errs(lp, _np(out["objective"])).max() <= 1e-6


def test_unported_finish_options_raise():
    """The fast-formation set (the reference's recorded negative result)
    runs in both finish roles, through both packages on the same inputs,
    the JAX Pallas kernels in interpret mode.

    * ``crossover_kset="df64_fastform"``: statuses equal, objectives to 1e-9.
    * ``finish_kset="df64_fastform"`` (the wide IPM factors on it): the
      negative result reproduced, at least half the lanes NUMERICAL in
      both packages.  Which lanes break down depends on the f32 GEMMs'
      summation order, which the packages do not share, so statuses are
      held to 90% agreement and objectives to 1e-6 where both are OPTIMAL.
    """
    lp = random_standard_lp(6, 6, nlp=32, seed=3, dtype=np.float32)
    A, b, c = _eq32(lp)
    for mode, kw, agree, rtol in (("crossover", dict(crossover_kset="df64_fastform"), 1.0, 1e-9),
                                  ("ipm", dict(finish_kset="df64_fastform"), 0.9, 1e-6)):
        ref_opts, opts = _finish_opts(mode, **kw)
        ref_out = ref_hsd.hsd_solve_batched(A, b, c, ref_opts, REF_BL)
        port_out = port_hsd.hsd_solve_batched(A, b, c, opts, BATCHLAST_KERNELS, device="cpu")
        rs, ps = _np(ref_out["status"]), _np(port_out["status"])
        assert (rs == ps).mean() >= agree, (kw, rs, ps)
        both = (rs == OPTIMAL) & (ps == OPTIMAL)
        np.testing.assert_allclose(_np(port_out["objective"])[both], _np(ref_out["objective"])[both],
                                   rtol=rtol, atol=rtol)
        if mode == "ipm":
            assert (rs == NUMERICAL).mean() >= 0.5 and (ps == NUMERICAL).mean() >= 0.5, (rs, ps)
        else:
            assert both.all()
        out = port_hsd.hsd_solve_scan(A, b, c, opts, BATCHLAST_KERNELS, chunk=16, compact_cap=3,
                                      device="cpu", keys=("objective", "status"))
        assert out["status"].shape == (32,) and out["objective"].dtype == torch.float64
