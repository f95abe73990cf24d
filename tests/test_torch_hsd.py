"""Port parity: the HSD core and the registry solvers.

* one Newton step (``_make_step_fn``) from an identical interior state,
  carried across with ``interop.state_from_numpy``, in f64 to 1e-10;
* whole f64 solves (``hsd_solve_batched``, the no-cap and the narrow
  cap/compact ``hsd_solve_scan``) on the reference kernel sets: statuses
  and iteration counts identical, objectives to 1e-9;
* the f32 registry solver ``hsd_pallas`` (CUDA set, run on the CPU
  through the kernels' plain versions) against the JAX ``hsd_pallas``
  (Pallas in interpret mode): at least 98% of statuses agree, and
  objectives agree to 1e-4 relative where the statuses agree.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycllp_tpu as ref_pkg
import pycllp_tpu_torch as port_pkg
from pycllp_tpu.io.generate import random_equality_lp, random_standard_lp
from pycllp_tpu.ops.reference import REFERENCE_KERNELS as REF_KS
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import interop
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS
from pycllp_tpu_torch.solvers import hsd as port_hsd

# bench.py's BENCH_FINISH=0 operating point
NARROW_KW = dict(
    dtype="float32", tol=1e-5, maxiter=40, stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, init_point="mehrotra",
)


def _to_np(d):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}


def _assert_same_solve(ref_out, port_out):
    ref_out, port_out = _to_np(ref_out), _to_np(port_out)
    np.testing.assert_array_equal(port_out["status"], ref_out["status"])
    np.testing.assert_array_equal(port_out["iterations"], ref_out["iterations"])
    np.testing.assert_allclose(port_out["objective"], ref_out["objective"], rtol=1e-9, atol=1e-9)


def test_options_carry_over():
    ref_opts = ref_pkg.SolverOptions(**NARROW_KW, gondzio_correctors=1)
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    assert dataclasses.asdict(opts) == dataclasses.asdict(ref_opts)
    with pytest.raises(ValueError):
        interop.options_from_reference({**dataclasses.asdict(ref_opts), "no_such_knob": 1})


def test_newton_step_matches_jax_f64():
    A, _, _ = random_equality_lp(8, 20, seed=21)
    rng = np.random.default_rng(22)
    B = 12
    b = rng.uniform(0.1, 1.0, size=(B, 20)) @ A.T
    c = rng.normal(size=(B, 8)) @ A + rng.uniform(0.1, 1.0, size=(B, 20))
    ref_opts = ref_pkg.SolverOptions(
        tol=1e-12, init_point="mehrotra", kkt_refine=3, kkt_refine_pred=0,
        gondzio_correctors=1,
    )
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))

    # a mid-trajectory interior state from the reference: start + 2 iterations
    ctx = REF_KS.prepare(jnp.asarray(A))
    bj, cj = jnp.asarray(b), jnp.asarray(c)
    state = ref_hsd._fresh_state(ctx, bj, cj, ref_opts, REF_KS, jnp.float64)
    state = ref_hsd._run_phase(ctx, bj, cj, state, ref_opts, REF_KS, jnp.float64,
                               ref_opts.tol, 2, jnp.any)
    fields = {f: np.asarray(v) for f, v in state._asdict().items()}

    ref_step = ref_hsd._make_step_fn(ctx, bj, cj, ref_opts, REF_KS, jnp.float64)
    res = ref_hsd._residuals(ctx, bj, cj, state.x, state.y, state.z, state.tau, state.kappa, REF_KS)
    ref_new = ref_step(state.x, state.y, state.z, state.tau, state.kappa, *res)

    s = interop.state_from_numpy(fields, device="cpu")
    assert s.k == 2 and s.status.dtype == torch.int32
    assert interop.state_to_numpy(s).keys() == fields.keys()
    pctx = REFERENCE_KERNELS.prepare(torch.from_numpy(A))
    bt, ct = torch.from_numpy(b), torch.from_numpy(c)
    step = port_hsd._make_step_fn(pctx, bt, ct, opts, REFERENCE_KERNELS, torch.float64)
    pres = port_hsd._residuals(pctx, bt, ct, s.x, s.y, s.z, s.tau, s.kappa, REFERENCE_KERNELS)
    new = step(s.x, s.y, s.z, s.tau, s.kappa, *pres)
    for name, a, r in zip(("x", "y", "z", "tau", "kappa"), new, ref_new):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10, err_msg=name)

    # the same state, folded to its best iterate and cast down, in both packages
    ref_fold = ref_hsd._fold_to_best(ctx, bj, cj, state, REF_KS)
    fold = port_hsd._fold_to_best(pctx, bt, ct, s, REFERENCE_KERNELS)
    for name in ("x", "y", "z", "tau", "kappa"):
        np.testing.assert_allclose(getattr(fold, name).numpy(), np.asarray(getattr(ref_fold, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    narrow = port_hsd._cast_state(s, torch.float32)
    assert narrow.x.dtype == torch.float32 and narrow.status.dtype == torch.int32 and narrow.k == 2


@pytest.mark.parametrize(
    "init_point,shared_A", [("ones", True), ("mehrotra", True), ("mehrotra", False)]
)
def test_hsd_solve_batched_matches_jax_f64(init_point, shared_A):
    A, b, c = random_equality_lp(10, 24, nlp=16, seed=5, shared_A=shared_A)
    ref_opts = ref_pkg.SolverOptions(tol=1e-8, init_point=init_point, kkt_refine=1)
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    ref_out = ref_hsd.hsd_solve_batched(A, b, c, ref_opts, REF_KS)
    port_out = port_hsd.hsd_solve_batched(A, b, c, opts, REFERENCE_KERNELS, device="cpu")
    assert (np.asarray(ref_out["status"]) == int(ref_pkg.Status.OPTIMAL)).all()
    _assert_same_solve(ref_out, port_out)
    np.testing.assert_allclose(port_out["x"].numpy(), np.asarray(ref_out["x"]), rtol=1e-7, atol=1e-7)


def test_hsd_solve_unbatched_matches_jax_f64():
    A, b, c = random_equality_lp(6, 14, seed=8)
    ref_out = ref_hsd.hsd_solve(A, b, c, ref_pkg.SolverOptions(tol=1e-8))
    port_out = port_hsd.hsd_solve(A, b, c, port_pkg.SolverOptions(tol=1e-8), device="cpu")
    assert port_out["x"].shape == (14,) and port_out["objective"].shape == ()
    _assert_same_solve(ref_out, port_out)


@pytest.mark.parametrize(
    "compact_cap,warm_chain", [(5, False), (None, False), (None, True), (5, True)]
)
def test_hsd_solve_scan_matches_jax_f64(compact_cap, warm_chain):
    lp = random_standard_lp(10, 12, nlp=150, seed=6)
    eq = lp.to_equality_form()
    A, b, c = (np.asarray(v) for v in (eq.A, eq.b, eq.c))
    # tol 1e-7: at 1e-8 a warm-chained lane sits on its stall floor
    # (rho_p ~1.22e-8), where rounding alone moves the stall by an iteration
    ref_opts = ref_pkg.SolverOptions(tol=1e-7, stall_patience=6)
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    kw = dict(chunk=64, compact_cap=compact_cap, compact_bucket=32, warm_chain=warm_chain,
              keys=("objective", "status", "iterations"))
    ref_out = ref_hsd.hsd_solve_scan(A, b, c, ref_opts, REF_KS, **kw)
    port_out = port_hsd.hsd_solve_scan(A, b, c, opts, REFERENCE_KERNELS, device="cpu", **kw)
    assert port_out["status"].shape == (150,)  # padded to 192 lanes, trimmed back
    if compact_cap is not None and not warm_chain:
        # the cap and the 32-lane bucket both bind: lanes resumed past the
        # cap, and overflow lanes kept their capped answer
        it = np.asarray(ref_out["iterations"])
        assert it.max() > compact_cap
        assert (np.asarray(ref_out["status"]) == int(ref_pkg.Status.ITERATION_LIMIT)).any()
    _assert_same_solve(ref_out, port_out)


def test_registry_cuda_set_on_cpu_matches_jax_pallas():
    lp = random_standard_lp(8, 8, nlp=256, seed=3)
    kw = dict(NARROW_KW, chunk=128, compact_cap=12, compact_bucket=64)
    ref = ref_pkg.get_solver("hsd_pallas", **kw)
    ref.init(lp)
    ref_sol = ref.solve()
    port = port_pkg.get_solver("hsd_pallas", device="cpu", **kw)
    assert type(port).__name__ == "CudaHSDSolver"
    port.init(lp)
    sol = port.solve()
    same = np.asarray(sol.status) == np.asarray(ref_sol.status)
    assert same.mean() >= 0.98
    assert (np.asarray(sol.status) == int(port_pkg.Status.OPTIMAL)).mean() > 0.9
    np.testing.assert_allclose(
        sol.objective[same], np.asarray(ref_sol.objective)[same], rtol=1e-4, atol=1e-4
    )


def test_registry_warm_resolve_matches_jax_f64():
    """init once, solve, perturb b, solve again from the cached warm point."""
    kw = dict(tol=1e-8, warm_start=True)
    ref, port = ref_pkg.get_solver("hsd", **kw), port_pkg.get_solver("hsd", device="cpu", **kw)
    lp_ref = random_standard_lp(6, 9, nlp=12, seed=4)
    lp_port = port_pkg.StandardLP(A=lp_ref.A, b=lp_ref.b, c=lp_ref.c)
    ref.init(lp_ref)
    port.init(lp_port)
    for scale in (1.0, 1.05):
        lp_ref.b = lp_port.b = np.asarray(random_standard_lp(6, 9, nlp=12, seed=4).b) * scale
        ref_sol, sol = ref.solve(), port.solve()
        np.testing.assert_array_equal(sol.status, np.asarray(ref_sol.status))
        np.testing.assert_array_equal(sol.iterations, np.asarray(ref_sol.iterations))
        np.testing.assert_allclose(sol.objective, np.asarray(ref_sol.objective), rtol=1e-9, atol=1e-9)
    assert port._warm is not None
