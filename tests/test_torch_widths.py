"""Port parity: the Ozaki widths, set for a solve.

The reference reads its widths from ``PYCLLP_OZAKI_BITS`` and
``PYCLLP_OZAKI_MV_BITS`` on every call; the port takes them as arguments
(``DoubleSingleKernels(bits=, mv_bits=)``, ``MixedPrecisionKernels(mv_bits=)``,
``BatchLastKernels(ozaki_bits=, ozaki_mv_bits=)`` and the registry
solvers), and its CLI maps the two variables to them.  Here the JAX side
runs with the variables set to 56 and 40 bits (the formation width whose
wide phase the reference's sizing note records as diverging, and a matvec
width below the default 48) and the port gets ``bits=56, mv_bits=40``.
The reference reads the variables at trace time and keeps them out of its
jit cache key, so every JAX call at these widths runs between two
``jax.clear_caches()``.

* ``ozaki_params`` / ``ozaki_mv_params`` equal at several n;
* the Ozaki products: the 56-bit formation within 1e-14 of the output
  scale of the reference's (the bound of ``tests/test_torch_df64.py``);
  the 40-bit matvecs within one unit of the last slice a term,
  n·2^(−s·n_slices) of max|W|·max|d| (the reference's CPU normalisation
  is off by an ulp, see the test); the slicing of one normalised pair
  bitwise equal; and each product different from the default width's;
* the df64 set's mv/rmv (1e-14 of the scale) and factor + solve (1e-7 at a
  1e±3 spread), the mixed set's mv/rmv and solves (1e-8): the bounds of
  the default-width tests;
* a small ``hsd_solve_scan`` whose wide finish is the df64 IPM: the JAX
  ``BATCHLAST_KERNELS`` (Pallas in interpret mode) against the port's CUDA
  set on the CPU, statuses agreeing on ≥ 98% of lanes and objectives to
  1e-7 where the statuses agree (the bounds of the reference-set scan
  parity in ``tests/test_torch_finish.py``);
* the default widths, given explicitly, select the very sets the default
  path runs, and give bitwise the same solve;
* the level cap: 200 bits raise ``ValueError`` at construction, and a width
  that exceeds the cap only at a long contraction raises before any
  iteration, on the CPU too.

The CLI's mapping of the two variables is tested in ``tests/test_torch_cli.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pycllp_tpu as ref_pkg
import pycllp_tpu_torch as port_pkg
from pycllp_tpu.io.generate import random_standard_lp
from pycllp_tpu.ops import df64 as ref_df64
from pycllp_tpu.ops import mixed as ref_mixed
from pycllp_tpu.ops.batchlast import BATCHLAST_KERNELS as REF_BL
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import interop
from pycllp_tpu_torch.ops import batchlast as bl
from pycllp_tpu_torch.ops import df64, mixed
from pycllp_tpu_torch.solvers import hsd as port_hsd

BITS, MV_BITS = 56, 40
OPTIMAL = int(port_pkg.Status.OPTIMAL)


@pytest.fixture
def ref_widths(monkeypatch):
    """The reference at 56 / 40 bits, its jit caches cleared on the way in
    and out so that no program traced at another width is reused."""
    jax.clear_caches()
    monkeypatch.setenv("PYCLLP_OZAKI_BITS", str(BITS))
    monkeypatch.setenv("PYCLLP_OZAKI_MV_BITS", str(MV_BITS))
    yield
    jax.clear_caches()


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("n", [8, 27, 64, 128, 1024])
def test_ozaki_params_at_set_widths_match_reference(ref_widths, n):
    assert df64.ozaki_params(n, BITS) == ref_df64.ozaki_params(n)
    assert df64.ozaki_mv_params(n, MV_BITS) == ref_df64.ozaki_mv_params(n)
    if n == 128:  # the main path: 8 levels of 7 bits for the formation
        assert ref_df64.ozaki_params(n) == (7, 8, 9)


def _case(which, A, bits, mv_bits):
    m, n = A.shape
    if which == "mv":
        return A, df64.ozaki_mv_params(n, mv_bits)
    if which == "rmv":
        return np.ascontiguousarray(A.T), df64.ozaki_mv_params(m, mv_bits)
    return (A[:, None, :] * A[None, :, :]).reshape(m * m, n), df64.ozaki_params(n, bits)


@pytest.mark.parametrize("which", ["formation", "mv", "rmv"])
def test_ozaki_matmul_at_set_widths_matches_jax(ref_widths, which):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((8, 20))
    W, (s, n_slices, cut) = _case(which, A, BITS, MV_BITS)
    d = 10.0 ** rng.uniform(-30, 30, size=(128, W.shape[1]))
    d[0] = 0.0
    kw = dict(s=s, n_slices=n_slices, cut=cut)
    ref = np.asarray(ref_df64._ozaki_matmul(
        *ref_df64._ozaki_prepare(jnp.asarray(W), **kw), jnp.asarray(d.T), **kw))
    Wt, dt = _t(W, d)
    got = df64._ozaki_matmul(df64._ozaki_prepare(Wt, **kw), dt, **kw).numpy()
    assert not got[:, 0].any() and not ref[:, 0].any()
    got, ref = got[:, 1:], ref[:, 1:]
    if which == "formation":  # 56 bits: the default-width test's bound
        scale = np.abs(ref).max(axis=0, keepdims=True)
        assert (np.abs(got - ref) / scale).max() <= 1e-14
    else:
        # 40 bits (6 slices of 7): XLA's exp2 on the CPU is not exact at
        # integer arguments, so the reference's per-lane normalisation is
        # off by an ulp where the port's is an exact power of two, and now
        # and then a last slice rounds the other way: one unit of it moves
        # a product term by 2^(−s·n_slices) of max|W|·max|d| (2^−42 here,
        # where the default width's 2^−49 hides under 1e-14)
        scale = np.abs(W).max() * np.abs(d[1:]).max(axis=1)[None, :]
        assert (np.abs(got - ref) / scale).max() <= W.shape[1] * 2.0 ** (-s * n_slices)
    # the same normalised pair slices bitwise alike at this width
    hi, lo = (np.asarray(v) for v in ref_df64._split_hi_lo(jnp.asarray(rng.uniform(-1, 1, (20, 64)))))
    np.testing.assert_array_equal(
        np.stack([np.asarray(v) for v in ref_df64._slice_rounds_bl(
            jnp.asarray(hi), jnp.asarray(lo), s=s, n_slices=n_slices)]),
        df64._slice_rounds_bl_plain(*_t(hi, lo), s, n_slices).numpy())
    # the width is real: the default width's product differs
    _, dflt = _case(which, A, None, None)
    kd = dict(zip(("s", "n_slices", "cut"), dflt))
    other = df64._ozaki_matmul(df64._ozaki_prepare(Wt, **kd), dt, **kd).numpy()[:, 1:]
    assert dflt != (s, n_slices, cut) and (other != got).any()


@pytest.mark.parametrize("m,n,B", [(16, 24, 128), (12, 40, 64)])
def test_df64_set_at_set_widths_matches_jax(ref_widths, m, n, B):
    rng = np.random.default_rng(m + n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x, r = rng.standard_normal((B, n)), rng.standard_normal((B, m))
    d = 10.0 ** rng.uniform(-3, 3, size=(B, n))
    port = df64.DoubleSingleKernels(bits=BITS, mv_bits=MV_BITS)
    ref = ref_df64.DF64_FINISH_KERNELS
    At, xt, rt, dt = _t(A, x, r, d)
    ctx, ref_ctx = port.prepare(At), ref.prepare(jnp.asarray(A))
    for got, want in ((port.mv(ctx, xt), ref.mv(ref_ctx, jnp.asarray(x))),
                      (port.rmv(ctx, rt), ref.rmv(ref_ctx, jnp.asarray(r)))):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-14 * np.abs(want).max()
    (v,) = port.solve(port.factor(ctx, dt, 1e-12), (rt,))
    (v_ref,) = ref.solve(ref.factor(ref_ctx, jnp.asarray(d), 1e-12), (jnp.asarray(r),))
    v_ref = np.asarray(v_ref)
    assert (np.abs(v.numpy() - v_ref) / np.abs(v_ref).max(-1, keepdims=True)).max() < 1e-7
    # the widths reached the products: 40-bit matvecs differ from 48-bit ones
    dflt = df64.DF64_FINISH_KERNELS
    assert (dflt.mv(dflt.prepare(At), xt) != port.mv(ctx, xt)).any()


@pytest.mark.parametrize("ir_steps", [1, 3])
def test_mixed_set_at_set_widths_matches_jax(ref_widths, ir_steps):
    rng = np.random.default_rng(ir_steps)
    m, n, B = 10, 24, 96
    A = rng.standard_normal((m, n))
    d = rng.uniform(0.5, 2.0, size=(B, n))
    x = rng.standard_normal((B, n))
    rs = tuple(rng.standard_normal((B, m)) for _ in range(2))
    ref_k = ref_mixed.MixedPrecisionKernels(REF_BL, ir_steps=ir_steps)
    port_k = mixed.MixedPrecisionKernels(bl.BATCHLAST_KERNELS, ir_steps=ir_steps, mv_bits=MV_BITS)
    ref_ctx = ref_k.prepare(jnp.asarray(A))
    At, dt, xt = _t(A, d, x)
    ctx = port_k.prepare(At)
    for got, want in ((port_k.mv(ctx, xt), ref_k.mv(ref_ctx, jnp.asarray(x))),
                      (port_k.rmv(ctx, _t(rs[0])[0]), ref_k.rmv(ref_ctx, jnp.asarray(rs[0])))):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-14 * np.abs(want).max()
    ref_fac = ref_k.factor(ref_ctx, jnp.asarray(d), 1e-12)
    fac = port_k.factor(ctx, dt, 1e-12)
    for rhs in (rs[:1], rs):
        ref_v = ref_k.solve(ref_fac, tuple(jnp.asarray(r) for r in rhs))
        for a, b in zip(port_k.solve(fac, _t(*rhs)), ref_v):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() / np.abs(b).max() < 1e-8
    assert bl.BatchLastKernels(ozaki_mv_bits=MV_BITS).finish_kernels("mixed1").mv_bits == MV_BITS


# the df64 wide IPM finishes every lane (finish_mode="ipm": stage 3 is a
# capped wide IPM on the df64 set, whose formation takes the 56 bits)
SCAN_OPTIONS = dict(
    tol=2e-7, maxiter=40, dtype="float32", finish_dtype="float64", switch_tol=1e-5,
    stall_patience=3, stall_rtol=0.05, refine_steps=0, init_point="mehrotra",
    finish_mode="ipm", finish_kset="df64",
)
SCAN_KW = dict(chunk=32, compact_cap=8, compact_bucket=32, finish_cap=3, finish_bucket=16,
               keys=("objective", "status", "iterations"))


def _scan_lp():
    lp = random_standard_lp(6, 6, nlp=64, seed=7, dtype=np.float32)
    eq = lp.to_equality_form()
    return tuple(np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))


def test_df64_finish_scan_at_set_widths_matches_jax(ref_widths, monkeypatch):
    A, b, c = _scan_lp()
    ref_opts = ref_pkg.SolverOptions(**SCAN_OPTIONS)
    opts = interop.options_from_reference(dataclasses.asdict(ref_opts))
    widths = []
    real_formation = df64._ozaki_matmul

    def spy(W, d, *, s, n_slices, cut):
        widths.append((s, n_slices))
        return real_formation(W, d, s=s, n_slices=n_slices, cut=cut)

    monkeypatch.setattr(df64, "_ozaki_matmul", spy)
    ref_out = ref_hsd.hsd_solve_scan(A, b, c, ref_opts, REF_BL, **SCAN_KW)
    kset = bl.BatchLastKernels(ozaki_bits=BITS, ozaki_mv_bits=MV_BITS)
    port_out = port_hsd.hsd_solve_scan(A, b, c, opts, kset, device="cpu", **SCAN_KW)
    # the formation ran at 8 levels of 7 bits, the matvecs at 6
    assert (7, 8) in widths and (7, 6) in widths
    assert not {(7, 10), (7, 7)} & set(widths)  # no default-width product (n = 12, m = 6)
    rs, ps = np.asarray(ref_out["status"]), port_out["status"].numpy()
    same = rs == ps
    assert same.mean() >= 0.98, (np.unique(rs, return_counts=True), np.unique(ps, return_counts=True))
    assert (ps == OPTIMAL).mean() >= 0.9
    np.testing.assert_allclose(port_out["objective"].numpy()[same],
                               np.asarray(ref_out["objective"])[same], rtol=1e-7, atol=1e-7)


def test_default_widths_given_explicitly_change_nothing():
    explicit = bl.BatchLastKernels(ozaki_bits=df64.OZAKI_BITS, ozaki_mv_bits=df64.OZAKI_MV_BITS)
    for name in ("df64", "df64_f64form", "df64_fastform", "mixed", "mixed1", "reference"):
        assert explicit.finish_kernels(name) is bl.BATCHLAST_KERNELS.finish_kernels(name)
    assert df64.DoubleSingleKernels(bits=66, mv_bits=48).name == df64.DF64_FINISH_KERNELS.name
    A, b, c = _scan_lp()
    opts = port_pkg.SolverOptions(**SCAN_OPTIONS)
    want = port_hsd.hsd_solve_scan(A, b, c, opts, bl.BATCHLAST_KERNELS, device="cpu", **SCAN_KW)
    got = port_hsd.hsd_solve_scan(A, b, c, opts, explicit, device="cpu", **SCAN_KW)
    for key in SCAN_KW["keys"]:
        assert torch.equal(got[key], want[key]), key
    # the registry solver with the default widths runs the default set's finish
    solver = port_pkg.get_solver("hsd_pallas", device="cpu", ozaki_bits=66, ozaki_mv_bits=48)
    assert solver.kernels.finish_kernels() is df64.DF64_FINISH_KERNELS


def test_level_cap_raises_at_construction_on_the_cpu():
    # the reference has no cap: 200 bits at n = 128 are 40 slices of 5 bits
    assert ref_df64.ozaki_params(128, 200) == df64.ozaki_params(128, 200) == (5, 40, 41)
    for build in (lambda: df64.DoubleSingleKernels(bits=200),
                  lambda: df64.DoubleSingleKernels(form="f64", mv_bits=200),
                  lambda: mixed.MixedPrecisionKernels(bl.BATCHLAST_KERNELS, mv_bits=200),
                  lambda: bl.BatchLastKernels(ozaki_bits=200),
                  lambda: bl.BatchLastKernels(fuse_form=True, ozaki_mv_bits=200),
                  lambda: port_pkg.get_solver("hsd_pallas", device="cpu", ozaki_bits=200),
                  lambda: port_pkg.get_solver("hsd", device="cpu", ozaki_mv_bits=200)):
        with pytest.raises(ValueError, match="24 levels"):
            build()
    with pytest.raises(ValueError, match="positive integer"):
        df64.DoubleSingleKernels(bits=0)
    # 56 bits at n = 128: 8 levels, accepted
    df64.check_ozaki_levels(128, 56)
    with pytest.raises(ValueError, match="40 levels of 5 bits"):
        df64.check_ozaki_levels(128, 200)


def test_level_cap_raises_before_any_iteration(monkeypatch):
    """100 bits are 17 levels at n = 128 but 25 at n = 1,024: the width
    alone does not decide, so the set is built and its prepare raises; a
    solve raises before its narrow phase runs."""
    wide = df64.DoubleSingleKernels(bits=100)
    wide.prepare(torch.ones((2, 128), dtype=torch.float64))
    with pytest.raises(ValueError, match="25 levels"):
        wide.prepare(torch.ones((2, 1024), dtype=torch.float64))

    def no_iteration(*args, **kwargs):
        raise AssertionError("an iteration ran before the level cap was checked")

    monkeypatch.setattr(port_hsd, "_run_phase", no_iteration)
    monkeypatch.setattr(port_hsd, "_run_narrow_phase", no_iteration)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((2, 1024)).astype(np.float32)
    b, c = np.ones((4, 2), np.float32), rng.standard_normal((4, 1024)).astype(np.float32)
    opts = port_pkg.SolverOptions(**SCAN_OPTIONS)
    kset = bl.BatchLastKernels(ozaki_bits=100)
    with pytest.raises(ValueError, match="25 levels"):
        port_hsd.hsd_solve_scan(A, b, c, opts, kset, device="cpu", chunk=4, compact_cap=4)
    with pytest.raises(ValueError, match="25 levels"):
        port_hsd.hsd_solve_batched(A, b, c, opts, kset, device="cpu")
    # the matvec width reaches the crossover engine's check too
    with pytest.raises(ValueError, match="mv_bits"):
        port_hsd.hsd_solve_batched(A, b, c, opts.replace(finish_kset="df64_f64form"),
                                   bl.BatchLastKernels(ozaki_mv_bits=100), device="cpu")
