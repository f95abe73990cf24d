"""Port parity: the fused kernel sets (``fuse_form``, ``fuse_facsol``).

The port's ``BatchLastKernels(fuse_form=True)`` / ``(fuse_facsol=True)``
on CPU tensors — the plain versions of the CUDA ``fused_factor_bl`` and
``facsol_bl`` — against the JAX package's same sets, whose
``_fused_factor_bl`` / ``_facsol_bl`` Pallas kernels run in interpret
mode on the CPU, in f32 at rtol 2e-4 / atol 2e-5 (the bound of
tests/test_ops.py).  The kernels themselves run only on a card:
``chip_smoke.py`` holds them against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycllp_tpu as ref_pkg
from pycllp_tpu.io.generate import random_standard_lp
from pycllp_tpu.ops import batchlast as ref_bl
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import SolverOptions, Status
from pycllp_tpu_torch.ops import batchlast as bl
from pycllp_tpu_torch.ops.reference import NormalFactor
from pycllp_tpu_torch.solvers import hsd as port_hsd

F32_TOL = dict(rtol=2e-4, atol=2e-5)


def _problem(m, n, B, seed, dtype=np.float32, shared_A=True):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n) if shared_A else (B, m, n)).astype(dtype)
    d = rng.uniform(0.5, 2.0, size=(B, n)).astype(dtype)
    rs = tuple(rng.normal(size=(B, m)).astype(dtype) for _ in range(2))
    return A, d, rs


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_factor_close(fac, ref_fac, m, B):
    # the reference pads lanes to a multiple of 128; the port does not
    tril = np.tril(np.ones((m, m), bool))[..., None]
    ref_L = np.asarray(ref_fac.L)[..., :B]
    np.testing.assert_allclose(np.where(tril, fac.L.numpy(), 0), np.where(tril, ref_L, 0), **F32_TOL)
    np.testing.assert_allclose(fac.dinv_diag.numpy(), np.asarray(ref_fac.dinv_diag)[:, :B], **F32_TOL)


@pytest.mark.parametrize("m,n,B", [(8, 20, 128), (13, 30, 150)])
def test_fused_form_factor_matches_pallas_interpret(m, n, B):
    A, d, rs = _problem(m, n, B, seed=m + n)
    ref_ctx = ref_bl.BATCHLAST_FUSED_KERNELS.prepare(jnp.asarray(A))
    ref_fac = ref_bl.BATCHLAST_FUSED_KERNELS.factor(ref_ctx, jnp.asarray(d), 1e-7)
    At, dt, r0, r1 = _t(A, d, *rs)
    kset = bl.BatchLastKernels(fuse_form=True)
    fac = kset.factor(kset.prepare(At), dt, 1e-7)
    assert isinstance(fac, bl.BLFactor) and fac.L.shape == (m, m, B)
    _assert_factor_close(fac, ref_fac, m, B)
    for rhs in ((r0,), (r0, r1)):  # k = 1 and k = 2 stacked right-hand sides
        v = kset.solve(fac, rhs)
        ref_v = ref_bl.BATCHLAST_FUSED_KERNELS.solve(ref_fac, tuple(jnp.asarray(r.numpy()) for r in rhs))
        for a, b in zip(v, ref_v):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


@pytest.mark.parametrize("m,n,B", [(8, 20, 128), (13, 30, 150)])
def test_facsol_matches_pallas_interpret(m, n, B):
    A, d, rs = _problem(m, n, B, seed=2 * m + n)
    ref_kset = ref_bl.BatchLastKernels(fuse_facsol=True)
    ref_ctx = ref_kset.prepare(jnp.asarray(A))
    ref_fac, ref_v = ref_kset.factor_and_solve(ref_ctx, jnp.asarray(d), 1e-7,
                                               tuple(jnp.asarray(r) for r in rs))
    At, dt, r0, r1 = _t(A, d, *rs)
    kset = bl.BatchLastKernels(fuse_facsol=True)
    fac, v = kset.factor_and_solve(kset.prepare(At), dt, 1e-7, (r0, r1))
    assert isinstance(fac, bl.BLFactor)
    _assert_factor_close(fac, ref_fac, m, B)
    assert len(v) == 2
    for a, b in zip(v, ref_v):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)
    # the factor it returns serves the later solves of the iteration
    (v1,) = kset.solve(fac, (r1,))
    np.testing.assert_allclose(v1.numpy(), np.asarray(ref_v[1]), **F32_TOL)


def test_plain_versions_agree_with_the_split_path():
    """fused_factor_bl = chol_bl of the matmul-formed M; facsol_bl = chol_bl
    then solve_bl, on the same f32 inputs."""
    A, d, rs = _problem(10, 24, 40, seed=5)
    At, dt, r0, r1 = _t(A, d, *rs)
    ctx = bl.BATCHLAST_KERNELS.prepare(At)
    reg = torch.full((40,), 1e-5)
    M = (ctx.W @ dt.T).reshape(10, 10, 40)
    L_s, dinv_s = bl.chol_bl(M, reg)
    L_f, dinv_f = bl.fused_factor_bl(ctx.W, dt.T.contiguous(), reg)
    torch.testing.assert_close(torch.tril(L_f.permute(2, 0, 1)), torch.tril(L_s.permute(2, 0, 1)))
    torch.testing.assert_close(dinv_f, dinv_s)
    R = torch.stack([r0.T, r1.T]).contiguous()
    V_s = bl.solve_bl(L_s, dinv_s, R)
    M2 = M.clone()
    L_c, dinv_c, V_c = bl.facsol_bl(M2, reg, R)
    assert L_c.data_ptr() == M2.data_ptr()  # factored in place, as the reference aliases
    torch.testing.assert_close(torch.tril(L_c.permute(2, 0, 1)), torch.tril(L_s.permute(2, 0, 1)))
    torch.testing.assert_close(dinv_c, dinv_s)
    torch.testing.assert_close(V_c, V_s, rtol=2e-5, atol=2e-6)


def test_dispatch_follows_the_reference():
    A, d, rs = _problem(7, 16, 9, seed=4)
    At, dt, r0, r1 = _t(A, d, *rs)
    both = bl.BatchLastKernels(fuse_form=True, fuse_facsol=True)
    assert both.name == "cuda_batchlast_form_facsol"
    ref_both = ref_bl.BatchLastKernels(fuse_form=True, fuse_facsol=True)
    assert ref_both.name == both.name.replace("cuda", "pallas")
    ctx = both.prepare(At)
    calls = []

    def spy(name, fn):
        def wrapped(*a):
            calls.append(name)
            return fn(*a)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bl, "fused_factor_bl", spy("fused", bl.fused_factor_bl))
        mp.setattr(bl, "facsol_bl", spy("facsol", bl.facsol_bl))
        mp.setattr(bl, "chol_bl", spy("chol", bl.chol_bl))
        # both flags: factor_and_solve takes facsol, factor alone the fused form
        both.factor_and_solve(ctx, dt, 1e-7, (r0, r1))
        assert calls == ["facsol"]
        both.factor(ctx, dt, 1e-7)
        assert calls == ["facsol", "fused"]
        # per-instance (3-D) A: the split route, on both flags
        A3, d3, rs3 = _problem(7, 16, 9, seed=6, shared_A=False)
        A3t, d3t, s0 = _t(A3, d3, rs3[0])
        ctx3 = both.prepare(A3t)
        assert not isinstance(ctx3, bl.PreparedBL)
        fac3, (v3,) = both.factor_and_solve(ctx3, d3t, 1e-7, (s0,))
        assert calls == ["facsol", "fused", "chol"] and isinstance(fac3, bl.BLFactor)
        # f64: the reference set, on both flags
        A64, d64, rs64 = _problem(7, 16, 9, seed=7, dtype=np.float64)
        A64t, d64t, t0 = _t(A64, d64, rs64[0])
        ctx64 = both.prepare(A64t)
        fac64, _ = both.factor_and_solve(ctx64, d64t, 1e-12, (t0,))
        assert isinstance(fac64, NormalFactor) and isinstance(both.factor(ctx64, d64t, 1e-12), NormalFactor)
        assert calls == ["facsol", "fused", "chol"]
    (v3_ref,) = bl.BATCHLAST_KERNELS.solve(bl.BATCHLAST_KERNELS.factor(ctx3, d3t, 1e-7), (s0,))
    torch.testing.assert_close(v3, v3_ref)


def test_nonpsd_lane_produces_nan_in_both_kernels():
    A, d, rs = _problem(6, 15, 4, seed=9)
    d[2] = -d[2]  # negative scaling → indefinite M on lane 2
    At, dt, r0 = _t(A, d, rs[0])
    fused = bl.BatchLastKernels(fuse_form=True)
    fac = fused.factor(fused.prepare(At), dt, 0.0)
    (v,) = fused.solve(fac, (r0,))
    facsol = bl.BatchLastKernels(fuse_facsol=True)
    fac2, (v2,) = facsol.factor_and_solve(facsol.prepare(At), dt, 0.0, (r0,))
    for f, vv in ((fac, v), (fac2, v2)):
        assert torch.isnan(f.dinv_diag[:, 2]).any()
        assert torch.isnan(vv[2]).any()
        assert torch.isfinite(vv[[0, 1, 3]]).all()
        assert torch.isfinite(f.dinv_diag[:, [0, 1, 3]]).all()


def test_cpu_tensors_never_launch_a_kernel(monkeypatch):
    for name in ("CHOL_LAUNCHES", "SOLVE_LAUNCHES", "FUSED_FACTOR_LAUNCHES", "FACSOL_LAUNCHES"):
        monkeypatch.setattr(bl, name, 0)
    A, d, rs = _problem(8, 20, 32, seed=0)
    At, dt, r0, r1 = _t(A, d, *rs)
    for kset in (bl.BATCHLAST_FUSED_KERNELS, bl.BatchLastKernels(fuse_facsol=True)):
        fac, _ = kset.factor_and_solve(kset.prepare(At), dt, 1e-7, (r0, r1))
        kset.solve(fac, (r0,))
    counts = (bl.CHOL_LAUNCHES, bl.SOLVE_LAUNCHES, bl.FUSED_FACTOR_LAUNCHES, bl.FACSOL_LAUNCHES)
    assert counts == (0, 0, 0, 0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA route launches or raises: it never computes on a CPU tensor."""
    W, dT, reg = torch.ones(16, 5), torch.ones(5, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bl._fused_factor_bl_cuda(W, dT, reg)
    with pytest.raises(ValueError, match="m² rows"):
        bl._fused_factor_bl_cuda(torch.ones(15, 5), dT, reg)
    M = torch.eye(4).reshape(4, 4, 1).repeat(1, 1, 8).contiguous()
    with pytest.raises(ValueError, match="CUDA tensor"):
        bl._facsol_bl_cuda(M, reg, torch.ones(2, 4, 8))


@pytest.mark.parametrize("fused", ["form", "facsol"])
def test_scan_on_fused_set_matches_jax(fused):
    """A small narrow hsd_solve_scan (cap and bucket on) on each fused set
    against the reference's same set (Pallas in interpret mode)."""
    lp = random_standard_lp(16, 16, nlp=512, seed=11)
    eq = lp.to_equality_form()
    A, b, c = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))
    kw = dict(dtype="float32", tol=1e-5, maxiter=40, stall_patience=3, stall_rtol=0.05,
              refine_steps=0, kkt_refine=3, kkt_refine_pred=0, init_point="mehrotra")
    flag = {"form": dict(fuse_form=True), "facsol": dict(fuse_facsol=True)}[fused]
    scan_kw = dict(chunk=128, compact_cap=12, compact_bucket=64,
                   keys=("objective", "status", "iterations"))
    ref_out = ref_hsd.hsd_solve_scan(A, b, c, ref_pkg.SolverOptions(**kw),
                                     ref_bl.BatchLastKernels(**flag), **scan_kw)
    out = port_hsd.hsd_solve_scan(A, b, c, SolverOptions(**kw), bl.BatchLastKernels(**flag),
                                  device="cpu", **scan_kw)
    status = out["status"].numpy()
    same = status == np.asarray(ref_out["status"])
    # f32 trajectories part on a lane or two, as on the unfused set
    assert same.mean() >= 0.98
    assert (status == int(Status.OPTIMAL)).mean() > 0.9
    obj, ref_obj = out["objective"].numpy(), np.asarray(ref_out["objective"])
    opt = same & (status == int(Status.OPTIMAL))
    np.testing.assert_allclose(obj[opt], ref_obj[opt], rtol=1e-4, atol=1e-4)
    # a STALLED lane answers with its best iterate at the f32 floor, where
    # the two packages' rounding moves the objective by up to ~2e-4
    np.testing.assert_allclose(obj[same], ref_obj[same], rtol=1e-3, atol=1e-3)


def test_every_c_entry_point_has_its_signature():
    """ctypes passes an undeclared argument as a 32-bit int, which cuts a
    pointer: each ``pycllp_*`` entry point of csrc/ must be declared in
    ``_build._SIGNATURES`` with its argument count."""
    import re

    from pycllp_tpu_torch.ops import _build

    found = {}
    for src in _build._SRC_DIR.glob("*.cu"):
        for name, args in re.findall(r"\bint (pycllp_\w+)\(([^)]*)\)", src.read_text()):
            found[name] = len([a for a in args.split(",") if a.strip()])
    assert {"pycllp_fused_factor_bl_f32", "pycllp_facsol_bl_f32"} <= found.keys()
    assert found == {name: len(sig) for name, sig in _build._SIGNATURES.items()}
