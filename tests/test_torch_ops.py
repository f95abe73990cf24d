"""Port parity: the kernel sets.

* the port's ``ReferenceKernels`` (torch.linalg) against the JAX
  ``REFERENCE_KERNELS`` (lax.linalg) in f64, to 1e-10;
* the port's ``BatchLastKernels`` on CPU tensors — i.e. the plain PyTorch
  versions of the CUDA kernels — against the JAX ``BATCHLAST_KERNELS``,
  whose Pallas kernels run in interpret mode on the CPU, in f32 at
  rtol 2e-4 / atol 2e-5 (the bound of tests/test_ops.py);
* CPU tensors never launch a CUDA kernel.

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds
them against these plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pycllp_tpu.ops.batchlast import BATCHLAST_KERNELS as REF_BL
from pycllp_tpu.ops.reference import REFERENCE_KERNELS as REF_KS
from pycllp_tpu_torch.ops import batchlast as bl
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS, BLFactor, PreparedBL
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS, NormalFactor

F32_TOL = dict(rtol=2e-4, atol=2e-5)


def _problem(m, n, B, seed, dtype, shared_A=True):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n) if shared_A else (B, m, n)).astype(dtype)
    d = rng.uniform(0.5, 2.0, size=(B, n)).astype(dtype)
    rs = tuple(rng.normal(size=(B, m)).astype(dtype) for _ in range(2))
    return A, d, rs


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("shared_A", [True, False])
def test_reference_kernels_match_jax_f64(shared_A):
    A, d, rs = _problem(9, 21, 12, seed=1, dtype=np.float64, shared_A=shared_A)
    ref_ctx = REF_KS.prepare(jnp.asarray(A))
    ref_fac = REF_KS.factor(ref_ctx, jnp.asarray(d), 1e-9)
    ref_v = REF_KS.solve(ref_fac, tuple(jnp.asarray(r) for r in rs))
    At, dt, r0, r1 = _t(A, d, *rs)
    ctx = REFERENCE_KERNELS.prepare(At)
    fac = REFERENCE_KERNELS.factor(ctx, dt, 1e-9)
    v = REFERENCE_KERNELS.solve(fac, (r0, r1))
    np.testing.assert_allclose(fac.L.numpy(), np.asarray(ref_fac.L), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(fac.reg.numpy(), np.asarray(ref_fac.reg), rtol=1e-12)
    for a, b in zip(v, ref_v):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        REFERENCE_KERNELS.matvec_M(fac, r0).numpy(),
        np.asarray(REF_KS.matvec_M(ref_fac, jnp.asarray(rs[0]))),
        rtol=1e-10, atol=1e-10,
    )
    np.testing.assert_allclose(
        REFERENCE_KERNELS.rmv(ctx, r0).numpy(),
        np.asarray(REF_KS.rmv(ref_ctx, jnp.asarray(rs[0]))),
        rtol=1e-12, atol=1e-12,
    )


@pytest.mark.parametrize("m,n,B", [(8, 20, 128), (13, 30, 150)])
def test_batchlast_plain_matches_pallas_interpret(m, n, B):
    A, d, rs = _problem(m, n, B, seed=m + B, dtype=np.float32)
    ref_ctx = REF_BL.prepare(jnp.asarray(A))
    ref_fac = REF_BL.factor(ref_ctx, jnp.asarray(d), 1e-7)
    At, dt, r0, r1 = _t(A, d, *rs)
    ctx = BATCHLAST_KERNELS.prepare(At)
    assert isinstance(ctx, PreparedBL)
    fac = BATCHLAST_KERNELS.factor(ctx, dt, 1e-7)
    assert isinstance(fac, BLFactor) and fac.L.shape == (m, m, B)
    # the reference pads lanes to a multiple of 128; the port does not
    ref_L = np.asarray(ref_fac.L)[..., :B]
    tril = np.tril(np.ones((m, m), bool))[..., None]
    np.testing.assert_allclose(np.where(tril, fac.L.numpy(), 0), np.where(tril, ref_L, 0), **F32_TOL)
    np.testing.assert_allclose(fac.dinv_diag.numpy(), np.asarray(ref_fac.dinv_diag)[:, :B], **F32_TOL)
    for rhs in ((r0,), (r0, r1)):  # k = 1 and k = 2 stacked right-hand sides
        v = BATCHLAST_KERNELS.solve(fac, rhs)
        ref_v = REF_BL.solve(ref_fac, tuple(jnp.asarray(r.numpy()) for r in rhs))
        assert len(v) == len(rhs)
        for a, b in zip(v, ref_v):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


def test_nonpsd_lane_produces_nan():
    """A lane whose normal matrix is not PSD must NaN, not corrupt others."""
    A, d, rs = _problem(6, 15, 4, seed=9, dtype=np.float32)
    d[2] = -d[2]  # negative scaling → indefinite M on lane 2
    At, dt, r0 = _t(A, d, rs[0])
    fac = BATCHLAST_KERNELS.factor(BATCHLAST_KERNELS.prepare(At), dt, 0.0)
    assert torch.isnan(fac.dinv_diag[:, 2]).any()
    (v,) = BATCHLAST_KERNELS.solve(fac, (r0,))
    assert torch.isnan(v[2]).any()
    assert torch.isfinite(v[[0, 1, 3]]).all()


def test_batched_A_path_matches_pallas_interpret():
    """Per-instance (3-D) A: M formed per instance, batch-last, same kernel."""
    A, d, rs = _problem(7, 16, 9, seed=4, dtype=np.float32, shared_A=False)
    ref_ctx = REF_BL.prepare(jnp.asarray(A))
    ref_fac = REF_BL.factor(ref_ctx, jnp.asarray(d), 1e-7)
    ref_v = REF_BL.solve(ref_fac, tuple(jnp.asarray(r) for r in rs))
    At, dt, r0, r1 = _t(A, d, *rs)
    ctx = BATCHLAST_KERNELS.prepare(At)
    assert not isinstance(ctx, PreparedBL)
    fac = BATCHLAST_KERNELS.factor(ctx, dt, 1e-7)
    assert isinstance(fac, BLFactor) and fac.L.shape == (7, 7, 9)
    for a, b in zip(BATCHLAST_KERNELS.solve(fac, (r0, r1)), ref_v):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


def test_f64_routes_to_reference():
    A, d, rs = _problem(8, 20, 4, seed=3, dtype=np.float64)
    At, dt, r0 = _t(A, d, rs[0])
    fac = BATCHLAST_KERNELS.factor(BATCHLAST_KERNELS.prepare(At), dt, 1e-12)
    assert isinstance(fac, NormalFactor)
    (v,) = BATCHLAST_KERNELS.solve(fac, (r0,))
    (v_ref,) = REFERENCE_KERNELS.solve(fac, (r0,))
    np.testing.assert_array_equal(v.numpy(), v_ref.numpy())


def test_cpu_tensors_never_launch_a_kernel(monkeypatch):
    monkeypatch.setattr(bl, "CHOL_LAUNCHES", 0)
    monkeypatch.setattr(bl, "SOLVE_LAUNCHES", 0)
    A, d, rs = _problem(8, 20, 32, seed=0, dtype=np.float32)
    At, dt, r0, r1 = _t(A, d, *rs)
    fac = BATCHLAST_KERNELS.factor(BATCHLAST_KERNELS.prepare(At), dt, 1e-7)
    BATCHLAST_KERNELS.solve(fac, (r0, r1))
    bl.chol_bl(torch.eye(3).reshape(3, 3, 1).repeat(1, 1, 2).contiguous(), torch.zeros(2))
    assert (bl.CHOL_LAUNCHES, bl.SOLVE_LAUNCHES) == (0, 0)


def test_unported_options_raise():
    # the fused sets are ported: they construct, named as the reference names them
    from pycllp_tpu.ops.batchlast import BatchLastKernels as RefBatchLastKernels

    for kw in (dict(fuse_form=True), dict(fuse_facsol=True), dict(fuse_form=True, fuse_facsol=True)):
        kset = bl.BatchLastKernels(**kw)
        assert (kset.fuse_form, kset.fuse_facsol) == (kw.get("fuse_form", False),
                                                      kw.get("fuse_facsol", False))
        assert kset.name == RefBatchLastKernels(**kw).name.replace("pallas_", "cuda_")
    assert bl.BATCHLAST_FUSED_KERNELS.name == "cuda_batchlast_form"
    assert BATCHLAST_KERNELS.name == "cuda_batchlast"
    assert BATCHLAST_KERNELS.finish_kernels("reference") is REFERENCE_KERNELS
    # every finish set is ported, the reference's recorded negative result
    # (df64_fastform) too, each named as the reference names it
    from pycllp_tpu.ops.batchlast import BATCHLAST_KERNELS as REF_BL

    for which in ("df64", "df64_f64form", "df64_fastform", "mixed", "mixed1"):
        fk = BATCHLAST_KERNELS.finish_kernels(which)
        assert fk is BATCHLAST_KERNELS.finish_kernels(which)
        assert fk.name == REF_BL.finish_kernels(which).name.replace("pallas_", "cuda_"), which
    with pytest.raises(ValueError):
        BATCHLAST_KERNELS.finish_kernels("no_such_set")
