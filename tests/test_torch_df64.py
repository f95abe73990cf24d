"""Port parity: the wide kernel sets (ops/df64.py, ops/mixed.py).

The port's wide factor and solve compute in native FP64 where the JAX
reference computes in double-single (hi/lo f32) Pallas; the Ozaki slicing
is the same f32 arithmetic in both.  On the CPU the port runs the plain
versions of its CUDA kernels; the JAX Pallas kernels run in interpret mode.

* ``ozaki_params`` / ``ozaki_mv_params``: equal to the reference's;
* the slicing: ``_slice_rounds_bl_plain`` equals JAX ``_slice_rounds_bl``
  BITWISE (the CUDA kernel is held to the plain version bitwise on the card);
* the Ozaki product (matvec, transposed matvec, formation): within 1e-14
  of the output scale of the reference's, at a 1e±30 spread of d with an
  all-zero lane and a lane whose max is a power of two; the bf16 packing
  of W's slices for the ``ozaki_product_bl`` kernel (main-cell and netlib
  shapes) and the kernel's schedule, replayed on the CPU, bitwise equal
  to the plain version;
* ``DF64_FINISH_KERNELS``: backward error < 1e-11 at a 1e±12 spread
  (tests_tpu/smoke.py's contract), agreement with the reference's set
  < 1e-7 at 1e±3; the f32 rounding of δ; the NaN lane; per-instance A;
* the mixed set on the port's batch-last base against the reference's,
  d uniform in [0.5, 2]: solves agree to 1e-8 relative;
* the TF32 guard of the Ozaki GEMMs;
* ``form="fast"`` (``DF64_FASTFORM_KERNELS``, the reference's recorded
  negative result) against the reference's fast set at m = 6 and 8,
  B = 16: factor and solves to 1e-5 relative (each package sums the f32
  GEMMs in its own order, so M agrees only to ~1e-7), and a lane whose d
  exceeds f32's range ends NaN in both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pycllp_tpu.ops import df64 as ref_df64
from pycllp_tpu.ops import mixed as ref_mixed
from pycllp_tpu.ops.batchlast import BATCHLAST_KERNELS as REF_BL
from pycllp_tpu_torch.ops import batchlast as bl
from pycllp_tpu_torch.ops import df64, mixed
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS

DF = df64.DF64_FINISH_KERNELS
REF_DF = ref_df64.DF64_FINISH_KERNELS


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _normalised_pair(r, B, seed):
    """A (r, B) hi/lo f32 pair of f64 data normalised per column to |x| ≤ 1."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((r, B)) * 10.0 ** rng.uniform(-6, 6, (r, B))
    X /= np.abs(X).max(axis=0, keepdims=True)
    hi = X.astype(np.float32)
    lo = (X - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _backward_error(A, d, reg, r, v):
    """‖Mv − r‖ / (‖M‖‖v‖ + ‖r‖) per lane, max over lanes (M exact in numpy f64)."""
    A = np.broadcast_to(A, (d.shape[0],) + A.shape[-2:])  # shared or per-instance A
    M = np.einsum("bmn,bn,bkn->bmk", A, d, A) + reg[:, None, None] * np.eye(A.shape[1])
    res = np.abs(np.einsum("bmk,bk->bm", M, v) - r)
    scale = np.abs(M).sum(-1).max(-1) * np.abs(v).max(-1) + np.abs(r).max(-1)
    return float((res.max(-1) / scale).max())


@pytest.mark.parametrize("n", [8, 24, 36, 64, 128, 200])
def test_ozaki_params_match_reference(n):
    assert df64.ozaki_params(n) == ref_df64.ozaki_params(n)
    assert df64.ozaki_mv_params(n) == ref_df64.ozaki_mv_params(n)
    assert df64.ozaki_params(n, bits=56) == ref_df64.ozaki_params(n, 56)


@pytest.mark.parametrize("r,B", [(24, 128), (36, 150)])
@pytest.mark.parametrize("which", ["mv", "formation"])
def test_slice_rounds_plain_bitwise_equal_to_pallas(r, B, which):
    n = 128 if which == "mv" else 64
    s, n_slices, _ = (df64.ozaki_mv_params if which == "mv" else df64.ozaki_params)(n)
    hi, lo = _normalised_pair(r, B, seed=r + B)
    ref = np.stack([np.asarray(a) for a in ref_df64._slice_rounds_bl(
        jnp.asarray(hi), jnp.asarray(lo), s=s, n_slices=n_slices)])
    got = df64._slice_rounds_bl_plain(*_t(hi, lo), s, n_slices).numpy()
    assert ref.dtype == got.dtype == np.float32 and got.shape == (n_slices, r, B)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    # integer-valued bands of at most s bits
    assert np.array_equal(got, np.round(got)) and np.abs(got).max() <= 2.0 ** s
    # the dispatching wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(df64.slice_rounds_bl(*_t(hi, lo), s, n_slices).numpy(), got)


def _ozaki_case(which, A):
    """(W, Ozaki parameters) of one product kind on A (m, n): the matvec
    (W = A, contraction n), the transposed matvec (W = Aᵀ, contraction m)
    and the normal-matrix formation (W = A⊗A rows, contraction n)."""
    m, n = A.shape
    if which == "mv":
        return A, df64.ozaki_mv_params(n)
    if which == "rmv":
        return np.ascontiguousarray(A.T), df64.ozaki_mv_params(m)
    return (A[:, None, :] * A[None, :, :]).reshape(m * m, n), df64.ozaki_params(n)


def _ozaki_lanes(B, n, rng):
    """d (B, n) spread over 1e±30 (the solver caps d at 1e30), with lane 0
    all zero (its max clamps to f32's tiny) and lane 1's max an exact power
    of two (the ceil(log2) edge)."""
    d = 10.0 ** rng.uniform(-30, 30, size=(B, n))
    d[0] = 0.0
    d[1] = rng.uniform(0.1, 1.0, n) * 2.0 ** 40
    d[1, n // 2] = 2.0 ** 40
    return d


# the Ozaki products' error against the exact product, relative to each
# lane's output scale: the formation captures 66 bits (1e-14, the
# reference's contract); the matvecs 48 (OZAKI_MV_BITS): n·2⁻⁴⁸ ≈ 7e-14
# of max|W|·max|d| at n = 20, a scale that the 1e±30 spread keeps near
# the output's (read: 1.6e-14 mv, 8.1e-15 rmv)
OZAKI_EXACT_RTOL = {"formation": 1e-14, "mv": 1e-13, "rmv": 1e-13}


@pytest.mark.parametrize("which", ["formation", "mv", "rmv"])
def test_ozaki_matmul_matches_jax(which):
    rng = np.random.default_rng(0)
    m, n, B = 8, 20, 128
    W, (s, n_slices, cut) = _ozaki_case(which, rng.standard_normal((m, n)))
    d = _ozaki_lanes(B, W.shape[1], rng)
    kw = dict(s=s, n_slices=n_slices, cut=cut)
    ref = np.asarray(ref_df64._ozaki_matmul(
        *ref_df64._ozaki_prepare(jnp.asarray(W), **kw), jnp.asarray(d.T), **kw))
    Wt, dt = _t(W, d)
    got = df64._ozaki_matmul(df64._ozaki_prepare(Wt, **kw), dt, **kw).numpy()
    assert got.shape == ref.shape == (W.shape[0], B)
    # the zero lane is an exact 0 in both; the others within 1e-14 of their scale
    assert not got[:, 0].any() and not ref[:, 0].any()
    got, ref, exact = got[:, 1:], ref[:, 1:], (W @ d.T)[:, 1:]
    scale = np.abs(ref).max(axis=0, keepdims=True)
    assert np.abs(got - ref).max(axis=0, keepdims=True).max() <= 1e-14 * scale.max()
    assert (np.abs(got - ref) / scale).max() <= 1e-14
    assert (np.abs(got - exact) / scale).max() <= OZAKI_EXACT_RTOL[which]


def _netlib_A(name):
    from pycllp_tpu_torch.io import netlib

    std = netlib.load_fixture(name).lp.to_standard_form()[0]
    return np.asarray(std.to_equality_form().A, np.float64)


def _unpack_slices(packed, rows, n):
    """Inverse of the kernel's fragment order (csrc/ozaki.cuh): packed
    (rows_pad/16, n_slices, n_pad/16, 32, 8) → (n_slices, rows, n) f32.
    Lane 4g + q holds rows (g, g + 8), columns (2q, 2q+1, 2q+8, 2q+9) as
    a0 … a7 = (g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1), (g, 2q+8), …"""
    RT, ns, JS = packed.shape[:3]
    P = packed.float().numpy().reshape(RT, ns, JS, 8, 4, 8)
    out = np.empty((ns, RT * 16, JS * 16), np.float32)
    for g in range(8):
        for q in range(4):
            for i, (dr, dc) in enumerate([(0, 0), (0, 1), (8, 0), (8, 1),
                                          (0, 8), (0, 9), (8, 8), (8, 9)]):
                out[:, g + dr::16, 2 * q + dc::16] = P[:, :, :, g, q, i].transpose(1, 0, 2)
    return out[:, :rows, :n].copy(), out


OZAKI_SHAPES = [(src, which) for src in ("64x128", "afiro", "sc50a", "adlittle")
                for which in ("mv", "rmv", "formation")]


@pytest.mark.parametrize("src,which", OZAKI_SHAPES)
def test_ozaki_packed_slices_unpack_to_level_groups(src, which):
    """_ozaki_prepare's bf16 packing (the kernel's A fragments) holds W's
    f32 slices exactly: unpacked, it rebuilds every level group; each slice
    is an integer of magnitude ≤ 2^s (so bf16 holds it), and the padding
    rows and columns are zero.  Shapes: the main cell's A (64×128), netlib
    m = 27/50/56 (afiro, sc50a, adlittle equality forms)."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((64, 128)) / np.sqrt(128) if src == "64x128" else _netlib_A(src)
    W, (s, n_slices, cut) = _ozaki_case(which, A)
    op = df64._ozaki_prepare(torch.from_numpy(W), s=s, n_slices=n_slices, cut=cut)
    rows, n = W.shape
    assert op.packed.dtype == torch.bfloat16 and op.packed.is_contiguous()
    assert op.packed.shape == (-(-rows // 32) * 2, n_slices, -(-n // 16), 32, 8)
    S, full = _unpack_slices(op.packed, rows, n)
    assert np.array_equal(S, np.round(S)) and np.abs(S).max() <= 2.0 ** s
    full[:, :rows, :n] = 0.0
    assert not full.any()
    levels = df64._group_levels(n_slices, cut)
    groups = [torch.cat([df64._ozaki_slice(op, k, n) for k in ks], dim=1) for _, ks in levels]
    assert len(groups) == len(levels) == cut - 1
    for (_, ks), Wg in zip(levels, groups):
        np.testing.assert_array_equal(np.concatenate([S[k - 1] for k in ks], axis=1), Wg.numpy())
    # and the slices reassemble W to the captured width, or to the ~48
    # bits of the f32 (hi, lo) pair they are cut from
    approx = op.e.numpy() * sum(S[k].astype(np.float64) * 2.0 ** (-s * (k + 1))
                                for k in range(n_slices))
    width = min(s * n_slices - 1, 47)
    assert np.abs(approx - W).max() <= 2.0 ** -width * np.abs(W).max()


def _ozaki_operand_case(src, which):
    """(W, (s, n_slices, cut)) of :data:`OZAKI_SHAPES`, or of SCAGR25's
    formation level structure (contraction 971: 14 slices of 5 bits, 14
    levels) on a few rows whose scales span 1e±12."""
    rng = np.random.default_rng(13)
    if src == "scagr25":
        W = rng.standard_normal((40, 971)) * 10.0 ** rng.uniform(-12, 12, (40, 1))
        W[3] = 0.0
        return W, df64.ozaki_params(971)
    A = rng.standard_normal((64, 128)) / np.sqrt(128) if src == "64x128" else _netlib_A(src)
    return _ozaki_case(which, A)


def _ozaki_prepare_one_shot(W, *, s, n_slices, cut):
    """The operand as one pass over every row builds it: every slice of W
    at once, then packed (what _ozaki_prepare built before its row blocks),
    with the level groups the plain and split routes multiplied."""
    sl, e = df64._df_slice_int(W, axis=1, s=s, n_slices=n_slices)
    groups = [torch.cat([sl[k - 1] for k in ks], dim=1)
              for _, ks in df64._group_levels(n_slices, cut)]
    return df64._pack_slices(sl), e, groups


OPERAND_SHAPES = OZAKI_SHAPES + [("scagr25", "formation")]


@pytest.mark.parametrize("src,which", OPERAND_SHAPES)
def test_ozaki_prepare_in_row_blocks_is_the_one_shot_operand(monkeypatch, src, which):
    """The row-blocked prepare gives the one-shot build's packed slices and
    scales bit for bit, at its default block and at blocks of one and of
    three 32-row tiles (a ragged last block included)."""
    W, (s, n_slices, cut) = _ozaki_operand_case(src, which)
    Wt = torch.from_numpy(W)
    packed, e, _ = _ozaki_prepare_one_shot(Wt, s=s, n_slices=n_slices, cut=cut)
    for block_bytes in (df64.OZAKI_PREPARE_BLOCK_BYTES, 1, 3 * 32 * 4 * n_slices * W.shape[1]):
        monkeypatch.setattr(df64, "OZAKI_PREPARE_BLOCK_BYTES", block_bytes)
        op = df64._ozaki_prepare(Wt, s=s, n_slices=n_slices, cut=cut)
        assert op._fields == ("e", "packed")
        assert torch.equal(op.packed.view(torch.int16), packed.view(torch.int16))
        assert torch.equal(op.e, e)


@pytest.mark.parametrize("src,which", OPERAND_SHAPES)
def test_ozaki_routes_are_the_level_group_gemms_bitwise(src, which):
    """The plain and split routes, which multiply W's slices one at a time,
    give the bits of one f32 GEMM of each level's concatenated group."""
    W, (s, n_slices, cut) = _ozaki_operand_case(src, which)
    rng = np.random.default_rng(14)
    d = _ozaki_lanes(24, W.shape[1], rng)
    Wt, dt = _t(W, d)
    _, e, groups = _ozaki_prepare_one_shot(Wt, s=s, n_slices=n_slices, cut=cut)
    dsl, de = df64._df_slice_int(dt.T, axis=0, s=s, n_slices=n_slices)
    want = None
    for (t, ks), Wg in zip(df64._group_levels(n_slices, cut), groups):
        Dg = torch.cat([dsl[t - k - 1] for k in ks], dim=0)
        term = (Wg @ Dg).to(torch.float64) * 2.0 ** (-s * t)
        want = term if want is None else want + term
    want = want * (e * de)
    op = df64._ozaki_prepare(Wt, s=s, n_slices=n_slices, cut=cut)
    for route in (df64._ozaki_matmul_plain, df64._ozaki_matmul_split, df64._ozaki_matmul):
        got = route(op, dt, s=s, n_slices=n_slices, cut=cut)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64)), route.__name__


def test_ozaki_packing_constants_match_the_kernel_source():
    """The packing's row padding and the levels the wrapper admits are the
    kernel's (csrc/ozaki.cuh), and the launcher's instantiations cover
    every level count up to that bound."""
    from pycllp_tpu_torch.ops import _build

    src = (_build._SRC_DIR / "ozaki.cuh").read_text()
    assert f"kOzRowPad = {df64.OZAKI_ROW_PAD};" in src
    assert f"kOzMaxLevels = {df64.OZAKI_MAX_LEVELS};" in src
    assert "launch_ozaki_product_t<24, 1>" in src and "if (levels <= 16)" in src


@pytest.mark.parametrize("which", ["mv", "rmv", "formation"])
def test_ozaki_kernel_schedule_matches_plain_bitwise(which):
    """The kernel's schedule, replayed on the CPU from the packed slices:
    per-lane normalisation, slices l ≤ L = min(n_slices, cut − 1) of d,
    one integer sum per level t over the pairs (k, l), k + l = t, both
    ≤ L, then the f64 combination in level order and the scale.  It must
    equal _ozaki_matmul_plain bit for bit, which is what the card holds
    the kernel to (against the split route) at the main cell's shapes."""
    rng = np.random.default_rng(12)
    A = rng.standard_normal((16, 40))
    W, (s, n_slices, cut) = _ozaki_case(which, A)
    d = _ozaki_lanes(48, W.shape[1], rng)
    Wt, dt = _t(W, d)
    op = df64._ozaki_prepare(Wt, s=s, n_slices=n_slices, cut=cut)
    want = df64._ozaki_matmul_plain(op, dt, s=s, n_slices=n_slices, cut=cut).numpy()
    Ws, _ = _unpack_slices(op.packed, *W.shape)
    mx = np.maximum(np.abs(d).max(axis=1), np.finfo(np.float32).tiny)
    E = np.ceil(np.log2(mx))
    hi, lo = df64._split_hi_lo(torch.from_numpy(d.T * np.exp2(-E)))
    L = min(n_slices, cut - 1)
    ds = df64._slice_rounds_bl_plain(hi.contiguous(), lo.contiguous(), s, L).numpy()
    acc = None
    for t in range(2, cut + 1):
        G = sum(Ws[k - 1].astype(np.float64) @ ds[t - k - 1].astype(np.float64)
                for k in range(1, L + 1) if 1 <= t - k <= L)
        assert np.abs(G).max() <= 2.0 ** 24  # exact in an f32 accumulator
        term = G.astype(np.float32).astype(np.float64) * 2.0 ** (-s * t)
        acc = term if acc is None else acc + term
    got = acc * (op.e.numpy() * np.exp2(E)[None, :])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("m,n,B", [(16, 24, 128), (32, 48, 256)])
def test_df64_set_contracts_and_parity(m, n, B):
    rng = np.random.default_rng(m)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    r = rng.standard_normal((B, m))
    At, rt = _t(A, r)
    ctx = DF.prepare(At)
    # backward error at a late-IPM-like 1e±12 spread (smoke's check_df64 (a))
    d = 10.0 ** rng.uniform(-12, 12, size=(B, n))
    fac = DF.factor(ctx, torch.from_numpy(d), 1e-12)
    (v,) = DF.solve(fac, (rt,))
    assert torch.isfinite(v).all()
    assert _backward_error(A, d, fac.reg.numpy(), r, v.numpy()) < 1e-11
    # agreement with the reference's df64 set at a moderate 1e±3 spread
    d2 = 10.0 ** rng.uniform(-3, 3, size=(B, n))
    (v2,) = DF.solve(DF.factor(ctx, torch.from_numpy(d2), 1e-12), (rt,))
    ref_ctx = REF_DF.prepare(jnp.asarray(A))
    (v_ref,) = REF_DF.solve(REF_DF.factor(ref_ctx, jnp.asarray(d2), 1e-12), (jnp.asarray(r),))
    v_ref = np.asarray(v_ref)
    rel = np.abs(v2.numpy() - v_ref) / np.abs(v_ref).max(-1, keepdims=True)
    assert rel.max() < 1e-7
    # the Ozaki matvecs (48 captured bits) against plain f64 products
    x = rng.standard_normal((B, n))
    np.testing.assert_allclose(DF.mv(ctx, torch.from_numpy(x)).numpy(), x @ A.T,
                               rtol=0, atol=1e-12 * np.abs(x @ A.T).max())
    np.testing.assert_allclose(DF.rmv(ctx, rt).numpy(), r @ A,
                               rtol=0, atol=1e-12 * np.abs(r @ A).max())


def test_df64_f64form_matches_ozaki_form():
    rng = np.random.default_rng(3)
    m, n, B = 12, 20, 64
    A = rng.standard_normal((m, n))
    d = 10.0 ** rng.uniform(-3, 3, size=(B, n))
    r = rng.standard_normal((B, m))
    At, dt, rt = _t(A, d, r)
    (v_f64,) = df64.DF64_F64FORM_KERNELS.solve(
        df64.DF64_F64FORM_KERNELS.factor(df64.DF64_F64FORM_KERNELS.prepare(At), dt, 1e-12), (rt,))
    (v_oz,) = DF.solve(DF.factor(DF.prepare(At), dt, 1e-12), (rt,))
    assert (v_f64 - v_oz).abs().max() / v_oz.abs().max() < 1e-9
    assert BATCHLAST_KERNELS.finish_kernels("df64_f64form") is df64.DF64_F64FORM_KERNELS


def test_reg_enters_the_factor_rounded_to_f32(monkeypatch):
    """δ is computed through an f32 product of normalised d and reaches the
    factor rounded to f32, as the reference adds (reg_f32, 0); matvec_M
    keeps the f64 value."""
    seen = {}

    def spy(M, reg):
        seen["reg"] = reg.clone()
        return df64._df_chol_bl_plain(M, reg)

    monkeypatch.setattr(df64, "df_chol_bl", spy)
    rng = np.random.default_rng(4)
    A = rng.standard_normal((10, 16))
    d = 10.0 ** rng.uniform(-20, 20, size=(32, 16))
    At, dt = _t(A, d)
    fac = DF.factor(DF.prepare(At), dt, 1e-12)
    assert seen["reg"].dtype == torch.float64
    torch.testing.assert_close(seen["reg"], fac.reg.to(torch.float32).to(torch.float64),
                               rtol=0, atol=0)
    assert (seen["reg"] != fac.reg).any()  # the rounding is real, not a no-op
    # δ = reg_eps·max(diag(A·D·Aᵀ)) to f32-product accuracy
    np.testing.assert_allclose(fac.reg.numpy(), 1e-12 * ((A * A) @ d.T).max(0), rtol=1e-6)


def test_df64_nan_lane_poisons_only_itself():
    rng = np.random.default_rng(9)
    A = rng.standard_normal((6, 15))
    d = rng.uniform(0.5, 2.0, size=(4, 15))
    d[2] = -d[2]  # indefinite M on lane 2
    At, dt, rt = _t(A, d, rng.standard_normal((4, 6)))
    fac = df64.DF64_F64FORM_KERNELS.factor(df64.DF64_F64FORM_KERNELS.prepare(At), dt, 0.0)
    assert torch.isnan(fac.dinv[:, 2]).any()
    (v,) = df64.DF64_F64FORM_KERNELS.solve(fac, (rt,))
    assert torch.isnan(v[2]).any() and torch.isfinite(v[[0, 1, 3]]).all()


def test_df64_per_instance_A():
    rng = np.random.default_rng(6)
    m, n, B = 12, 20, 40
    A3 = rng.standard_normal((B, m, n))
    d = np.abs(rng.standard_normal((B, n))) + 1e-2
    r = rng.standard_normal((B, m))
    ctx = DF.prepare(torch.from_numpy(A3))
    assert ctx.W is None and ctx.Amv is None
    fac = DF.factor(ctx, torch.from_numpy(d), 1e-14)
    (v,) = DF.solve(fac, (torch.from_numpy(r),))
    assert _backward_error(A3, d, fac.reg.numpy(), r, v.numpy()) < 1e-13
    M = np.einsum("bmn,bn,bkn->bmk", A3, d, A3) + fac.reg.numpy()[:, None, None] * np.eye(m)
    np.testing.assert_allclose(v.numpy(), np.linalg.solve(M, r[..., None])[..., 0],
                               rtol=1e-10, atol=1e-10)


FASTFORM_RTOL = 1e-5  # f32-level: both packages' f32 GEMMs round, each in its own order
BIG_LANE = 5  # its d reaches 5e47 (the reference measured d that large), beyond f32


@pytest.fixture(scope="module", params=[6, 8])
def fastform_pair(request):
    """One factor and a k = 2 solve through both packages' fast sets, at m
    = 6 or 8 and B = 16; lane BIG_LANE has one d entry beyond f32's range."""
    m = request.param
    n, B = 2 * m + 2, 16
    rng = np.random.default_rng(m)
    A = rng.standard_normal((m, n))
    d = rng.uniform(0.5, 2.0, (B, n)) * 10.0 ** rng.uniform(-3, 3, (B, 1))
    d[BIG_LANE, 1] = 5e47
    rs = tuple(rng.standard_normal((B, m)) for _ in range(2))
    ref = ref_df64.DF64_FASTFORM_KERNELS
    ref_fac = ref.factor(ref.prepare(jnp.asarray(A)), jnp.asarray(d), 1e-12)
    ref_v = ref.solve(ref_fac, tuple(jnp.asarray(r) for r in rs))
    port = df64.DF64_FASTFORM_KERNELS
    fac = port.factor(port.prepare(torch.from_numpy(A)), torch.from_numpy(d), 1e-12)
    v = port.solve(fac, _t(*rs))
    ref_L = (np.asarray(ref_fac.Lh, np.float64) + np.asarray(ref_fac.Ll, np.float64))[:m, :m, :B]
    return dict(m=m, ref_L=ref_L, ref_v=[np.asarray(x) for x in ref_v], ref_reg=np.asarray(ref_fac.reg),
                L=fac.L.numpy(), v=[x.numpy() for x in v], reg=fac.reg.numpy(), ctx=fac.ctx)


def test_fastform_is_not_ported(fastform_pair):
    """``form="fast"`` runs: selectable by name, named as the reference
    names it, and its factor and solves agree with the reference's fast
    set to FASTFORM_RTOL on every lane whose d stays in f32's range; an
    unknown set name still raises."""
    fast = df64.DF64_FASTFORM_KERNELS
    assert fast.form == "fast" and df64.DoubleSingleKernels(form="fast").form == "fast"
    assert fast.name == ref_df64.DF64_FASTFORM_KERNELS.name.replace("pallas_", "cuda_")
    assert BATCHLAST_KERNELS.finish_kernels("df64_fastform") is fast
    with pytest.raises(ValueError):
        BATCHLAST_KERNELS.finish_kernels("no_such_set")
    with pytest.raises(ValueError):
        df64.DoubleSingleKernels(form="no_such_form")
    p = fastform_pair
    m = p["m"]
    ctx = p["ctx"]
    assert ctx.Wh.dtype == ctx.Wl.dtype == torch.float32 and ctx.Wh.shape == (m * m, 2 * m + 2)
    torch.testing.assert_close(ctx.Wh.double() + ctx.Wl.double(), ctx.W, rtol=1e-14, atol=0)
    ok = np.ones(p["L"].shape[-1], bool)
    ok[BIG_LANE] = False
    np.testing.assert_allclose(p["reg"][ok], p["ref_reg"][ok], rtol=1e-6)
    lower = np.tril(np.ones((m, m), bool))[..., None]
    L, ref_L = np.where(lower, p["L"], 0.0)[..., ok], np.where(lower, p["ref_L"], 0.0)[..., ok]
    assert (np.abs(L - ref_L).max((0, 1)) / np.abs(ref_L).max((0, 1))).max() < FASTFORM_RTOL
    for v, ref_v in zip(p["v"], p["ref_v"]):
        assert (np.abs(v[ok] - ref_v[ok]).max(-1) / np.abs(ref_v[ok]).max(-1)).max() < FASTFORM_RTOL


def test_fastform_lane_beyond_f32_range_is_nan_in_both(fastform_pair):
    """The negative result is reproduced, not repaired: a d beyond f32's
    range makes the hi split inf and the lane's factor NaN, in both
    packages, and no other lane is touched."""
    p = fastform_pair
    for v in p["v"] + p["ref_v"]:
        assert np.isnan(v[BIG_LANE]).any()
        assert np.isfinite(np.delete(v, BIG_LANE, axis=0)).all()
    assert np.isnan(p["L"][..., BIG_LANE]).any() and np.isnan(p["ref_L"][..., BIG_LANE]).any()


def test_finish_kernels_cached_per_name():
    assert BATCHLAST_KERNELS.finish_kernels() is DF
    assert BATCHLAST_KERNELS.finish_kernels("df64") is BATCHLAST_KERNELS.finish_kernels("df64")
    assert BATCHLAST_KERNELS.finish_kernels("mixed") is mixed.MIXED_FINISH_KERNELS
    assert BATCHLAST_KERNELS.finish_kernels("mixed1") is mixed.MIXED_IR1_KERNELS
    assert mixed.MIXED_IR1_KERNELS.ir_steps == 1 and mixed.MIXED_FINISH_KERNELS.ir_steps == 3
    assert DF.finish_kernels("anything") is DF  # wide sets ignore the selector


@pytest.mark.parametrize("ir_steps", [1, 3])
@pytest.mark.parametrize("jacobi", [True, False])
def test_mixed_set_matches_jax(ir_steps, jacobi):
    rng = np.random.default_rng(ir_steps + 10 * jacobi)
    m, n, B = 10, 24, 96
    A = rng.standard_normal((m, n))
    d = rng.uniform(0.5, 2.0, size=(B, n))
    rs = tuple(rng.standard_normal((B, m)) for _ in range(2))
    ref_k = ref_mixed.MixedPrecisionKernels(REF_BL, ir_steps=ir_steps, jacobi=jacobi)
    port_k = mixed.MixedPrecisionKernels(BATCHLAST_KERNELS, ir_steps=ir_steps, jacobi=jacobi)
    ref_fac = ref_k.factor(ref_k.prepare(jnp.asarray(A)), jnp.asarray(d), 1e-12)
    At, dt = _t(A, d)
    fac = port_k.factor(port_k.prepare(At), dt, 1e-12)
    assert (fac.s is not None) == jacobi and isinstance(fac.fac_lo, bl.BLFactor)
    for rhs in (rs[:1], rs):  # k = 1 and the stacked k = 2 sweep
        ref_v = ref_k.solve(ref_fac, tuple(jnp.asarray(r) for r in rhs))
        v = port_k.solve(fac, _t(*rhs))
        for a, b in zip(v, ref_v):
            b = np.asarray(b)
            assert a.dtype == torch.float64
            assert np.abs(a.numpy() - b).max() / np.abs(b).max() < 1e-8


def test_mixed_per_instance_A_refines_each_rhs():
    rng = np.random.default_rng(8)
    B, m, n = 6, 8, 14
    A3 = rng.standard_normal((B, m, n))
    d = rng.uniform(0.5, 2.0, size=(B, n))
    rs = tuple(rng.standard_normal((B, m)) for _ in range(2))
    k = mixed.MIXED_FINISH_KERNELS
    ctx = k.prepare(torch.from_numpy(A3))
    assert ctx.Amv is None
    fac = k.factor(ctx, torch.from_numpy(d), 1e-12)
    for v, r in zip(k.solve(fac, _t(*rs)), rs):
        M = np.einsum("bmn,bn,bkn->bmk", A3, d, A3) + fac.reg.numpy()[:, None, None] * np.eye(m)
        np.testing.assert_allclose(v.numpy(), np.linalg.solve(M, r[..., None])[..., 0],
                                   rtol=1e-8, atol=1e-8)


def test_ozaki_gemm_refuses_tf32(monkeypatch):
    s, n_slices, cut = df64.ozaki_mv_params(6)
    W = torch.ones((4, 6), dtype=torch.float64)
    op = df64._ozaki_prepare(W, s=s, n_slices=n_slices, cut=cut)
    d = torch.ones((3, 6), dtype=torch.float64)
    torch.testing.assert_close(df64._ozaki_matmul(op, d, s=s, n_slices=n_slices, cut=cut),
                               W @ d.T)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        df64._ozaki_matmul(op, d, s=s, n_slices=n_slices, cut=cut)


def test_cpu_tensors_never_launch_a_wide_kernel(monkeypatch):
    names = ("DF_CHOL_LAUNCHES", "DF_SOLVE_LAUNCHES", "SLICE_LAUNCHES", "OZAKI_LAUNCHES")
    for name in names:
        monkeypatch.setattr(df64, name, 0)
    rng = np.random.default_rng(1)
    At, dt, rt = _t(rng.standard_normal((6, 10)), rng.uniform(0.5, 2, (8, 10)),
                    rng.standard_normal((8, 6)))
    ctx = DF.prepare(At)
    DF.solve(DF.factor(ctx, dt, 1e-12), (rt, rt))
    DF.mv(ctx, dt)
    DF.rmv(ctx, rt)
    mixed.MIXED_IR1_KERNELS.solve(mixed.MIXED_IR1_KERNELS.factor(
        mixed.MIXED_IR1_KERNELS.prepare(At), dt, 1e-12), (rt,))
    assert tuple(getattr(df64, name) for name in names) == (0, 0, 0, 0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA route launches or raises: it never computes on a CPU tensor."""
    M = torch.eye(4, dtype=torch.float64).reshape(4, 4, 1).repeat(1, 1, 8).contiguous()
    reg = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        df64._df_chol_bl_cuda(M, reg)
    L, dinv = df64.df_chol_bl(M, reg)  # the dispatching wrapper: CPU → plain version
    with pytest.raises(ValueError, match="CUDA tensor"):
        df64._df_solve_bl_cuda(L, dinv, torch.ones(1, 4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        df64._slice_rounds_bl_cuda(torch.zeros(3, 5), torch.zeros(3, 5), 7, 7)
    s, n_slices, cut = df64.ozaki_mv_params(5)
    op = df64._ozaki_prepare(torch.ones(3, 5, dtype=torch.float64), s=s, n_slices=n_slices,
                             cut=cut)
    with pytest.raises(ValueError, match="CUDA tensor"):
        df64._ozaki_product_bl_cuda(op, torch.ones(4, 5, dtype=torch.float64), s, n_slices, cut)
    # the dispatching wrapper: CPU → plain version, no launch
    torch.testing.assert_close(
        df64._ozaki_matmul(op, torch.ones(4, 5, dtype=torch.float64), s=s, n_slices=n_slices,
                           cut=cut), torch.full((3, 4), 5.0, dtype=torch.float64))
