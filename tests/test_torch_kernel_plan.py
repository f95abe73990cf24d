"""The launch plan of the batch-last factor, solve and fused pair, on the CPU.

The lane-group kernels (``csrc/batchlast_smem.cuh``) run only on the card;
what surrounds them is Python that these tests reach: the choice between
the lane-group and the streaming design (by shape alone), the lane-group
size G, the grid and the shared memory of each launch, the layout the
fused factor reads W in, and the C entry points' ctypes signatures.  The kernels themselves are held
against their plain versions on the card by ``chip_smoke.py``.
"""

import re

import pytest
import torch

from pycllp_tpu_torch.ops import _build
from pycllp_tpu_torch.ops import batchlast as bl
from pycllp_tpu_torch.ops import df64

SMEM_LIMIT = 232448  # a block's shared memory on the H100 (sm_90)
SMS = 132  # the H100 SXM's SMs
WIDTHS = (1, 256, 300, 1024, 5120, 8192, 16384)  # every lane count the paths use
DTYPES = {"f32": torch.float32, "f64": torch.float64}
HEADER = _build._SRC_DIR / "batchlast_smem.cuh"


@pytest.mark.parametrize("kind", ["chol", "solve"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("m", [27, 30, 32, 50, 56, 64])
def test_plan_fits_and_fills_the_card(m, dtype, kind):
    """At every (m, dtype) the port meets and every width: the lane-group
    design, shared memory within the limit, a grid that covers every lane
    with no empty block, and a block on every SM where the lanes allow."""
    dt = DTYPES[dtype]
    assert bl.uses_smem(m, dt)
    for B in WIDTHS:
        plan = bl.lane_plan(kind, m, B, dt, SMS)
        assert plan.design == "smem"
        assert plan.smem <= SMEM_LIMIT
        assert plan.smem == bl.smem_bytes(m, plan.lanes, dt.itemsize)
        assert plan.lanes in bl._LANE_GROUPS[dt.itemsize]
        assert plan.blocks * plan.lanes >= B > (plan.blocks - 1) * plan.lanes
        assert plan.blocks >= min(SMS, B), (B, plan)
        # the largest G that still fills the card: the next one up would not
        bigger = [g for g in bl._LANE_GROUPS[dt.itemsize] if g > plan.lanes and g <= B]
        assert all(-(-B // g) < min(SMS, B) for g in bigger), (B, plan)


@pytest.mark.parametrize("kind", ["chol", "solve"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_design_switches_where_one_lane_stops_fitting(kind, dtype):
    """The lane-group design runs exactly while one lane's triangle fits in
    a block's shared memory; past that m the streaming kernel runs, at any
    B."""
    dt = DTYPES[dtype]
    fits = [m for m in range(1, 600) if bl.smem_bytes(m, 1, dt.itemsize) <= SMEM_LIMIT]
    last = max(fits)
    assert fits == list(range(1, last + 1))  # the footprint grows with m
    # about m = 340 in float and 240 in double at one lane per block
    assert last == {"f32": 340, "f64": 240}[dtype]
    for m in (last - 1, last):
        assert bl.uses_smem(m, dt)
        assert all(bl.lane_plan(kind, m, B, dt).design == "smem" for B in WIDTHS)
    for m in (last + 1, last + 50):
        assert not bl.uses_smem(m, dt)
        assert all(bl.lane_plan(kind, m, B, dt).design == "stream" for B in WIDTHS)


def test_plan_at_the_main_widths():
    """The main path's widths, as the card runs them: 8 float lanes a block
    at the narrow chunk and bucket, 4 double lanes at drain tier 1 and one
    at tier 2 (256 blocks, not the streaming factor's 8)."""
    f32, f64 = torch.float32, torch.float64
    assert bl.lane_plan("chol", 64, 16384, f32) == bl.LanePlan("smem", 8, 2048, 66688)
    assert bl.lane_plan("chol", 64, 5120, f32).lanes == 8
    assert bl.lane_plan("solve", 64, 16384, f32) == bl.LanePlan("smem", 8, 2048, 66688)
    assert bl.lane_plan("chol", 64, 1024, f64) == bl.LanePlan("smem", 4, 256, 66816)
    assert bl.lane_plan("chol", 64, 256, f64) == bl.LanePlan("smem", 1, 256, 16896)
    assert bl.lane_plan("solve", 64, 256, f64).blocks == 256
    # the streaming kernels' grids, for comparison
    assert bl.lane_plan("chol", 64, 256, f64, design="stream").blocks == 8
    assert bl.lane_plan("solve", 64, 1024, f64, design="stream").blocks == 8


def test_forced_plans():
    f32 = torch.float32
    assert bl.lane_plan("chol", 64, 16384, f32, lanes=2) == bl.LanePlan("smem", 2, 8192, 16768)
    assert bl.lane_plan("solve", 64, 300, f32, k=2, design="stream").blocks == 5
    with pytest.raises(ValueError, match="lane-group size"):
        bl.lane_plan("chol", 64, 16384, f32, lanes=3)
    with pytest.raises(ValueError, match="lane-group size"):
        bl.lane_plan("chol", 64, 16384, torch.float64, lanes=8)
    with pytest.raises(ValueError, match="shared memory"):
        bl.lane_plan("chol", 400, 16384, f32, design="smem")
    with pytest.raises(ValueError, match="no lane-group size"):
        bl.lane_plan("chol", 64, 16384, f32, design="stream", lanes=8)


def test_plan_formulas_match_the_kernel_source():
    """The Python plan uses the header's constants and G's built sizes."""
    src = HEADER.read_text()
    assert "(tri_row(m) + 31) / 32 * 32 + 32 / G" in src  # tri_stride
    assert "tri_stride(m, G)) * G * sizeof(T)" in src  # tri_smem_bytes, both kernels
    built = {int(g) for g in re.findall(r"case (\d+): return launch_chol_smem_g", src)}
    assert built == {int(g) for g in re.findall(r"case (\d+): return launch_solve_smem_g", src)}
    assert built == set(bl._LANE_GROUPS[4]) >= set(bl._LANE_GROUPS[8])
    # the registers a thread keeps cover every m of the lane-group design:
    # 11 solve rows (m <= 352), 6 factor row pairs (m <= 384)
    assert "if (m <= 352)" in src and "if (m <= 384)" in src
    assert max(m for m in range(1, 600) if bl.uses_smem(m, torch.float32)) <= 352


def test_every_c_entry_point_has_its_ctypes_signature():
    """Every ``extern "C"`` function of csrc/*.cu is declared in
    ``_build._SIGNATURES`` with one ctypes type per argument: c_void_p for
    each pointer and the stream, c_int for each int, c_int64 for each
    int64_t.  An undeclared one would get 32-bit ints and cut its pointers."""
    found = {}
    for src in sorted(_build._SRC_DIR.glob("*.cu")):
        text = src.read_text()
        blocks = re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S)
        assert blocks, src
        for block in blocks:
            for name, args in re.findall(r"\bint (\w+)\(([^)]*)\)\s*\{", block):
                kinds = []
                for arg in (a.strip() for a in args.split(",")):
                    wide = arg.startswith("int64_t ")
                    kinds.append(_build._VP if "*" in arg else _build._I64 if wide else _build._INT)
                    assert "*" in arg or wide or arg.startswith("int "), (name, arg)
                found[name] = tuple(kinds)
    assert {"pycllp_chol_bl_smem_f32", "pycllp_solve_bl_smem_f32", "pycllp_chol_bl_smem_f64",
            "pycllp_solve_bl_smem_f64", "pycllp_fused_factor_bl_smem_f32",
            "pycllp_facsol_bl_smem_f32", "pycllp_lane_matvec_f32",
            "pycllp_lane_matvec_f64"} <= found.keys()
    assert found == _build._SIGNATURES


@pytest.mark.parametrize("design", [None, "smem", "stream"])
def test_wrappers_refuse_cpu_tensors_on_every_design(design):
    """The CUDA route launches or raises, whichever design is asked for."""
    M = torch.eye(4).reshape(4, 4, 1).repeat(1, 1, 8).contiguous()
    reg = torch.zeros(8)
    L, dinv = bl.chol_bl(M, reg)  # the dispatching wrapper: CPU → plain version
    R = torch.ones(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bl._chol_bl_cuda(M, reg, design=design)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bl._solve_bl_cuda(L, dinv, R, design=design)
    with pytest.raises(ValueError, match="CUDA tensor"):
        df64._df_chol_bl_cuda(M.double(), reg.double(), design=design)
    with pytest.raises(ValueError, match="CUDA tensor"):
        df64._df_solve_bl_cuda(L.double(), dinv.double(), R.double(), design=design)


def test_cpu_tensors_leave_every_counter_at_zero(monkeypatch):
    for mod, names in ((bl, ("CHOL_LAUNCHES", "SOLVE_LAUNCHES", "CHOL_SMEM_LAUNCHES",
                             "SOLVE_SMEM_LAUNCHES")),
                       (df64, ("DF_CHOL_LAUNCHES", "DF_SOLVE_LAUNCHES", "DF_CHOL_SMEM_LAUNCHES",
                               "DF_SOLVE_SMEM_LAUNCHES"))):
        for name in names:
            monkeypatch.setattr(mod, name, 0)
    g = torch.Generator().manual_seed(0)
    A = torch.randn(6, 6, 5, generator=g, dtype=torch.float64)
    M = torch.einsum("ikb,jkb->ijb", A, A).contiguous()
    reg = torch.full((5,), 1e-3, dtype=torch.float64)
    R = torch.randn(2, 6, 5, generator=g, dtype=torch.float64)
    L, dinv = df64.df_chol_bl(M, reg)
    df64.df_solve_bl(L, dinv, R)
    L, dinv = bl.chol_bl(M.float(), reg.float())
    bl.solve_bl(L, dinv, R.float())
    assert (bl.CHOL_LAUNCHES, bl.SOLVE_LAUNCHES, bl.CHOL_SMEM_LAUNCHES,
            bl.SOLVE_SMEM_LAUNCHES) == (0, 0, 0, 0)
    assert (df64.DF_CHOL_LAUNCHES, df64.DF_SOLVE_LAUNCHES, df64.DF_CHOL_SMEM_LAUNCHES,
            df64.DF_SOLVE_SMEM_LAUNCHES) == (0, 0, 0, 0)


# the fused pair: (m, n) at the shapes the port meets (netlib afiro, sc50a,
# adlittle; the main cell)
FUSED_SHAPES = [(27, 59), (50, 98), (56, 153), (64, 128)]
FUSED_WIDTHS = (256, 300, 1024, 5120, 16384)


@pytest.mark.parametrize("kind", ["facsol", "fused"])
@pytest.mark.parametrize("m,n", FUSED_SHAPES)
def test_fused_pair_plan_fits_and_fills_the_card(m, n, kind):
    """The lane-group plans of facsol_bl and fused_factor_bl fit in a
    block's shared memory and put a block on every SM at every width the
    paths use, with the largest G that still does."""
    f32 = torch.float32
    groups = bl._LANE_GROUPS[4]
    for B in FUSED_WIDTHS:
        plan = bl.lane_plan(kind, m, B, f32, SMS, k=2, n=n)
        assert plan.design == "smem"
        assert plan.smem <= SMEM_LIMIT
        want = (bl.fused_smem_bytes(m, n, plan.lanes) if kind == "fused"
                else bl.smem_bytes(m, plan.lanes, 4))
        assert plan.smem == want
        assert plan.lanes in groups
        assert plan.blocks * plan.lanes >= B > (plan.blocks - 1) * plan.lanes
        assert plan.blocks >= min(SMS, B), (B, plan)
        bigger = [g for g in groups if g > plan.lanes and g <= B]
        assert all(-(-B // g) < min(SMS, B) for g in bigger), (B, plan)


@pytest.mark.parametrize("kind", ["facsol", "fused"])
def test_fused_pair_design_is_chosen_by_shape_alone(kind):
    """m = 27, 50, 56 and 64 with n = 59, 98, 128 and 153 take the
    lane-group design at every B; the streaming kernels run past m = 128
    for fused_factor_bl and past chol_bl's m = 340 for facsol_bl."""
    f32 = torch.float32
    for m in (27, 50, 56, 64, 128):
        for n in (59, 98, 128, 153):
            assert bl.uses_smem(m, f32, kind, n)
            assert {bl.lane_plan(kind, m, B, f32, k=2, n=n).design for B in WIDTHS} == {"smem"}
    last = {"fused": 128, "facsol": 340}[kind]
    assert bl.uses_smem(last, f32, kind, 128)
    for m in (last + 1, last + 60):
        assert not bl.uses_smem(m, f32, kind, 128)
        plans = [bl.lane_plan(kind, m, B, f32, k=2, n=128) for B in WIDTHS]
        assert {p.design for p in plans} == {"stream"}
        assert all(p.lanes == 32 and p.smem <= SMEM_LIMIT for p in plans)


def test_fused_pair_plans_at_the_main_widths():
    """The main shapes: 8-lane fused_factor_bl and facsol_bl blocks, as
    chol_bl's (three an SM)."""
    f32 = torch.float32
    assert bl.lane_plan("fused", 64, 16384, f32, n=128) == bl.LanePlan("smem", 8, 2048,
                                                                       66688 + 128 * 8 * 4)
    assert bl.lane_plan("fused", 64, 5120, f32, n=128).lanes == 8
    assert bl.lane_plan("fused", 56, 8192, f32, n=153).lanes == 8
    assert bl.lane_plan("facsol", 64, 16384, f32, k=2) == bl.lane_plan("chol", 64, 16384, f32)
    assert bl.lane_plan("fused", 64, 16384, f32, n=128, lanes=4).smem == (
        bl.smem_bytes(64, 4, 4) + 128 * 4 * 4)
    # the streaming kernels, forced
    assert bl.lane_plan("fused", 64, 16384, f32, n=128, design="stream") == bl.LanePlan(
        "stream", 32, 512, (64 + 128) * 32 * 4 + 8 * 32 * 16)
    assert bl.lane_plan("facsol", 64, 300, f32, k=2, design="stream") == bl.LanePlan(
        "stream", 32, 10, 4 * 64 * 32 * 4)
    with pytest.raises(ValueError, match="lane-group size"):
        bl.lane_plan("fused", 64, 16384, f32, n=128, lanes=12)
    with pytest.raises(ValueError, match="lane-group size"):
        bl.lane_plan("facsol", 64, 16384, f32, lanes=12)
    with pytest.raises(ValueError, match="m <= 128"):
        bl.lane_plan("fused", 129, 300, f32, n=128, design="smem")


def test_fused_pair_formulas_match_the_kernel_source():
    """fused_smem_bytes, the fused pair's built G and m limits are the
    header's: facsol_bl is built as chol_bl is, fused_factor_bl up to
    m = 128."""
    src = HEADER.read_text()
    assert "constexpr int kFormCols = 4;" in src
    assert "return (tri_stride(m, G) * G + 3) / 4 * 4;" in src  # fused_dt_offset
    assert "return (n + kFormCols - 1) / kFormCols * kFormCols;" in src  # fused_dt_rows
    assert ("(static_cast<size_t>(fused_dt_offset(m, G)) + static_cast<size_t>(fused_dt_rows(n)) "
            "* G) *\n         sizeof(float)") in src
    fused = [int(g) for g in re.findall(r"case (\d+): return launch_fused_smem_g<T, \d+>", src)]
    facsol = [int(g) for g in re.findall(r"case (\d+): return launch_facsol_smem_g<T, \d+>", src)]
    assert sorted(fused, reverse=True) == sorted(facsol, reverse=True) == list(bl._LANE_GROUPS[4])

    def limits(launcher):
        body = src[src.index(f"int {launcher}("):]
        return re.findall(r"if \(m <= (\d+)\)", body[:body.index("\n}\n")])

    assert limits("launch_facsol_smem_g") == limits("launch_chol_smem_g") == ["64", "128", "384"]
    assert limits("launch_fused_smem_g") == ["64", "128"]
    assert bl._FUSED_MAX_M == 128
    # the three kernels factor with one device routine
    assert src.count("lane_factor<T, NP>(") == 2 and src.count("lane_factor<float, NP>(") == 1


def test_lane_group_solve_forward_pass_is_left_looking():
    """solve_bl_smem_kernel's forward pass is the reference's left-looking
    one: a warp dot of the staged row with the owned w, reduced by a
    butterfly, then one subtraction by the row's owner."""
    src = HEADER.read_text()
    body = src[src.index("solve_bl_smem_kernel(const T*"):]
    body = body[:body.index("\n}\n")]
    forward = body[body.index("// forward"):body.index("// backward")]
    assert "left-looking" in forward and "__shfl_xor_sync" in forward
    assert "(slot(v[q], ir) - dot[q]) * di" in forward


@pytest.mark.parametrize("design", [None, "smem", "stream"])
def test_fused_pair_wrappers_refuse_cpu_tensors_on_every_design(design):
    m, n, B = 4, 6, 8
    W = torch.ones(m * m, n)
    dT = torch.ones(n, B)
    reg = torch.zeros(B)
    M = torch.eye(m).reshape(m, m, 1).repeat(1, 1, B).contiguous()
    with pytest.raises(ValueError, match="CUDA tensor"):
        bl._fused_factor_bl_cuda(W, dT, reg, design=design)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bl._facsol_bl_cuda(M, reg, torch.ones(2, m, B), design=design)


def test_cpu_tensors_leave_the_fused_pair_counters_at_zero(monkeypatch):
    names = ("FUSED_FACTOR_LAUNCHES", "FACSOL_LAUNCHES", "FUSED_FACTOR_SMEM_LAUNCHES",
             "FACSOL_SMEM_LAUNCHES")
    for name in names:
        monkeypatch.setattr(bl, name, 0)
    g = torch.Generator().manual_seed(1)
    A = torch.randn(5, 9, generator=g)
    W = (A[:, None, :] * A[None, :, :]).reshape(25, 9)
    dT = torch.rand(9, 6, generator=g) + 0.5
    reg = torch.full((6,), 1e-6)
    L, dinv = bl.fused_factor_bl(W, dT, reg)
    M = (W @ dT).reshape(5, 5, 6)
    bl.facsol_bl(M, reg, torch.randn(3, 5, 6, generator=g))
    assert torch.isfinite(L.tril().permute(2, 0, 1)).all() and torch.isfinite(dinv).all()
    assert tuple(getattr(bl, n) for n in names) == (0, 0, 0, 0)


def test_fused_factor_reads_w_packed_and_transposed():
    """The lane-group fused_factor_bl reads W's lower-triangle rows in the
    triangle's packed order i(i+1)/2 + j, as the columns of an (n, m(m+1)/2)
    tensor."""
    m, n = 6, 5
    W = torch.arange(m * m * n, dtype=torch.float32).reshape(m * m, n)
    Wp = bl.pack_w(W)
    assert Wp.shape == (n, m * (m + 1) // 2) and Wp.is_contiguous()
    e = 0
    for i in range(m):
        for j in range(i + 1):
            assert torch.equal(Wp[:, e], W[i * m + j])
            e += 1


@pytest.mark.parametrize("m", [1, 27, 56, 64, 100, 128, 129, 200, 340, 341, 380])
def test_facsol_plan_is_the_factors(m):
    """facsol_bl runs the factor's device routine on the factor's staged
    triangle, so its plan is chol_bl's at every m and width."""
    f32 = torch.float32
    assert bl.uses_smem(m, f32, "facsol") == bl.uses_smem(m, f32, "chol")
    for B in WIDTHS:
        chol = bl.lane_plan("chol", m, B, f32, SMS)
        facsol = bl.lane_plan("facsol", m, B, f32, SMS, k=2)
        if chol.design == "smem":
            assert facsol == chol
        else:
            assert facsol.design == "stream" and facsol.blocks == chol.blocks


def test_fused_form_set_packs_w_once_per_a(monkeypatch):
    """The fused-form set packs W in prepare (m <= 128) and hands the packed
    W to every fused_factor_bl call; the other sets, and larger m, pack
    nothing."""
    g = torch.Generator().manual_seed(2)
    A = torch.randn(5, 9, generator=g)
    ctx = bl.BATCHLAST_FUSED_KERNELS.prepare(A)
    assert torch.equal(ctx.Wp, bl.pack_w(ctx.W))
    assert bl.BATCHLAST_KERNELS.prepare(A).Wp is None
    assert bl.BatchLastKernels(fuse_facsol=True).prepare(A).Wp is None
    assert bl.BATCHLAST_FUSED_KERNELS.prepare(torch.randn(129, 3, generator=g)).Wp is None
    seen = []

    def fused(W, dT, reg, Wp=None):
        seen.append(Wp)
        return bl._fused_factor_bl_plain(W, dT, reg)

    monkeypatch.setattr(bl, "fused_factor_bl", fused)
    d = torch.rand(6, 9, generator=g) + 0.5
    for _ in range(2):
        bl.BATCHLAST_FUSED_KERNELS.factor(ctx, d, 1e-6)
    assert len(seen) == 2 and all(w is ctx.Wp for w in seen)
