"""The launch plan of the batch-last factor and solve, on the CPU.

The lane-group kernels (``csrc/batchlast_smem.cuh``) run only on the card;
what surrounds them is Python that these tests reach: the choice between
the lane-group and the streaming design (by m and dtype alone), the
lane-group size G, the grid and the shared memory of each launch, and the
C entry points' ctypes signatures.  The kernels themselves are held
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
    each pointer and the stream, c_int for each int.  An undeclared one
    would get 32-bit ints and cut its pointers."""
    found = {}
    for src in sorted(_build._SRC_DIR.glob("*.cu")):
        text = src.read_text()
        blocks = re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S)
        assert blocks, src
        for block in blocks:
            for name, args in re.findall(r"\bint (\w+)\(([^)]*)\)\s*\{", block):
                kinds = []
                for arg in (a.strip() for a in args.split(",")):
                    kinds.append(_build._VP if "*" in arg else _build._INT)
                    assert "*" in arg or arg.startswith("int "), (name, arg)
                found[name] = tuple(kinds)
    assert {"pycllp_chol_bl_smem_f32", "pycllp_solve_bl_smem_f32", "pycllp_chol_bl_smem_f64",
            "pycllp_solve_bl_smem_f64"} <= found.keys()
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
