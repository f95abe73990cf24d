"""The lane matvec (``ops/lanemv.py``, ``csrc/lanemv.cu``): per-instance
A·x, Aᵀ·y and the normal product A(d ∘ Aᵀv) + δv.

On the CPU:

* the plain versions are the einsum expressions the kernel sets used
  before, bit for bit, and the plain normal product is
  ``mv(d * rmv(v)) + reg * v``;
* each set's ``mv``/``rmv``/``matvec_M``/``factor`` on a 3-D CPU A returns
  exactly what the pre-kernel route (``reference._mv``/``_rmv`` and the
  base ``matvec_M``) returns;
* a shared 2-D A never reaches the module, in the sets or in a solve;
* the padded netlib solve hands the module only operands the CUDA wrapper
  takes (shape, dtype, contiguity), and takes all three modes;
* the launch plan (tile, copy width, ring, grid) and the kernel's names.

On a card only (skipped here): the kernel against its plain version in
f32 and f64 for each mode at the padded shape, a ragged small shape and
lanes larger than one stage, with tolerances relative to Σ|A||x|; the
fused normal product bitwise the unfused launches; a captured launch
counted at each replay; a repeat padded solve bitwise.  The file imports
no JAX: on the card run it alone, without the suite's ``conftest.py``:
``python -m pytest tests/test_torch_lanemv.py --noconftest -o addopts="" -q``.
"""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pycllp_tpu_torch as port_pkg
from lpbench.inputs import traffic
from lpbench.kernel_names import is_library
from pycllp_tpu_torch.ops import _build, batchlast, df64, lanemv, mixed, reference
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.solvers import _loop, hsd

ROOT = Path(__file__).resolve().parent.parent
SETS = {
    "batchlast": BATCHLAST_KERNELS,
    "df64": df64.DF64_FINISH_KERNELS,
    "mixed1": mixed.MIXED_IR1_KERNELS,
}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _lanes(B, m, n, dtype, seed=0, device="cpu"):
    """A (B, m, n) with a zero column and a zero row per lane, as padding
    leaves them, and positive d, v, x, y and reg."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, m, n, generator=g, dtype=torch.float64)
    A[:, :, -1] = 0.0
    A[:, -1, :] = 0.0
    vecs = dict(x=torch.randn(B, n, generator=g, dtype=torch.float64),
                y=torch.randn(B, m, generator=g, dtype=torch.float64),
                d=torch.rand(B, n, generator=g, dtype=torch.float64) * 10 + 0.1,
                reg=torch.rand(B, generator=g, dtype=torch.float64) * 1e-3)
    return A.to(device, dtype), {k: v.to(device, dtype) for k, v in vecs.items()}


def _padded_batch(per: int):
    """The netlib3-padded cell's batch at ``per`` replicas a fixture."""
    cfg = json.loads((ROOT / "lpbench" / "configs" / "netlib3.json").read_text())
    wl = traffic.make(cfg, {"layout": "padded", "lps_per_group": per}, 2**31 + 17)
    return wl.batches[0], port_pkg.SolverOptions(**cfg["options"])


def _pre_kernel_routes(monkeypatch):
    """Route the sets as before the kernel: ``reference._mv``/``_rmv`` for
    every A and the base class's ``matvec_M``."""
    for mod in (batchlast, df64, mixed):
        monkeypatch.setattr(mod, "_amv", reference._mv)
        monkeypatch.setattr(mod, "_armv", reference._rmv)
    for cls in (batchlast.BatchLastKernels, df64.DoubleSingleKernels, mixed.MixedPrecisionKernels):
        monkeypatch.setattr(cls, "matvec_M", reference.KernelSet.matvec_M)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_plain_versions_are_the_einsum_expressions(dtype):
    A, v = _lanes(5, 7, 11, DTYPES[dtype])
    mv = torch.einsum("...mn,...n->...m", A, v["x"])
    rmv = torch.einsum("...mn,...m->...n", A, v["y"])
    assert torch.equal(lanemv._lane_mv_plain(A, v["x"]), mv)
    assert torch.equal(lanemv._lane_rmv_plain(A, v["y"]), rmv)
    assert torch.equal(lanemv.lane_mv(A, v["x"]), mv)
    assert torch.equal(lanemv.lane_rmv(A, v["y"]), rmv)
    t = torch.einsum("...mn,...m->...n", A, v["y"])
    normal = torch.einsum("...mn,...n->...m", A, v["d"] * t) + v["reg"][..., None] * v["y"]
    assert torch.equal(lanemv._lane_normal_plain(A, v["d"], v["y"], v["reg"]), normal)
    assert torch.equal(lanemv.lane_normal(A, v["d"], v["y"], v["reg"]), normal)


def _wide(kset):
    return torch.float32 if kset is BATCHLAST_KERNELS else torch.float64


def _set_call(kset, op, A, v):
    ctx = kset.prepare(A)
    if op == "mv":
        return (kset.mv(ctx, v["x"]),)
    if op == "rmv":
        return (kset.rmv(ctx, v["y"]),)
    fac = kset.factor(ctx, v["d"], 1e-8)
    if op == "matvec_M":
        return (kset.matvec_M(fac, v["y"]),)
    return tuple(t for t in fac if isinstance(t, torch.Tensor)) + (kset.solve(fac, (v["y"],))[0],)


@pytest.mark.parametrize("op", ["mv", "rmv", "matvec_M", "factor"])
@pytest.mark.parametrize("name", list(SETS))
def test_sets_on_per_instance_cpu_A_return_what_they_did(name, op, monkeypatch):
    """On a CPU 3-D A every set answers bitwise as through the pre-kernel
    routes (the kernel's plain versions are those routes' expressions)."""
    kset = SETS[name]
    A, v = _lanes(6, 9, 14, _wide(kset), seed=3)
    v["d"] = v["d"].abs() + 0.5
    new = _set_call(kset, op, A, v)
    with monkeypatch.context() as mp:
        _pre_kernel_routes(mp)
        old = _set_call(kset, op, A, v)
    assert len(new) == len(old) > 0
    for a, b in zip(new, old):
        assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(), b.nan_to_num())


def _forbid_lanemv(monkeypatch, calls=None):
    """Make every entry of the module raise on a 2-D A (or count 3-D A)."""
    def guard(name):
        real = getattr(lanemv, name)

        def f(A, *args):
            if A.dim() != 3:
                raise AssertionError(f"{name} got a {A.dim()}-D A")
            if calls is not None:
                calls[name] += 1
            return real(A, *args)
        return f
    for name in ("lane_mv", "lane_rmv", "lane_normal"):
        monkeypatch.setattr(lanemv, name, guard(name))


@pytest.mark.parametrize("name", list(SETS))
def test_shared_A_never_reaches_the_module(name, monkeypatch):
    kset = SETS[name]
    calls = collections.Counter()
    _forbid_lanemv(monkeypatch, calls)
    A, v = _lanes(1, 9, 14, _wide(kset), seed=5)
    A = A[0]
    v["d"] = v["d"].repeat(4, 1)
    v["x"], v["y"] = v["x"].repeat(4, 1), v["y"].repeat(4, 1)
    for op in ("mv", "rmv", "matvec_M", "factor"):
        _set_call(kset, op, A, v)
    assert sum(calls.values()) == 0


def test_shared_A_solve_never_reaches_the_module(monkeypatch):
    """netlib3's shared-A bucket solve (f32 narrow, df64 finish, mixed1
    crossover) takes none of the module's products."""
    calls = collections.Counter()
    _forbid_lanemv(monkeypatch, calls)
    batch, opts = _padded_batch(2)
    A, b, c = batch.A[0], batch.b[:2], batch.c[:2]
    out = hsd.hsd_solve_batched(A, b, c, opts, BATCHLAST_KERNELS, device="cpu")
    assert (out["status"] == int(port_pkg.Status.OPTIMAL)).all()
    assert sum(calls.values()) == 0


def test_padded_solve_hands_the_kernel_what_it_takes(monkeypatch):
    """The netlib3-padded solve on the CPU: every operand the module gets
    passes the CUDA wrapper's checks, and all three modes run, in f32 (the
    narrow IPM) and f64 (the finish and the crossover)."""
    seen = collections.Counter()
    for name, keys in (("_lane_mv_plain", ("x",)), ("_lane_rmv_plain", ("y",)),
                       ("_lane_normal_plain", ("s", "y", "reg"))):
        real = getattr(lanemv, name)

        def checked(A, *vs, real=real, keys=keys, name=name):
            lanemv._operands(A, **dict(zip(keys, vs)))
            seen[name, A.dtype] += 1
            return real(A, *vs)
        monkeypatch.setattr(lanemv, name, checked)
    batch, opts = _padded_batch(2)
    out = hsd.hsd_solve_batched(batch.A, batch.b, batch.c, opts, BATCHLAST_KERNELS, device="cpu")
    assert (out["status"] == int(port_pkg.Status.OPTIMAL)).all()
    for mode in ("_lane_mv_plain", "_lane_rmv_plain"):
        assert seen[mode, torch.float32] > 0 and seen[mode, torch.float64] > 0, seen
    assert seen["_lane_normal_plain", torch.float64] > 0, seen


def test_operands_refuse_what_the_kernel_does_not_take():
    A, v = _lanes(3, 4, 5, torch.float32)
    assert lanemv._operands(A, x=v["x"][0])["x"].stride() == (0, 1)  # broadcast lanes
    with pytest.raises(ValueError, match="contiguous"):
        lanemv._operands(A.transpose(1, 2).contiguous().transpose(1, 2), x=v["x"])
    with pytest.raises(ValueError, match="float32"):
        lanemv._operands(A, x=v["x"].double())
    with pytest.raises(ValueError, match="broadcast"):
        lanemv._operands(A, y=v["x"])
    with pytest.raises(ValueError, match=r"\(B, m, n\)"):
        lanemv._operands(A[0], x=v["x"])
    with pytest.raises(ValueError, match="CUDA"):
        lanemv._lane_mv_cuda(A, v["x"])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", [(56, 153), (27, 32), (50, 98), (27, 59), (300, 700),
                                   (5, 20000), (1, 1), (3, 31), (301, 701)])
def test_plan_fits_and_covers_every_lane(shape, dtype):
    """Every (m, n) runs: a ring within a block's shared memory, tiles that
    cover the lane, bulk copies only of 16-byte aligned runs, and no block
    without a lane."""
    m, n = shape
    dt = DTYPES[dtype]
    size = dt.itemsize
    for B in (1, 7, 300, 24576):
        p = lanemv.lane_mv_plan(m, n, B, dt, 132)
        assert p.smem == 3 * (lanemv.stage_len(p.rows, p.cols) * size + 8)
        assert p.smem <= batchlast._SMEM_LIMIT
        assert 1 <= p.grid <= min(B, 4 * 132)
        assert p.grid == B or p.grid % 132 == 0  # a block on every SM, or one a lane
        assert 1 <= p.rows <= m and 1 <= p.cols <= n
        assert p.whole == ((p.rows, p.cols) == (m, n))
        assert p.cols == n or p.rows == 1 and p.cols % 4 == 0
        run = m * n if p.whole else n  # elements of a lane or a row
        assert p.bulk == (run * size % 16 == 0)
    assert not lanemv.lane_mv_plan(m, n, 5, dt, aligned=False).bulk


def test_plan_at_the_padded_shape():
    """24,576 lanes of 56 x 153: one stage holds a lane in both widths (so
    the normal product is one launch), each a bulk copy, two blocks a SM
    in f32 and one in f64."""
    f32 = lanemv.lane_mv_plan(56, 153, 24576, torch.float32, 132)
    f64 = lanemv.lane_mv_plan(56, 153, 24576, torch.float64, 132)
    assert f32 == lanemv.LaneMvPlan(56, 153, True, True, 107304, 264)
    assert f64 == lanemv.LaneMvPlan(56, 153, True, True, 214584, 132)
    big = lanemv.lane_mv_plan(300, 700, 3, torch.float64, 132)
    assert not big.whole and big.cols == 700 and big.grid == 3
    assert not lanemv.lane_mv_plan(301, 701, 3, torch.float64, 132).bulk


def test_stage_layout_matches_the_source():
    src = (_build._SRC_DIR / "lanemv.cu").read_text()
    assert ("return lanemv_round4(P * Q) + 2 * lanemv_round4(Q) + lanemv_round4(P) + 4;"
            in src)
    assert "return kLaneMvStages * (lanemv_stage_len(P, Q) * size + 8);" in src
    assert f"constexpr int kLaneMvStages = {lanemv._STAGES};" in src


def test_kernel_names_are_the_programs():
    src = (_build._SRC_DIR / "lanemv.cu").read_text()
    for name in lanemv.KERNEL_NAMES:
        assert f"{name}(" in src
        assert not is_library(name)
        # as a profiler shows one instantiation
        shown = (f"void (anonymous namespace)::{name}<double, true, 2>"
                 "((anonymous namespace)::LaneMvArgs<double>)")
        assert not is_library(shown)


def test_loop_counts_the_modules_launches():
    names = {(mod.__name__, name) for mod, name in _loop._counters()}
    for counter in ("LANE_MV_LAUNCHES", "LANE_RMV_LAUNCHES", "LANE_NORMAL_LAUNCHES"):
        assert ("pycllp_tpu_torch.ops.lanemv", counter) in names


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the lane matvec kernel runs only on the card")
    return torch.device("cuda", 0)


# the padded cell's lanes, a ragged batch, lanes of row tiles and of row
# pieces (bulk copies), and odd shapes that take element copies (small
# lanes, many lanes, row tiles)
CARD_SHAPES = {"padded": (24576, 56, 153), "ragged": (301, 27, 32), "rows": (3, 300, 700),
               "pieces": (2, 5, 20000), "odd": (257, 7, 9), "many": (40000, 3, 5),
               "odd_rows": (2, 301, 701)}


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernel_matches_plain_on_the_card(card, shape, dtype):
    """Each mode against its plain version, within 2·k·ε of Σ|A||x| (k the
    contraction length; the normal product's sum of its two products'
    bounds), at the padded shape, a ragged one, lanes of row tiles and
    lanes of column pieces."""
    B, m, n = CARD_SHAPES[shape]
    A, v = _lanes(B, m, n, DTYPES[dtype], seed=11, device=card)
    absA = A.abs()
    eps = torch.finfo(A.dtype).eps
    got = lanemv.lane_mv(A, v["x"])
    want = lanemv._lane_mv_plain(A, v["x"])
    scale = lanemv._lane_mv_plain(absA, v["x"].abs())
    assert ((got - want).abs() <= 2 * n * eps * scale).all()
    got = lanemv.lane_rmv(A, v["y"])
    want = lanemv._lane_rmv_plain(A, v["y"])
    scale = lanemv._lane_rmv_plain(absA, v["y"].abs())
    assert ((got - want).abs() <= 2 * m * eps * scale).all()
    got = lanemv.lane_normal(A, v["d"], v["y"], v["reg"])
    want = lanemv._lane_normal_plain(A, v["d"], v["y"], v["reg"])
    scale = (lanemv._lane_mv_plain(absA, v["d"] * lanemv._lane_rmv_plain(absA, v["y"].abs()))
             + v["reg"][:, None] * v["y"].abs())
    assert ((got - want).abs() <= 2 * (m + n + 2) * eps * scale).all()
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", ["padded", "rows", "odd", "many"])
def test_normal_product_is_bitwise_the_unfused_launches(card, shape, dtype):
    B, m, n = CARD_SHAPES[shape]
    A, v = _lanes(B, m, n, DTYPES[dtype], seed=13, device=card)
    fused = lanemv.lane_normal(A, v["d"], v["y"], v["reg"])
    split = lanemv.lane_mv(A, v["d"] * lanemv.lane_rmv(A, v["y"])) + v["reg"][:, None] * v["y"]
    assert torch.equal(fused, split)
    # and a repeat gives the same bits
    assert torch.equal(lanemv.lane_normal(A, v["d"], v["y"], v["reg"]), fused)


def test_strided_and_broadcast_vectors_on_the_card(card):
    A, v = _lanes(64, 56, 153, torch.float64, seed=17, device=card)
    yT = v["y"].T.contiguous().T  # strides (1, B), as a solve's output
    assert torch.equal(lanemv.lane_rmv(A, yT), lanemv.lane_rmv(A, v["y"]))
    x0 = v["x"][0]
    assert torch.equal(lanemv.lane_mv(A, x0), lanemv.lane_mv(A, x0.expand(64, 153).contiguous()))


def test_capture_counts_each_replay(card):
    A, v = _lanes(300, 56, 153, torch.float32, seed=19, device=card)
    out = torch.empty(300, 56, dtype=torch.float32, device=card)

    def run():
        out.copy_(lanemv.lane_normal(A, v["d"], v["y"], v["reg"]))

    run()  # builds the library and warms up outside the capture
    torch.cuda.synchronize()
    before = lanemv.LANE_NORMAL_LAUNCHES
    graph, deltas = _loop._capture(card, run)
    try:
        assert lanemv.LANE_NORMAL_LAUNCHES == before
        for _ in range(3):
            _loop._replay(graph, deltas, "loop replay")
        torch.cuda.synchronize()
        assert lanemv.LANE_NORMAL_LAUNCHES == before + 3
        assert torch.equal(out, lanemv.lane_normal(A, v["d"], v["y"], v["reg"]))
    finally:
        # the graph leaves the shared pool: drop the pool with it, as a
        # pool whose graphs are all gone takes no new capture
        del graph
        _loop._clear_graphs()


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_repeat_padded_solve_is_bitwise(card):
    """A padded netlib batch solved twice on the card: the same bits, with
    every mode launched; a shared-A bucket launches none."""
    batch, opts = _padded_batch(64)
    before = [lanemv.LANE_MV_LAUNCHES, lanemv.LANE_RMV_LAUNCHES, lanemv.LANE_NORMAL_LAUNCHES]
    first = hsd.hsd_solve_batched(batch.A, batch.b, batch.c, opts, BATCHLAST_KERNELS, device=card)
    after = [lanemv.LANE_MV_LAUNCHES, lanemv.LANE_RMV_LAUNCHES, lanemv.LANE_NORMAL_LAUNCHES]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    second = hsd.hsd_solve_batched(batch.A, batch.b, batch.c, opts, BATCHLAST_KERNELS, device=card)
    for k in first:
        np.testing.assert_array_equal(_host(first[k]), _host(second[k]), err_msg=k)
    assert (_host(first["status"]) == int(port_pkg.Status.OPTIMAL)).all()
    before = [lanemv.LANE_MV_LAUNCHES, lanemv.LANE_RMV_LAUNCHES, lanemv.LANE_NORMAL_LAUNCHES]
    hsd.hsd_solve_batched(batch.A[0], batch.b[:64], batch.c[:64], opts, BATCHLAST_KERNELS,
                          device=card)
    torch.cuda.synchronize()
    assert [lanemv.LANE_MV_LAUNCHES, lanemv.LANE_RMV_LAUNCHES,
            lanemv.LANE_NORMAL_LAUNCHES] == before
