"""The counters that the streaming kernels, the prepared operands and the
vertex crossover keep, and the benchmark's readers of them.

On the CPU:

* the capture bookkeeping of ``_loop``: a capture's increments of an int
  counter and of a Counter of launch shapes are taken back, and each
  replay adds them again;
* ``hsd.PREPARED_BYTES`` after a batched solve: one key a kernel set, its
  context's bytes, the crossover's set prepared in both crossovers;
* ``hsd.CROSSOVER_LANES``: every lane tried in each crossover, the
  accepted ones among them;
* the readers ``stream_ms``, ``stream_chol_roofline``,
  ``crossover_accept_share`` and ``prepared_gib`` on synthetic traces and
  counters, and nothing read where there is nothing to read.

On a card only (skipped here): a solve whose m takes the streaming
kernels records their shapes, the same on the graph route as with eager
segments.  The file imports no JAX: on the card run it alone, without the
suite's ``conftest.py``:
``python -m pytest tests/test_torch_stream_counters.py --noconftest -o addopts="" -q``.
"""

import collections
import types

import numpy as np
import pytest
import torch

import pycllp_tpu_torch as port_pkg
from lpbench import harness
from lpbench.harness import Run
from lpbench.inputs import generate
from lpbench.trace import Event, Trace
from pycllp_tpu_torch.ops import batchlast, df64
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.solvers import _loop, hsd

# bench.py's options at its defaults, the netlib3 cells'
BENCH = port_pkg.SolverOptions(
    tol=1e-6, maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, kkt_warmup=0, gondzio_correctors=0,
    init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5, finish_maxiter=20,
    finish_gondzio=0, finish_mode="crossover", crossover_kset="mixed1", crossover_repair=2,
    crossover_refine=2, crossover_feas_tol=1e-9, finish_kkt_refine=0,
)


def _scenarios(m, n, B, seed=5, dtype=np.float32):
    """B b-scenarios of one equality-form LP of m rows, as the benchmark's
    netlib stand-ins make them."""
    A, b, c = generate.equality_form(*generate.random_standard_lp(m, n, seed=seed))
    scale = 1.0 + 0.1 * np.random.default_rng(seed).random((B, 1))
    return (A.astype(dtype), (b[None] * scale).astype(dtype),
            np.broadcast_to(c, (B, c.shape[0])).astype(dtype))


def read(name, run):
    return harness.reader(name).read(run)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def test_capture_takes_back_each_counter_and_replays_add_it():
    ns = types.SimpleNamespace(N_LAUNCHES=5, SHAPE_LAUNCHES=collections.Counter({"a": 1}))
    shapes = ns.SHAPE_LAUNCHES
    counters = [(ns, "N_LAUNCHES"), (ns, "SHAPE_LAUNCHES")]
    before = [5, collections.Counter(shapes)]
    # what a capture's launches add
    ns.N_LAUNCHES += 3
    shapes[("chol", "f32", 471, 4096, 1)] += 2
    shapes["a"] += 1
    deltas = _loop._take_back(counters, before)
    assert ns.N_LAUNCHES == 5 and ns.SHAPE_LAUNCHES is shapes
    assert shapes == collections.Counter({"a": 1})
    for _ in range(3):
        _loop._add_back(deltas)
    assert ns.N_LAUNCHES == 5 + 9
    assert shapes == collections.Counter({"a": 4, ("chol", "f32", 471, 4096, 1): 6})
    # a counter the capture left alone gives no delta
    assert _loop._take_back(counters, [ns.N_LAUNCHES, collections.Counter(shapes)]) == []


def test_loop_counts_the_shapes_and_the_prepares():
    names = {(mod.__name__, name) for mod, name in _loop._counters()}
    assert ("pycllp_tpu_torch.ops.batchlast", "STREAM_LAUNCHES") in names
    assert ("pycllp_tpu_torch.solvers.hsd", "PREPARED_BYTES") in names


def test_cpu_solves_record_no_streaming_launch(monkeypatch):
    monkeypatch.setattr(batchlast, "STREAM_LAUNCHES", collections.Counter())
    A, b, c = _scenarios(8, 10, 6)
    hsd.hsd_solve_batched(A, b, c, BENCH, BATCHLAST_KERNELS, device="cpu")
    assert not batchlast.STREAM_LAUNCHES


def test_prepared_bytes_and_crossover_lanes_of_a_batched_solve(monkeypatch):
    monkeypatch.setattr(hsd, "CROSSOVER_LANES", {})
    m, n, B = 12, 14, 9
    A, b, c = _scenarios(m, n, B)
    N = A.shape[1]
    out = hsd.hsd_solve_batched(A, b, c, BENCH, BATCHLAST_KERNELS, device="cpu")
    wide = df64.DF64_FINISH_KERNELS
    cross = BATCHLAST_KERNELS.finish_kernels("mixed1")
    prepared = dict(hsd.PREPARED_BYTES)
    assert {(name, k) for (name, _), k in prepared.items()} == {
        (BATCHLAST_KERNELS.name, 1), (wide.name, 1), (cross.name, 2)}
    nbytes = {name: size for name, size in prepared}
    # the narrow set: A, A² and W = A∘A in f32
    assert nbytes[BATCHLAST_KERNELS.name] == (2 * m * N + m * m * N) * 4
    # the wide set holds W in f64 and its packed Ozaki operand besides
    s, n_slices, _ = df64.ozaki_params(N)
    packed = -(-m * m // 32) * 32 * n_slices * -(-N // 16) * 16 * 2
    assert nbytes[wide.name] > m * m * N * 8 + packed
    # the crossover's: the narrow set's context within it
    assert nbytes[cross.name] > nbytes[BATCHLAST_KERNELS.name]
    # a second call counts its own prepares only
    hsd.hsd_solve_batched(A, b, c, BENCH, BATCHLAST_KERNELS, device="cpu")
    assert dict(hsd.PREPARED_BYTES) == prepared
    # every lane tried in the first crossover and in the final one, twice
    lanes = {k: v.tolist() for k, v in hsd.CROSSOVER_LANES.items()}
    assert set(lanes) == {("cpu", "first"), ("cpu", "final")}
    for tried, accepted in lanes.values():
        assert tried == 2 * B and 0 <= accepted <= tried
    assert (out["status"] == int(port_pkg.Status.OPTIMAL)).all()


def test_narrow_only_solve_prepares_one_set():
    A, b, c = _scenarios(6, 8, 4)
    opts = port_pkg.SolverOptions(dtype="float32")
    hsd.hsd_solve_batched(A, b, c, opts, BATCHLAST_KERNELS, device="cpu")
    assert [name for name, _ in hsd.PREPARED_BYTES] == [BATCHLAST_KERNELS.name]


# the readers --------------------------------------------------------------

F32_CHOL = "void (anonymous namespace)::chol_bl_kernel<float>(float const*, float const*, float*, float*, int, int)"  # noqa: E501
F64_SOLVE = "void (anonymous namespace)::solve_bl_kernel<double>(double const*, double const*, double const*, double*, int, int, int)"  # noqa: E501


def _trace():
    kernels = [Event(F32_CHOL, 0, 100_000), Event(F32_CHOL, 200_000, 300_000),
               Event(F64_SOLVE, 300_000, 300_500),
               Event("void (anonymous namespace)::chol_bl_smem_kernel<float, 8, 1, float>()",
                     400_000, 401_000),
               Event("void (anonymous namespace)::solve_bl_smem_kernel<double, 4, 2>()",
                     401_000, 401_200),
               Event("void (anonymous namespace)::facsol_bl_kernel(float*)", 402_000, 403_000),
               Event("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", 500_000, 530_000)]
    return Trace(kernels=kernels, window_s=1.0, batches=2)


def test_stream_ms_reads_the_streaming_kernels_alone():
    kind = harness.reader("stream_ms").stream_kind
    assert kind(F32_CHOL) == ("chol", "float") and kind(F64_SOLVE) == ("solve", "double")
    assert kind("void (anonymous namespace)::chol_bl_smem_kernel<float, 8, 1, float>()") is None
    assert kind("void (anonymous namespace)::facsol_bl_kernel(float*)") is None
    # two f32 factors of 100 ms and one f64 solve of 0.5 ms, over 2 calls
    assert read("stream_ms", Run(trace=_trace())) == pytest.approx(200.5 / 2)


def test_stream_chol_roofline_at_scagr25(monkeypatch):
    m, B = 471, 4096
    flops_s = B * m**3 / 3 / 66.9e12
    bytes_s = B * m * (m + 1) / 2 * 4 * 2 / 3.35e12
    roof = harness.reader("stream_chol_roofline")
    # FP32 bounds it at this shape: 2.13 ms against the triangle's 1.09 ms
    assert roof.bound_s(m, B) == pytest.approx(flops_s) and flops_s > bytes_s
    assert flops_s == pytest.approx(2.1324e-3, rel=1e-4)
    shapes = collections.Counter({("chol", "f32", m, B, 1): 26, ("solve", "f32", m, B, 2): 90,
                                  ("chol", "f64", m, B, 1): 8})
    monkeypatch.setattr(batchlast, "STREAM_LAUNCHES", shapes)
    # each f32 launch of the trace takes 100 ms
    assert read("stream_chol_roofline", Run(trace=_trace())) == pytest.approx(
        100 * flops_s / 0.1)
    # launch-weighted over two shapes: 3 launches at B, 1 at B/2
    shapes[("chol", "f32", m, B // 2, 1)] = 26 // 2
    want = (26 * roof.bound_s(m, B) + 13 * roof.bound_s(m, B // 2)) / 39
    assert read("stream_chol_roofline", Run(trace=_trace())) == pytest.approx(100 * want / 0.1)


def test_crossover_and_prepared_readers(monkeypatch):
    monkeypatch.setattr(hsd, "CROSSOVER_LANES", {("cuda:0", "first"): torch.tensor([4096, 1024]),
                                                 ("cuda:0", "final"): torch.tensor([4096, 3072])})
    assert read("crossover_accept_share", Run()) == pytest.approx(50.0)
    monkeypatch.setattr(hsd, "PREPARED_BYTES", collections.Counter(
        {("narrow", 2**30): 1, ("wide", 6 * 2**30): 1, ("cross", 2**30): 2}))
    assert read("prepared_gib", Run()) == pytest.approx(8.0)


@pytest.mark.parametrize("name", ["stream_ms", "stream_chol_roofline", "crossover_accept_share",
                                  "prepared_gib"])
def test_nothing_to_read_gives_nothing(monkeypatch, name):
    monkeypatch.setattr(hsd, "CROSSOVER_LANES", {})
    monkeypatch.setattr(hsd, "PREPARED_BYTES", collections.Counter())
    monkeypatch.setattr(batchlast, "STREAM_LAUNCHES", collections.Counter())
    assert read(name, Run()) is None
    assert read(name, Run(trace=Trace(batches=1))) is None
    if name == "stream_ms":  # reads the trace alone
        return
    # a program without the counters (the parent of this benchmark's cells)
    for mod, attr in ((hsd, "CROSSOVER_LANES"), (hsd, "PREPARED_BYTES"),
                      (batchlast, "STREAM_LAUNCHES")):
        monkeypatch.delattr(mod, attr)
    assert read(name, Run(trace=_trace())) is None


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the streaming kernels run only on the card")
    return torch.device("cuda", 0)


def test_streaming_shapes_count_at_replay(card, monkeypatch):
    """A batch at m = 341 (f32 and f64 factors and solves on the streaming
    design): the graph route records the shapes the eager segments record,
    launch for launch, on its first call and on a call of replays."""
    m, B = 341, 64
    A, b, c = _scenarios(m, 40, B, seed=7)

    def shapes():
        before = collections.Counter(batchlast.STREAM_LAUNCHES)
        hsd.hsd_solve_batched(A, b, c, BENCH, BATCHLAST_KERNELS, device=card)
        torch.cuda.synchronize()
        return batchlast.STREAM_LAUNCHES - before

    first, second = shapes(), shapes()
    monkeypatch.setattr(hsd, "_EAGER_SEGMENTS", True)
    eager = shapes()
    assert first == second == eager
    kinds = {(kind, dt) for kind, dt, mm, bb, _ in first if (mm, bb) == (m, B)}
    assert kinds == {("chol", "f32"), ("solve", "f32"), ("chol", "f64"), ("solve", "f64")}
