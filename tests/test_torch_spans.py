"""The port's profiler ranges at its layer boundaries.

Under ``torch.profiler`` (CPU activity) on small LPs:

* each entry call opens its own range, and every range of the call nests
  in it: ``hsd_solve_scan`` holds ``narrow stage`` then ``finish stage``,
  each with at least one ``ipm phase`` and one ``segment``;
  ``hsd_solve_batched`` holds phases and segments and no stage;
  ``scenario_sweep`` holds one ``sweep pull`` a window and a ``sweep
  write`` a chunk file;
* no ``ipm phase`` nests in a ``segment``, nor the reverse;
* the answers are bitwise those of the same call without the profiler.

``_loop.CAPTURE_SECONDS`` leaves out a kernel build run inside a graph's
warm-up.  On a card only: it grows with ``_loop.GRAPH_CAPTURES`` on a
first solve, by one ``graph capture`` range a graph, and not at all on a
second.

This file imports no JAX: on the card run it alone, without the suite's
``conftest.py``:
``python -m pytest tests/test_torch_spans.py --noconftest -o addopts="" -q``.
"""

import functools
import types

import numpy as np
import pytest
import torch

import pycllp_tpu_torch as port_pkg
from pycllp_tpu_torch.io.generate import random_standard_lp
from pycllp_tpu_torch.ops.batchlast import BATCHLAST_KERNELS
from pycllp_tpu_torch.solvers import _loop
from pycllp_tpu_torch.solvers import hsd
from pycllp_tpu_torch.utils.sweep import scenario_sweep

# bench.py's options, with the finish as a capped wide IPM so that the
# finish stage runs IPM phases whatever the narrow stage left
OPTIONS = dict(
    tol=1e-6, maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, kkt_warmup=0, gondzio_correctors=0,
    init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5, finish_maxiter=20,
    finish_gondzio=0, finish_mode="ipm", crossover_kset="mixed1", crossover_repair=2,
    crossover_refine=2, crossover_feas_tol=1e-9, finish_kkt_refine=0,
)
SCAN_KW = dict(chunk=8, compact_cap=6, compact_bucket=8, finish_cap=3, finish_bucket=8)
# 40 scenarios in chunks of 8, windows of 2 chunks: 3 windows, 5 chunk files
N_LPS, WINDOW_CHUNKS = 40, 2
ENTRIES = ("hsd_solve_scan", "hsd_solve_batched", "scenario_sweep")
NAMES = ENTRIES + ("narrow stage", "finish stage", "ipm phase", "segment", "graph capture",
                   "predicate read", "loop replay", "segment replay", "sweep pull",
                   "sweep write")
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _problem():
    lp = random_standard_lp(6, 6, nlp=N_LPS, seed=1, dtype=np.float32)
    eq = lp.to_equality_form()
    return tuple(np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))


def _solve(entry: str, out_dir, device=CPU) -> dict:
    """The entry on the problem: its objectives, statuses and iterations."""
    A, b, c = _problem()
    opts = port_pkg.SolverOptions(**OPTIONS)
    if entry == "hsd_solve_scan":
        out = hsd.hsd_solve_scan(A, b, c, opts, BATCHLAST_KERNELS, device=device, **SCAN_KW)
    elif entry == "hsd_solve_batched":
        out = hsd.hsd_solve_batched(A, b, c, opts, BATCHLAST_KERNELS, device=device)
    else:
        res = scenario_sweep(A, b, c, opts, out_dir=str(out_dir), kset=BATCHLAST_KERNELS,
                             window_chunks=WINDOW_CHUNKS, device=device, **SCAN_KW)
        out = {"objective": res.objective, "status": res.status, "iterations": res.iterations}
    return {k: np.asarray(torch.as_tensor(out[k]).cpu()) for k in ("objective", "status",
                                                                    "iterations")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each entry once under the profiler and once without: (answers
    profiled, answers unprofiled, ranges by name as (start, end) lists)."""
    out = {}
    for entry in ENTRIES:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            on = _solve(entry, tmp_path_factory.mktemp("on"))
        off = _solve(entry, tmp_path_factory.mktemp("off"))
        spans: dict = {}
        for e in prof.profiler.kineto_results.events():
            if e.name() in NAMES:
                spans.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
        out[entry] = (on, off, {k: sorted(v) for k, v in spans.items()})
    return out


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _within(spans: dict, name: str, outer) -> list:
    return [s for s in spans.get(name, []) if _inside(s, outer)]


@pytest.mark.parametrize("entry", ENTRIES)
def test_ranges_nest_under_the_entry(entry, runs):
    _, _, spans = runs[entry]
    (root,) = spans[entry]
    for name in ("ipm phase", "segment", "predicate read"):
        assert spans[name] and _within(spans, name, root) == spans[name]
    # the CPU runs every segment and loop eagerly
    assert not {"segment replay", "loop replay", "graph capture"} & set(spans)
    if entry == "hsd_solve_batched":
        assert "narrow stage" not in spans and "finish stage" not in spans
        assert "sweep pull" not in spans
        return
    scans = spans["hsd_solve_scan"]
    if entry == "scenario_sweep":
        windows = -(-N_LPS // SCAN_KW["chunk"] // WINDOW_CHUNKS)
        chunks = -(-N_LPS // SCAN_KW["chunk"])
        assert len(scans) == windows and _within(spans, "hsd_solve_scan", root) == scans
        assert len(_within(spans, "sweep pull", root)) == windows
        assert len(_within(spans, "sweep write", root)) == chunks
        # a window's pull and writes follow its solve, outside it
        for io in spans["sweep pull"] + spans["sweep write"]:
            assert not any(_inside(io, s) for s in scans)
    for scan in scans:
        (narrow,) = _within(spans, "narrow stage", scan)
        (finish,) = _within(spans, "finish stage", scan)
        assert narrow[1] <= finish[0]
        for stage in (narrow, finish):
            assert _within(spans, "ipm phase", stage) and _within(spans, "segment", stage)


@pytest.mark.parametrize("entry", ENTRIES)
def test_phases_and_segments_never_nest(entry, runs):
    _, _, spans = runs[entry]
    for phase in spans["ipm phase"]:
        for seg in spans["segment"]:
            assert phase[1] <= seg[0] or seg[1] <= phase[0], (phase, seg)


@pytest.mark.parametrize("entry", ENTRIES)
def test_answers_bitwise_with_the_profiler_on_and_off(entry, runs):
    on, off, _ = runs[entry]
    for k in on:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    assert (on["status"] == int(port_pkg.Status.OPTIMAL)).all()


@pytest.mark.parametrize("compile_s", [None, 0.0, 2.0])
def test_capture_seconds_leave_out_a_kernel_build(compile_s, monkeypatch):
    # a new graph's warm-up that finds (0.0 s) or builds (2.0 s) the kernel
    # library on its first launch adds its wall less the compile's seconds
    from pycllp_tpu_torch.ops import _build

    clock = iter([10.0, 12.5])
    monkeypatch.setattr(_loop, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    monkeypatch.setattr(_build, "_INFO", None)
    monkeypatch.setattr(_loop, "CAPTURE_SECONDS", 1.0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with _loop._new_graph():
            if compile_s is not None:
                _build._INFO = _build.BuildInfo(None, compile_s, compile_s == 0.0, "")
    assert _loop.CAPTURE_SECONDS == 1.0 + 2.5 - (compile_s or 0.0)
    assert [e.name() for e in prof.profiler.kineto_results.events()].count("graph capture") == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: graph captures happen only on the card")
    return torch.device("cuda", 0)


def test_capture_seconds_grow_with_captures_only(card):
    _loop._clear_graphs()
    before = (_loop.GRAPH_CAPTURES, _loop.CAPTURE_SECONDS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        first = _solve("hsd_solve_batched", None, card)
    captured = (_loop.GRAPH_CAPTURES, _loop.CAPTURE_SECONDS)
    assert captured[0] > before[0] and captured[1] > before[1]
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() == "graph capture"]
    assert len(ranges) == captured[0] - before[0]
    second = _solve("hsd_solve_batched", None, card)
    assert (_loop.GRAPH_CAPTURES, _loop.CAPTURE_SECONDS) == captured
    for k in first:
        np.testing.assert_array_equal(first[k], second[k], err_msg=k)
