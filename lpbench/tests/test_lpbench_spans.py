"""The readers of the program's own ranges on synthetic traces: a range's
device wall, the correlation ids that count, the division by entry calls,
nothing where the ranges are absent, and the capture counter."""

from __future__ import annotations

import pytest

from lpbench import harness, spans
from lpbench.harness import Run
from lpbench.trace import GRAPH_LAUNCH, Event, Trace


def read(name: str, run: Run):
    return harness.reader(name).read(run)


def _trace() -> Trace:
    # two entry calls (us).  Call 1 at 0..1000: the narrow stage 10..400
    # replays a graph at 20 (corr 1) whose kernels run to 450, after the
    # stage ends; a segment 50..90 inside it launches a kernel (corr 2)
    # that ends at 120; the finish stage 400..900 launches at 410 (corr 3,
    # ends 800).  Call 2 at 1000..2000: the narrow stage 1010..1300, its
    # launch (corr 4) done by 1200; the finish stage 1300..1900 holds a
    # launch (corr 5) whose work ends at 1950.  A launch outside every
    # range (corr 6, at 950) ends at 1990: it counts for none.  PyTorch's
    # operator ``aten::add`` inside the first narrow stage carries an id
    # (7) that a device op outside it also carries: not a runtime call.
    host = [Event("lpbench call", 0, 1000), Event("narrow stage", 10, 400),
            Event(GRAPH_LAUNCH, 20, 25, corr=1), Event("segment", 50, 90),
            Event("cudaLaunchKernel", 60, 62, corr=2), Event("aten::add", 70, 80, corr=7),
            Event("finish stage", 400, 900), Event("cudaMemcpyAsync", 410, 412, corr=3),
            Event("ipm phase", 420, 600), Event("cuLaunchKernel", 950, 951, corr=6),
            Event("lpbench call", 1000, 2000), Event("narrow stage", 1010, 1300),
            Event(GRAPH_LAUNCH, 1020, 1021, corr=4), Event("finish stage", 1300, 1900),
            Event("segment", 1310, 1320), Event(GRAPH_LAUNCH, 1310, 1311, corr=5),
            Event("ipm phase", 1500, 1700),
            Event("sweep pull", 1910, 1930), Event("sweep write", 1930, 1960),
            Event("sweep write", 1960, 1990)]
    kernels = [Event("k", 30, 300, corr=1), Event("k", 300, 450, corr=1),
               Event("k", 100, 120, corr=2), Event("k", 460, 470, corr=7),
               Event("k", 1030, 1200, corr=4), Event("k", 1320, 1950, corr=5),
               Event("k", 960, 1990, corr=6)]
    copies = [Event("Memcpy DtoH (Device -> Pinned)", 700, 800, corr=3)]
    return Trace(kernels=kernels, copies=copies, host=host, window_s=2000e-6, batches=2)


def test_a_device_wall_reaches_the_last_correlated_operation():
    tr = _trace()
    # the first narrow stage ends at 400, its graph's work at 450; the
    # second ends after its work
    assert spans.device_walls(tr, "narrow stage") == [(10, 450), (1010, 1300)]
    # the segment's kernel ends at 120; the second segment's at 1950
    assert spans.device_walls(tr, "segment") == [(50, 120), (1310, 1950)]


def test_operations_of_calls_outside_the_range_do_not_count():
    tr = _trace()
    # corr 6 started at 950, outside the finish stage (400..900): its work
    # to 1990 is not the stage's; corr 7 is an operator's id, not a call's
    assert spans.device_walls(tr, "finish stage") == [(400, 900), (1300, 1950)]
    assert spans.device_walls(tr, "ipm phase") == [(420, 600), (1500, 1700)]


def test_the_readers_divide_by_entry_calls():
    run = Run(trace=_trace())
    assert read("stage_ms.narrow", run) == pytest.approx((440 + 290) / 1e3 / 2)
    assert read("stage_ms.finish", run) == pytest.approx((500 + 650) / 1e3 / 2)
    assert read("phase_ms", run) == pytest.approx((180 + 200) / 1e3 / 2)
    assert read("segment_ms", run) == pytest.approx((70 + 640) / 1e3 / 2)
    # host time only: the pull and two writes, 80 us over 2 windows
    assert read("sweep_io_ms", run) == pytest.approx(80 / 1e3 / 2)


def test_overlapping_walls_of_one_name_count_once():
    # two segments whose walls overlap (the first's work runs on while the
    # second is dispatched): their union, not their sum
    host = [Event("segment", 0, 10), Event("cudaGraphLaunch", 2, 3, corr=1),
            Event("segment", 20, 30), Event("cudaGraphLaunch", 22, 23, corr=2)]
    kernels = [Event("k", 5, 50, corr=1), Event("k", 50, 60, corr=2)]
    run = Run(trace=Trace(kernels=kernels, host=host, window_s=1e-4, batches=1))
    assert read("segment_ms", run) == pytest.approx(60 / 1e3)


def test_a_range_left_open_by_the_profiler_is_left_out():
    # a sweep's trace stops inside its call: an unfinished range has no end
    host = [Event("segment", 0, 10), Event("segment", 50, -1)]
    run = Run(trace=Trace(host=host, window_s=1e-4, batches=1))
    assert read("segment_ms", run) == pytest.approx(10 / 1e3)


@pytest.mark.parametrize("name", ["stage_ms.narrow", "stage_ms.finish", "phase_ms",
                                  "segment_ms", "sweep_io_ms"])
def test_no_ranges_no_reading(name):
    assert read(name, Run()) is None
    # a trace of a program without the ranges: the harness's marks only
    tr = _trace()
    tr.host = [e for e in tr.host if e.name.startswith(("lpbench", "cu"))]
    assert read(name, Run(trace=tr)) is None


def test_capture_s_reads_the_programs_counter(monkeypatch):
    from pycllp_tpu_torch.solvers import _loop

    monkeypatch.setattr(_loop, "CAPTURE_SECONDS", 1.25)
    assert read("capture_s", Run()) == 1.25
    # a program without the counter: nothing to read
    monkeypatch.delattr(_loop, "CAPTURE_SECONDS")
    assert read("capture_s", Run()) is None
