"""The metric readers on synthetic runs: counters' changes, call walls and
a made-up device trace."""

from __future__ import annotations

import numpy as np
import pytest

from lpbench import harness, trace as tracing
from lpbench.harness import Call, Run
from lpbench.trace import Event, Trace


def read(name: str, run: Run):
    return harness.reader(name).read(run)


def _counters(**kw) -> dict:
    base = dict.fromkeys(("host_syncs", "stage_reads", "gated_off", "captures", "steps"), 0)
    return {**base, **kw}


def _run() -> Run:
    calls = [Call(0, 0.5, 100, _counters(host_syncs=10, stage_reads=2, gated_off=3, steps=27), 1,
                  {"iterations": np.full(100, 9)}),
             Call(1, 0.3, 100, _counters(host_syncs=6, stage_reads=0, gated_off=1, steps=9), 1,
                  {"iterations": np.full(100, 12)}),
             Call(0, 0.7, 100, _counters(host_syncs=10, stage_reads=2, gated_off=3, steps=27), 1,
                  {"iterations": np.full(100, 9)})]
    return Run(setup_s=12.5, window_s=2.0, calls=calls, peak_reserved=3 * 2**30,
               stage_s={"narrow": [0.25, 0.27], "finish": [0.2, 0.3]})


def test_end_to_end_readers():
    run = _run()
    assert read("lp_per_s", run) == 150.0
    assert read("setup_s", run) == 12.5
    assert read("peak_mem_gib", run) == 3.0
    assert read("batch_s.p95", run) == pytest.approx(np.percentile([0.5, 0.3, 0.7], 95))


def test_counter_readers():
    run = _run()
    assert read("host_reads_per_batch", run) == pytest.approx(30 / 3)
    assert read("gated_off_share", run) == pytest.approx(100 * 7 / (7 + 63))
    assert read("iterations_per_lp", run) == pytest.approx(10.0)
    assert read("stage_s.narrow", run) == pytest.approx(0.26)
    assert read("stage_s.finish", run) == pytest.approx(0.25)


def _trace() -> Trace:
    # two batches: a graph launch at 0 us whose first kernel starts at 40 us
    # (the device idle since 0), eager kernels, a copy, a predicate read
    host = [Event("lpbench call", 0, 500), Event(tracing.GRAPH_LAUNCH, 0, 5, corr=7),
            Event("loop replay", 0, 6), Event("predicate read", 300, 320),
            Event("lpbench call", 600, 900), Event(tracing.GRAPH_LAUNCH, 610, 615, corr=9),
            Event("lpbench pull", 880, 900)]
    kernels = [Event("void chol_bl_smem_kernel<float, 8>(float*)", 40, 140, corr=7),
               Event("void at::native::vectorized_elementwise_kernel<4>()", 140, 200, corr=7),
               Event("nvjet_tst_128x64_64x4_1x2_h_bz_NNT", 200, 260, corr=7),
               Event("ozaki_product_kernel", 700, 800, corr=9)]
    copies = [Event("Memcpy DtoH (Device -> Pinned)", 880, 890)]
    return Trace(kernels=kernels, copies=copies, host=host, window_s=1000e-6, batches=2)


def test_trace_readers():
    run = Run(trace=_trace())
    # the program's kernels: chol (100 us) and ozaki (100 us), over 2 batches
    assert read("kernel_ms.port", run) == pytest.approx(200 / 1e3 / 2)
    assert read("kernel_ms.torch", run) == pytest.approx(120 / 1e3 / 2)
    # busy 40..260, 700..800, 880..890 = 330 us of 1000
    assert read("device_idle_share", run) == pytest.approx(100 * (1 - 330 / 1000))
    # launch 7: idle 0..40; launch 9 at 610, device idle since 260: 610..700
    assert read("launch_gap_ms", run) == pytest.approx((40 + 90) / 1e3 / 2)


def test_idle_gaps_by_host_activity():
    tr = _trace()
    host = tracing.HostIndex(tr.host)
    kinds = {(a, b): host.activity(a) for a, b in tracing.gaps(tr.device_ops)}
    assert kinds == {(260, 700): "dispatch", (800, 880): "dispatch"}
    assert host.activity(310) == "predicate read"
    assert host.activity(3) == "loop replay"
    assert host.activity(890) == "pull"
    assert host.activity(550) == "harness"
    assert tracing.HostIndex(tr.host, in_call=True).activity(550) == "dispatch"


@pytest.mark.parametrize("name", ["kernel_ms.port", "kernel_ms.torch", "device_idle_share",
                                  "launch_gap_ms", "stage_s.narrow", "stage_s.finish",
                                  "peak_mem_gib"])
def test_nothing_to_read_gives_nothing(name):
    assert read(name, Run()) is None
