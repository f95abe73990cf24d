"""The comparison fails what it has to fail.  Each cell is run here on the
CPU at a size a test can hold, past the harness's look for a card: sound,
it is correct; with the control (the configuration's own float32 path in
place of its float64 finish) and with each fault an LP solve can have
planted in the program underneath, ``correct`` comes out false.

The faults: an IPM step that returns the iterate unchanged; half of each
batch left out, its lanes given the answers of the rest; every answer's
objective altered where the solve returns it.  The cells run on one card,
so there is no exchange between cards to leave out.
"""

from __future__ import annotations

import time

import pytest
import torch

from lpbench import harness
from pycllp_tpu_torch.solvers import hsd
from pycllp_tpu_torch.utils import sweep

CELLS = ["dense64-scan", "dense64-sweep", "netlib3-buckets", "netlib3-padded"]
SOLVES = [(hsd, "hsd_solve_scan"), (hsd, "hsd_solve_batched"), (sweep, "hsd_solve_scan"),
          (sweep, "hsd_solve_batched")]


def _verdict(cell, seed: int = 2**31 + 99, **runner_kw) -> dict:
    runner = harness.Runner(cell, seed, "cpu", **runner_kw)
    try:
        runner.setup(time.perf_counter())
        runner.window(0.05)
        return runner.compare()
    finally:
        runner.close()


def _half(solve):
    """The solve of the first half of the lanes; the other half get the
    first half's answers."""
    def solve_half(A, b, c, *args, **kw):
        n = b.shape[0]
        h = max(1, n // 2)
        A_h = A[:h] if getattr(A, "ndim", 2) == 3 else A
        out = solve(A_h, b[:h], c[:h], *args, **kw)
        return {k: torch.cat([v, v[:n - h]]) if isinstance(v, torch.Tensor) and v.shape[:1] == (h,)
                else v for k, v in out.items()}
    return solve_half


def _altered(solve):
    def solve_altered(*args, **kw):
        out = solve(*args, **kw)
        out["objective"] = out["objective"] * (1 + 1e-3)
        return out
    return solve_altered


def _unchanged_step(*args, **kw):
    """An IPM Newton step that returns the iterate it was given (the loop's
    own bookkeeping, its counter and the statuses, goes on)."""
    def step(x, y, z, tau, kappa, *residuals):
        return x, y, z, tau, kappa
    return step


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny):
    v = _verdict(tiny(name))
    assert v["correct"], v
    assert v["values"]["answers_checked"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tiny):
    cell = tiny(name)
    v = _verdict(cell, options=cell.config["control_options"])
    assert not v["correct"], v


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch, tiny):
    if fault == "state_unchanged":
        monkeypatch.setattr(hsd, "_make_step_fn", _unchanged_step)
    else:
        wrap = _half if fault == "half_batch" else _altered
        for mod, attr in SOLVES:
            monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    v = _verdict(tiny(name))
    assert not v["correct"], v
