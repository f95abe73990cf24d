"""The run's outward behaviour: no card, no result; the result line's keys;
nothing of JAX or the JAX package loaded; a checkout without the program
gives no result."""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import time

import pytest

from lpbench import harness

RUN = harness.HERE / "run.py"
def _run_module():
    spec = importlib.util.spec_from_file_location("lpbench_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_no_card_no_result(card_absent):
    proc = subprocess.run([sys.executable, str(RUN), "--workload", "dense64-scan", "--seed",
                           "4294967311", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=harness.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_checkout_without_the_program_gives_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "lpbench/run.py", "--workload", "netlib3-buckets",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    # past the look for a card, the program itself is missing
    code = ("import sys, time; sys.path.insert(0, 'lpbench'); sys.argv = ['run.py']; "
            "import run; from lpbench import harness; "
            "c = harness.load_cell('netlib3-buckets'); "
            "run.execute(c, 1, 0.1, 0, 'cpu', time.perf_counter())")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path)
    assert proc.returncode != 0 and "pycllp_tpu_torch" in proc.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(trace, tiny):
    cell = tiny("netlib3-buckets")
    result = _run_module().execute(cell, 2**31 + 5, 0.1, trace, "cpu", time.perf_counter())
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    json.dumps(result)
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= wanted
    assert ("setup_s" in result["metrics"]) == (not trace)
    assert set(result["checks"]) == set(cell.limits)
    assert all(set(v) == {"value", "limit"} for v in result["checks"].values())
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_jax_loaded_by_a_run():
    code = ("import sys, time; sys.path.insert(0, %r); sys.argv = ['run.py']; import run; "
            "from lpbench import harness; c = harness.load_cell('dense64-scan'); "
            "c.traffic = {**c.traffic, 'lps_per_group': 8, 'check_lps': 4}; "
            "assert run.execute(c, 3, 0.1, 0, 'cpu', time.perf_counter())['correct']; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(harness.HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, check=True).stdout.strip().splitlines()[-1]
    tops = set(eval(out))
    assert "pycllp_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "pycllp_tpu")
