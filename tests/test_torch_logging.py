"""Port parity: per-iteration metrics (``log_every``, ``utils/logging.py``).

The port's records against the JAX package's on the same f64 solve, each
collected through its own ``set_metrics_sink(list.append)``: phase,
iteration and active count equal, the maxima and the mean μ to 1e-8.
"""

import json

import jax
import numpy as np
import pytest

import pycllp_tpu as ref_pkg
import pycllp_tpu.utils.logging as ref_logging
from pycllp_tpu.io.generate import random_equality_lp
from pycllp_tpu.solvers import hsd as ref_hsd
from pycllp_tpu_torch import SolverOptions
from pycllp_tpu_torch.solvers import hsd as port_hsd
from pycllp_tpu_torch.utils import logging as port_logging

EXACT = ("event", "phase", "iter", "active")
CLOSE = ("rho_p_max", "rho_d_max", "rho_gap_max", "mu_mean")


@pytest.fixture
def sinks():
    """Route both packages' records into lists; restore the sinks after."""
    ref_records, port_records = [], []
    ref_old, port_old = ref_logging._sink, port_logging._sink
    ref_logging.set_metrics_sink(ref_records.append)
    port_logging.set_metrics_sink(port_records.append)
    yield ref_records, port_records
    ref_logging._sink, port_logging._sink = ref_old, port_old


def _records_agree(port_records, ref_records):
    assert len(port_records) == len(ref_records) > 0
    for p, r in zip(port_records, ref_records):
        assert {k: p[k] for k in EXACT} == {k: r[k] for k in EXACT}
        np.testing.assert_allclose([p[k] for k in CLOSE], [r[k] for k in CLOSE],
                                   rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("log_every", [1, 3])
def test_records_match_jax_f64(sinks, log_every):
    ref_records, port_records = sinks
    A, b, c = random_equality_lp(8, 20, nlp=6, seed=12)
    kw = dict(tol=1e-8, init_point="mehrotra", kkt_refine=1, log_every=log_every)
    ref_out = ref_hsd.hsd_solve_batched(A, b, c, ref_pkg.SolverOptions(**kw))
    jax.effects_barrier()
    out = port_hsd.hsd_solve_batched(A, b, c, SolverOptions(**kw), device="cpu")
    np.testing.assert_array_equal(out["iterations"].numpy(), np.asarray(ref_out["iterations"]))
    _records_agree(port_records, ref_records)
    assert [r["iter"] for r in port_records] == list(range(0, len(port_records) * log_every,
                                                          log_every))
    assert port_records[0]["active"] == 6 and port_records[0]["phase"] == "float64"
    # the residuals fall over the solve
    assert port_records[-1]["rho_p_max"] < port_records[0]["rho_p_max"]


def test_finish_phase_records_match_jax(sinks):
    """A narrow f32 phase (bench.py's stall options), then the wide f64 IPM
    finish: each phase names its dtype, in both packages."""
    ref_records, port_records = sinks
    A, b, c = random_equality_lp(8, 20, nlp=6, seed=13)
    kw = dict(tol=1e-8, dtype="float32", finish_dtype="float64", switch_tol=1e-4,
              init_point="mehrotra", finish_kset="reference", log_every=1,
              stall_patience=3, stall_rtol=0.05, kkt_refine=3, kkt_refine_pred=0)
    ref_hsd.hsd_solve_batched(A, b, c, ref_pkg.SolverOptions(**kw))
    jax.effects_barrier()
    port_hsd.hsd_solve_batched(A, b, c, SolverOptions(**kw), device="cpu")
    key = [(r["phase"], r["iter"], r["active"]) for r in port_records]
    assert key == [(r["phase"], r["iter"], r["active"]) for r in ref_records]
    assert key[0][0] == "float32" and key[-1][0] == "float64"
    # the narrow phase runs in f32, where the two packages round apart:
    # the values agree to f32 accuracy, in both phases
    for p, r in zip(port_records, ref_records):
        np.testing.assert_allclose([p[k] for k in CLOSE], [r[k] for k in CLOSE], rtol=1e-3, atol=1e-6)


def test_log_every_zero_emits_nothing(sinks):
    _, port_records = sinks
    A, b, c = random_equality_lp(6, 15, nlp=3, seed=1)
    port_hsd.hsd_solve_batched(A, b, c, SolverOptions(tol=1e-8), device="cpu")
    assert port_records == []


def test_scan_emits_one_record_per_host_iteration(sinks, monkeypatch):
    """Through the chunked scan (cap and compaction on), one record per
    host-loop iteration, each chunk's loop starting at k = 0."""
    _, port_records = sinks
    monkeypatch.setattr(port_hsd, "HOST_STEPS", 0)
    A, b, c = random_equality_lp(6, 15, nlp=40, seed=2)
    port_hsd.hsd_solve_scan(A, b, c, SolverOptions(tol=1e-8, log_every=1), device="cpu",
                            chunk=16, compact_cap=4, compact_bucket=8)
    assert len(port_records) == port_hsd.HOST_STEPS > 0
    starts = [i for i, r in enumerate(port_records) if r["iter"] == 0]
    assert len(starts) == 3 and port_records[0]["active"] == 16


def test_sink_kinds(tmp_path, capsys):
    old = port_logging._sink
    try:
        got = []
        port_logging.set_metrics_sink(got.append)
        port_logging.emit({"a": 1})
        assert got == [{"a": 1}]
        path = str(tmp_path / "m.jsonl")
        port_logging.set_metrics_sink(path)
        port_logging.iteration_record("float64", np.int32(2), np.int64(5), 1.0, 2.0, 3.0, 0.5)
        port_logging.emit({"b": 2})
        with open(path) as f:
            lines = [json.loads(ln) for ln in f]
        assert lines == [
            {"event": "ipm_iteration", "phase": "float64", "iter": 2, "active": 5,
             "rho_p_max": 1.0, "rho_d_max": 2.0, "rho_gap_max": 3.0, "mu_mean": 0.5},
            {"b": 2},
        ]
        port_logging.set_metrics_sink(None)
        port_logging.emit({"c": 3})
        assert json.loads(capsys.readouterr().err) == {"c": 3}
    finally:
        port_logging._sink = old


def test_metrics_to_jsonl_restores_the_old_sink(tmp_path):
    old = port_logging._sink
    try:
        got = []
        port_logging.set_metrics_sink(got.append)
        path = str(tmp_path / "x.jsonl")
        with port_logging.metrics_to_jsonl(path) as p:
            assert p == path
            port_logging.emit({"inside": True})
        port_logging.emit({"after": True})
        assert got == [{"after": True}]
        with open(path) as f:
            assert [json.loads(ln) for ln in f] == [{"inside": True}]
        port_logging.set_metrics_sink(None)
        with port_logging.metrics_to_jsonl(path):
            pass
        assert port_logging._sink is None
    finally:
        port_logging._sink = old
