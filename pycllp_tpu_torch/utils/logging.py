"""Structured solver metrics.

Counterpart of :mod:`pycllp_tpu.utils.logging`, function for function.
With ``SolverOptions.log_every = k`` the IPM loop emits, every k-th
iteration, one *reduced* record over the active lanes (active-lane count,
max residual indicators, mean μ) — structured (jsonl-able) for a
benchmark harness, off by default (``log_every=0``).  The reference
emits from inside its jitted loop through ``jax.debug.callback``; here
the host loop reads the reductions back only when a record is due.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Callable

__all__ = ["set_metrics_sink", "emit", "metrics_to_jsonl", "iteration_record"]

_lock = threading.Lock()
_sink: Callable[[dict], None] | None = None


def set_metrics_sink(sink: Callable[[dict], None] | str | None) -> None:
    """Install a metrics sink: a callable, a jsonl path, or None (off →
    records print to stderr)."""
    global _sink
    if isinstance(sink, str):
        path = sink

        def _write(rec: dict) -> None:
            with _lock, open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")

        _sink = _write
    else:
        _sink = sink


def metrics_to_jsonl(path: str):
    """Context manager: route metrics to a jsonl file within the block."""

    class _Ctx:
        def __enter__(self):
            self._old = _sink
            set_metrics_sink(path)
            return path

        def __exit__(self, *exc):
            global _sink
            _sink = self._old

    return _Ctx()


def emit(record: dict) -> None:
    if _sink is not None:
        _sink(record)
    else:
        print(json.dumps(record), file=sys.stderr)


def iteration_record(phase, k, active, rho_p, rho_d, rho_gap, mu):
    """Record of one IPM iteration (values reduced over the active lanes
    on the device; each is read back here)."""
    emit(
        {
            "event": "ipm_iteration",
            "phase": str(phase),
            "iter": int(k),
            "active": int(active),
            "rho_p_max": float(rho_p),
            "rho_d_max": float(rho_d),
            "rho_gap_max": float(rho_gap),
            "mu_mean": float(mu),
        }
    )
