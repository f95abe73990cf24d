"""Run one cell of the benchmark once and print its result.

    python3 lpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic, limits and metrics are found by
name from ``BENCHMARK.json`` (see ``lpbench/harness.py``).  The run needs
as many CUDA devices as the cell asks for, and exits with a non-zero code
and no result without them.  With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics; with ``--trace 1``, after the same window,
a traced stretch gives its per-layer metrics.  The last line of standard
output is the result, one JSON object; the numbers compared with their
limits are its last key and the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(f"[lpbench] {msg}", file=sys.stderr, flush=True)


def _metrics(run, entries: list, harness) -> dict:
    out = {}
    for m in entries:
        value = harness.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _breakdown(tr, tracing) -> dict:
    by_name: dict = {}
    for e in tr.kernels + tr.copies:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start) / 1e6
    idle: dict = {}
    host = tracing.HostIndex(tr.host, tr.in_call)
    for a, b in tracing.gaps(tr.device_ops):
        kind = host.activity(a)
        idle[kind] = idle.get(kind, 0.0) + (b - a) / 1e6
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def execute(cell, seed: int, seconds: float, trace: int, device: str, t_start: float) -> dict:
    """One run of ``cell`` on ``device``: the result's keys in order, the
    numbers compared (``checks``) last; None where a module that may not be
    loaded was loaded."""
    import torch

    from lpbench import harness, trace as tracing

    runner = harness.Runner(cell, seed, device)
    try:
        runner.setup(t_start)
        log(f"{cell.name} seed {seed}: set-up {runner.run.setup_s:.3f} s "
            f"({len(runner.staged)} batches warmed up)")
        runner.window(seconds)
        run = runner.run
        log(f"window {run.window_s:.3f} s, {len(run.calls)} calls, {run.lps} LPs; graphs "
            f"captured inside the window: {run.captures_in_window}")
        if trace:
            needs = set()
            for m in cell.per_layer:
                needs |= set(getattr(harness.reader(m["name"]), "NEEDS", ()))
            runner.traced(needs)
            log(f"traced stretch {run.trace.window_s:.3f} s, {run.trace.batches} batches, "
                f"{len(run.trace.kernels)} kernels, {len(run.trace.copies)} copies and fills")
        if harness.forbidden_modules():
            return None
        verdict = runner.compare()
        log(f"comparison: {verdict['values']}")
        metrics = _metrics(run, cell.per_layer if trace else cell.end_to_end, harness)
    finally:
        runner.close()
    on_card = runner.device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(runner.device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.peak_reserved}
    result = {"correct": verdict["correct"], "attempted": verdict["attempted"],
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tracing.union(run.trace.device_ops) / 1e6
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = _breakdown(run.trace, tracing)
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in verdict["checks"].items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from lpbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}: no result")
        return 2
    result = execute(cell, args.seed, args.seconds, args.trace, "cuda", T_START)
    found = harness.forbidden_modules()
    if result is None or found:
        log(f"modules that may not be loaded were loaded: {found}: no result")
        return 3
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
