"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the metrics.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json`` names a configuration (``lpbench/configs/<config>.json``
through the entry's ``file``) and a traffic mix
(``lpbench/traffic/<traffic>.json``); its limits are in
``lpbench/limits/<cell>.json``; each metric is read by
``lpbench/metrics/<metric>.py``.  Adding a cell or a metric adds files and
entries and edits nothing here.

The window is a closed loop: one caller, the next call of the entry as soon
as the last one returned its answers to the host.  It runs whole calls
until ``seconds`` have passed; its wall runs from the first call's start to
the last call's end.
"""

from __future__ import annotations

import contextlib
import importlib.util
import inspect
import io
import json
import re
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from lpbench import program, trace as tracing
from lpbench.inputs import traffic as traffic_mod
from lpbench.reference import ipm

__all__ = ["HERE", "ROOT", "Cell", "Run", "load_cell", "reader", "Runner", "FORBIDDEN",
           "forbidden_modules"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in a run, compared by their top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pycllp_tpu")
# calls of the entry with ``stage_sync=True`` in a traced run whose metrics
# need the stage split
STAGE_SYNC_CALLS = 3
_STAGE_LINE = re.compile(r"\[scan\] (\w+) stage: ([0-9.]+)s")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _applies(metric: dict, cell: str, e2e_names: set, per_layer: bool) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names if per_layer else True


def load_cell(name: str, root: Path = ROOT, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``spec``)."""
    spec = spec or json.loads((root / "BENCHMARK.json").read_text())
    (work,) = [w for w in spec["workloads"] if w["name"] == name]
    (conf,) = [c for c in spec["configs"] if c["name"] == work["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{work['traffic']}.json").read_text())
    limits_path = HERE / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set(), False)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, names, True)]
    return Cell(name, int(work["chips"]), config, traffic, limits, e2e, per_layer)


def reader(name: str):
    """The module ``lpbench/metrics/<name>.py``: ``read(run)`` gives the
    metric in its unit, or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "lpbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Call:
    """One call of the entry: which batch, its wall, the LPs it solved,
    the program's counters' change over it, and the entry calls it made
    (one, or a sweep's windows)."""
    batch: int
    wall: float
    lps: int
    counters: dict
    batches: int
    answers: dict | None = None  # objective, status, iterations on the host
    out_dir: str | None = None  # a sweep's checkpoint directory


@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = field(default_factory=list)  # the window's calls
    extra: list = field(default_factory=list)  # traced and stage-split calls
    peak_reserved: int = 0
    trace: tracing.Trace | None = None
    stage_s: dict = field(default_factory=dict)  # stage name -> seconds of each call
    captures_in_window: int = 0

    @property
    def lps(self) -> int:
        return sum(c.lps for c in self.calls)


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


class Runner:
    """A run of ``cell`` from ``seed`` on ``device``.  ``options`` replaces
    the configuration's solver options (the control)."""

    def __init__(self, cell: Cell, seed: int, device: str = "cuda", options: dict | None = None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        cfg, tr = cell.config, cell.traffic
        self.entry = program.resolve(tr.get("entry", cfg["entry"]))
        # a traffic that names its own entry (a sweep around the configuration's)
        # gives that entry's arguments whole
        self.kwargs = dict(tr["entry_kwargs"] if "entry" in tr else cfg.get("entry_kwargs", {}))
        self.opts = program.options(options if options is not None else cfg["options"])
        self.kset = program.resolve(cfg["kset"])
        self.sweep = tr.get("driver", "calls") == "sweep"
        self.run = Run()
        self.work = None
        self.staged: list = []
        self._dirs: list = []

    # ------------------------------------------------------------------ set-up
    def setup(self, t_start: float, warm: bool = True) -> None:
        """Make the inputs, stage them on the device, call each batch once
        (the warm-up: kernel build, graph captures; ``warm=False`` skips it
        where an earlier run in the process made them), and record set-up."""
        self.work = traffic_mod.make(self.cell.config, self.cell.traffic, self.seed)
        for bt in self.work.batches:
            A = bt.A if bt.A.ndim == 2 else torch.from_numpy(bt.A).to(self.device)
            self.staged.append((A, torch.from_numpy(bt.b).to(self.device),
                                torch.from_numpy(bt.c).to(self.device)))
        for i in range(len(self.staged) if warm else 0):
            self._discard(self._call(i))
        self._sync()
        self.run.setup_s = time.perf_counter() - t_start

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ calls
    def _call(self, i: int, progress=None, **extra) -> Call:
        A, b, c = self.staged[i]
        before = program.counters()
        out_dir = None
        windows = [0]
        t0 = time.perf_counter()
        with torch.profiler.record_function("lpbench call"):
            if self.sweep:
                out_dir = tempfile.mkdtemp(prefix="lpbench-sweep-")
                self._dirs.append(out_dir)

                def count(done, total):
                    windows[0] += 1
                    if progress is not None:
                        progress(done, total)

                self.entry(A, b, c, self.opts, kset=self.kset, out_dir=out_dir, progress=count,
                           device=self.device, **self.kwargs, **extra)
                answers = None
            else:
                out = self.entry(A, b, c, self.opts, kset=self.kset, device=self.device,
                                 **self.kwargs, **extra)
                with torch.profiler.record_function("lpbench pull"):
                    answers = {k: out[k].cpu().numpy()
                               for k in ("objective", "status", "iterations")}
        wall = time.perf_counter() - t0
        return Call(i, wall, int(b.shape[0]), _delta(before, program.counters()),
                    windows[0] if self.sweep else 1, answers, out_dir)

    def _discard(self, call: Call) -> None:
        if call.out_dir:
            shutil.rmtree(call.out_dir, ignore_errors=True)
            self._dirs.remove(call.out_dir)

    def window(self, seconds: float) -> None:
        """Whole calls, the batches in turn, until ``seconds`` have passed."""
        before = program.counters()["captures"]
        t0 = time.perf_counter()
        i = 0
        while True:
            self.run.calls.append(self._call(i % len(self.staged)))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.run.window_s = time.perf_counter() - t0
        walls = sorted(c.wall for c in self.run.calls)
        print(f"[lpbench] call walls (s): min {walls[0]:.4f}, median {walls[len(walls) // 2]:.4f}, "
              f"max {walls[-1]:.4f}; in order {[round(c.wall, 3) for c in self.run.calls[:12]]}",
              file=sys.stderr, flush=True)
        self.run.captures_in_window = program.counters()["captures"] - before
        if self.device.type == "cuda":
            self.run.peak_reserved = int(torch.cuda.max_memory_reserved(self.device))

    def traced(self, needs: set) -> None:
        """The traced stretch under ``torch.profiler``: ``trace_calls``
        calls (of a sweep: its first ``trace_windows`` windows), then the
        stage-split calls where a metric needs them."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        tr = self.cell.traffic
        self._sync()
        if self.sweep:
            n = int(tr.get("trace_windows", 2))
            state = {"end": None}

            def stop(done, total):
                if state["end"] is None and done >= n * self.kwargs.get("window_chunks", 1):
                    self._sync()
                    state["end"] = time.perf_counter()
                    prof.stop()

            prof.start()
            t0 = time.perf_counter()
            call = self._call(0, progress=stop)
            if state["end"] is None:  # a sweep of fewer windows
                self._sync()
                state["end"] = time.perf_counter()
                prof.stop()
            batches = min(n, call.batches)
            calls = [call]
        else:
            n = int(tr.get("trace_calls", len(self.staged)))
            prof.start()
            t0 = time.perf_counter()
            calls = [self._call(i % len(self.staged)) for i in range(n)]
            self._sync()
            state = {"end": time.perf_counter()}
            prof.stop()
            batches = n
        self.run.extra += calls
        self.run.trace = tracing.from_profiler(prof, state["end"] - t0, batches, self.sweep)
        if "stage_sync" in needs and "stage_sync" in inspect.signature(self.entry).parameters:
            for i in range(STAGE_SYNC_CALLS):
                err = io.StringIO()
                with contextlib.redirect_stderr(err):
                    call = self._call(i % len(self.staged), stage_sync=True)
                self.run.extra.append(call)
                for stage, secs in _STAGE_LINE.findall(err.getvalue()):
                    self.run.stage_s.setdefault(stage, []).append(float(secs))

    # ------------------------------------------------------------------ answers
    def _answers(self, call: Call) -> tuple:
        """(objective, status) of every LP of the call's batch, in batch
        order, and the count of LPs with no answer.  A sweep's answers are
        read back from its checkpoint files."""
        n = self.work.batches[call.batch].size
        if call.out_dir is None:
            obj = np.asarray(call.answers["objective"], np.float64).reshape(-1)
            st = np.asarray(call.answers["status"]).reshape(-1)
            if obj.shape != (n,) or st.shape != (n,):
                return np.full(n, np.nan), np.full(n, -1), n
            return obj, st, 0
        obj, st = np.full(n, np.nan), np.full(n, -1)
        chunk = int(self.kwargs["chunk"])
        missing = 0
        it = np.zeros(n, np.int64)
        for k in range(-(-n // chunk)):
            lo, hi = k * chunk, min((k + 1) * chunk, n)
            path = Path(call.out_dir) / f"chunk_{k:06d}.npz"
            if not path.exists():
                missing += hi - lo
                continue
            with np.load(path) as data:
                obj[lo:hi], st[lo:hi], it[lo:hi] = (data["objective"], data["status"],
                                                    data["iterations"])
        call.answers = {"objective": obj, "status": st, "iterations": it}
        return obj, st, missing

    def compare(self) -> dict:
        """The comparison that decides ``correct``: the reference on a
        sample, drawn from the seed, of the distinct LPs the calls answered,
        against every answer the program gave for them; the statuses of
        every answer."""
        opt = program.optimal()
        calls = self.run.calls + self.run.extra
        sizes = [g.b.shape[0] for g in self.work.groups]
        offsets = np.concatenate([[0], np.cumsum(sizes)])

        def lp_ids(call):  # the call's lanes as LP ids, in batch order
            return np.concatenate([np.arange(offsets[g] + lo, offsets[g] + lo + cnt)
                                   for g, lo, cnt in self.work.batches[call.batch].lanes])

        # the sample: distinct LPs that some call answered, drawn from the seed
        covered = np.unique(np.concatenate([lp_ids(c) for c in calls]))
        n_check = min(int(self.cell.traffic.get("check_lps", 512)), len(covered))
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0x1B]))
        pick = np.sort(rng.choice(covered, size=n_check, replace=False))
        ref = np.full(int(offsets[-1]), np.nan)
        unconverged = 0
        for g, grp in enumerate(self.work.groups):
            lanes = pick[(pick >= offsets[g]) & (pick < offsets[g + 1])] - offsets[g]
            if len(lanes):
                r = ipm.solve(grp.A, grp.b[lanes], grp.c[lanes])
                ref[offsets[g] + lanes] = np.where(r["converged"], r["objective"], np.nan)
                unconverged += int((~r["converged"]).sum())
        answers = not_opt = unanswered = 0
        errs = []
        for call in calls:
            obj, st, missing = self._answers(call)
            unanswered += missing
            answers += len(st)
            not_opt += int((st != opt).sum()) - missing
            ids = lp_ids(call)
            # a sampled LP the reference could not solve is counted apart
            mask = np.isin(ids, pick) & (st == opt) & np.isfinite(ref[ids])
            e = np.abs(obj[mask] - ref[ids[mask]]) / np.maximum(1.0, np.abs(ref[ids[mask]]))
            errs.append(np.where(np.isnan(e), np.inf, e))
        errs = np.concatenate(errs) if errs else np.zeros(0)
        finite = len(errs) > 0 and bool(np.isfinite(errs).all())
        values = {"obj_rel_err_p90": float(np.quantile(errs, 0.9)) if finite else None,
                  "obj_rel_err_max": float(errs.max()) if finite else None,
                  "not_optimal_share": not_opt / max(1, answers),
                  "unanswered": unanswered, "ref_unconverged": unconverged}
        # the numbers compared are those the cell's limits file names
        checks = {}
        for name, lim in self.cell.limits.items():
            value, limit = values.get(name), lim.get("limit")
            ok = value is not None and limit is not None and value <= limit
            checks[name] = {"value": value, "limit": limit, "ok": ok}
        quant = ([float(q) for q in np.quantile(errs, [0.5, 0.9, 0.99, 1.0])] if finite else None)
        return {"correct": bool(checks) and all(c["ok"] for c in checks.values()),
                "attempted": answers, "failed": not_opt + unanswered, "checks": checks,
                "values": {**values, "err_q50_q90_q99_max": quant, "answers_checked": len(errs)}}

    def close(self) -> None:
        for d in list(self._dirs):
            shutil.rmtree(d, ignore_errors=True)
        self._dirs.clear()
        self.staged.clear()
