"""On-card smoke run of the PyTorch/CUDA port (``pycllp_tpu_torch``).

Builds the hand-written CUDA kernels from the sources in this checkout
(``csrc/batchlast.cu``, ``csrc/df64.cu``, which includes
``csrc/ozaki.cuh``, and ``csrc/lanemv.cu``), holds each against its plain
PyTorch version on the card, and drives the port's paths:

1. device and build;
2. kernel parity and times: ``chol_bl``/``solve_bl`` (f32), the FP64
   ``df_chol_bl``/``df_solve_bl`` and the fused ``fused_factor_bl``/
   ``facsol_bl`` (f32, also against the split path they replace) on both
   designs (the lane-group kernels of ``csrc/batchlast_smem.cuh``, the
   default, and the streaming kernels of ``csrc/batchlast.cuh`` and
   ``csrc/batchlast.cu``), timed in turns against each other and the
   plain version, with a sweep over the lane-group size, each kernel's
   bound and the one PyTorch call that computes its function
   (``library_ms``); the Ozaki ``slice_rounds_bl``, plus the df64 and
   Ozaki accuracy contracts of ``tests_tpu/smoke.py``; the fused Ozaki
   product ``ozaki_product_bl`` (``phase_ozaki_kernels``) at every shape
   the paths give it (the main cell's matvecs and formation, netlib's),
   with zero, power-of-two and NaN lanes, BITWISE against the split route
   it replaced and its plain version, timed against the split route and
   one f64 ``torch.matmul``; the lane matvec for per-instance A
   (``phase_lanemv_kernels``: A·x, Aᵀ·y and the normal product, f32 and
   f64) against its plain version (the einsum route) at the padded netlib
   shape and a ragged one, timed at the padded shape beside its bound;
3. the narrow main path — 65,536 dense 64×64 LPs through
   ``get_solver("hsd_pallas", device="cuda")`` at the ``BENCH_FINISH=0``
   options, its ITERATION_LIMIT count bounded around the JAX reference's;
   then the same cell with the f32 solve forced to the streaming
   (left-looking) design and on the two fused sets, their status mixes
   side by side;
4. two 256-lane probes with a wide finish (a df64 IPM finish, and a
   mixed-engine crossover finish), each audited against scipy, and a third
   on the fast formation (``finish_kset="df64_fastform"``, the reference's
   recorded negative result: its status mix reported, not bounded), with
   that set's factor held against the plain factor;
5. the full main path — ``bench.py``'s default configuration: the same
   65,536 LPs through ``hsd_solve_scan`` with the wide f64 crossover
   finish and its drain tiers — audited to the 1e-6 contract on 2,048
   lanes and every non-OPTIMAL one (the wide audit), then three more
   solves under ``torch.profiler`` (device time by kernel, launches and
   the busy share of each stage, GEMMs by shape, the profiler's kernel
   counts held to the launch counters): on the kernel route with the IPM
   loops as replayed graphs and as the per-iteration host loop, and with
   every Ozaki product on the split route, each bitwise equal in statuses
   and objectives to the main path; then the device-resident loop and the
   stage graphs (``device_loop``): three routes (the scan stages'
   straight-line segments and the IPM loops' blocks as replayed graphs;
   the loops' graphs with eager segments; the per-iteration host loop),
   bitwise, on the main cell, the fused sets and netlib's padded batch, in
   turns, with each stage's span split by what kept the card busy or idle
   (``stage_split``), and the block lengths 3 and 4; then the Ozaki widths set for a solve
   (``ozaki_widths``): the default widths given explicitly change no bit of
   the df64 probe or the main cell, the df64 probe at 56 bits runs to its
   end (its status mix and worst rho_p beside the 66-bit run's),
   ``ozaki_product_bl`` is held bitwise at 6, 8, 14 and 17 levels, and a
   width over the kernel's 24-level cap is refused before anything launches;
6. the same configuration on the fused-form set
   (``BATCHLAST_FUSED_KERNELS``) and on the ``fuse_facsol`` set, each
   audited and with its kernel's launches tied to the narrow iterations;
7. BASELINE.md config 5 as written: the checkpointed scenario sweep
   (``scenario_sweep``, ``bench.py``'s ``run_sweep`` with
   ``BENCH_TOTAL=1000000``) over 1,000,000 scenarios on the fused-form
   set, run in a child process killed with SIGKILL after 8 windows, left
   with half a window and a stale temporary file on disk, resumed here,
   and compared with an uninterrupted sweep, which captures no graph after
   its first window, and whose first window is solved again on the three
   routes (bitwise equal); the wide audit,
   and the
   off-grid audit (every non-OPTIMAL lane and a seeded random sample of
   60,000 lanes off the grid), to the 1e-6 contract but for the lanes
   named in CONFIG5_OVER_CONTRACT;
8. per-iteration metrics (``log_every=1``) of a 4,096-lane solve through
   ``metrics_to_jsonl``;
9. every kernel against its plain version at the netlib shapes (m = 27,
   50, 56; B = 1, 300, 8,192; a per-instance M), timed at m = 56, B = 8,192;
10. config 4 (``bench.py``'s ``run_netlib``) at 8,192 replicas per fixture:
    one shared-A solve per bucket, then the padded heterogeneous batch
    (24,576 per-instance 56×153 lanes), audited and compared lane by lane;
11. config 2 (batch32) at 65,536 lanes on the main path;
12. config 1 through ``hsd_pallas``, every registry backend on its batch,
    and ``dense_path`` in f32 on the batch-last kernels vs the reference set;
13. ``hsd_solve_two_pass``: the per-instance ladder (4,096 lanes) and the
    shared-A delegation (bitwise equal to ``hsd_solve_scan``);
14. the CLI as a subprocess (``python -m pycllp_tpu_torch solve`` on an
    MPS file, and ``info``); ``checked_solve`` on a clean batch;
15. ``scenario_parallel``, the scenario-sharded layer (``parallel/``) on
    the main cell: (a) one NCCL rank runs ``sharded_hsd_solve_scan``, in
    turns with ``hsd_solve_scan`` (statuses bitwise, objectives to 1e-12);
    (b) two gloo ranks that share the card, 32,768 lanes each (all
    OPTIMAL, audited, objectives to 1e-6 of (a)); (c) ``sharded_hsd_solve``
    on 8,192 lanes on the fused-form set, collective and local termination
    (status agreement with the unsharded solve, equal host-loop counts on
    both ranks in collective mode); and the cost of one ``CollectiveAny``;
16. ``sweep_parallel``, config 5's sharded form: ``scenario_sweep(mesh=)``
    over 115,264 scenarios on two gloo ranks that share the card (and,
    when the machine has more than one card, over NCCL, one rank a card),
    killed with SIGKILL after 3 chunks and resumed by a fresh group:
    statuses equal to the unsharded sweep, equal host-loop counts per
    chunk on both ranks and unsharded, only rank 0 writes files;
17. ``big_lp``: the column-sharded solve of one 512 × 4,096 LP (B = 2,
    f32 + f64 finish) on two gloo ranks with the replicated and the
    row-sharded factor, the registry's ``schur`` solver on a problem with
    an odd column count, each audited against HiGHS, and the row-sharded
    FP64 Cholesky against ``torch.linalg.cholesky``;
18. last, a straight-line segment (in a process of its own) and a loop
    body that read a value back to the host: each capture must raise.

Ranks are processes started with the spawn method (``multiprocessing``)
that meet through a ``file://`` store under ``build/``; each writes its
report to a file there, and the parent checks every rank's.  The ranks of
one run share the one card: their walls measure the collectives' cost and
correctness, not scaling across cards.

Usage (from the repository root, one CUDA card):

    python3 chip_smoke.py

Every phase prints lines; any failure raises and the script exits
non-zero (there is no CPU fallback).  Every path phase checks, by the
``*_SMEM_LAUNCHES`` counters, that each of its factors, solves and fused
launches ran the lane-group design, and that each of its shared-A Ozaki
products was one ``ozaki_product_bl`` launch (``OZAKI_LAUNCHES`` equals
the products counted at ``df64._ozaki_matmul``, no ``slice_rounds_bl``).  The script's wall is printed just
before the kernel report; the kernel report, as JSON, is the line before
the last, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import multiprocessing
import os
import pickle
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, as_completed

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from pycllp_tpu_torch import SolverOptions, Status, available_solvers, get_solver  # noqa: E402
from pycllp_tpu_torch import parallel  # noqa: E402
from pycllp_tpu_torch.io import netlib  # noqa: E402
from pycllp_tpu_torch.io.generate import random_equality_lp, random_standard_lp  # noqa: E402
from pycllp_tpu_torch.io.mps import write_mps  # noqa: E402
from pycllp_tpu_torch.ops import _build  # noqa: E402
from pycllp_tpu_torch.ops import batchlast as bl  # noqa: E402
from pycllp_tpu_torch.ops import df64  # noqa: E402
from pycllp_tpu_torch.ops import lanemv  # noqa: E402
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS, PreparedA  # noqa: E402
from pycllp_tpu_torch.parallel.dchol import rowshard_cholesky, rowshard_cholesky_solve  # noqa: E402
from pycllp_tpu_torch.solvers import _loop  # noqa: E402
from pycllp_tpu_torch.solvers import hsd as hsd_mod  # noqa: E402
from pycllp_tpu_torch.solvers.dense_path import dense_path_solve_batched  # noqa: E402
from pycllp_tpu_torch.solvers.twopass import hsd_solve_two_pass  # noqa: E402
from pycllp_tpu_torch.utils.debug import checked_solve  # noqa: E402
from pycllp_tpu_torch.utils.logging import metrics_to_jsonl  # noqa: E402
from pycllp_tpu_torch.utils.sweep import scenario_sweep  # noqa: E402

SOURCES = {
    "chol_bl": "pycllp_tpu_torch/csrc/batchlast.cu",
    "solve_bl": "pycllp_tpu_torch/csrc/batchlast.cu",
    "fused_factor_bl": "pycllp_tpu_torch/csrc/batchlast.cu",
    "facsol_bl": "pycllp_tpu_torch/csrc/batchlast.cu",
    "df_chol_bl": "pycllp_tpu_torch/csrc/df64.cu",
    "df_solve_bl": "pycllp_tpu_torch/csrc/df64.cu",
    "slice_rounds_bl": "pycllp_tpu_torch/csrc/df64.cu",
    "ozaki_product_bl": "pycllp_tpu_torch/csrc/ozaki.cuh",
}
REPLACES = {
    "chol_bl": "pycllp_tpu/ops/batchlast.py:223",
    "solve_bl": "pycllp_tpu/ops/batchlast.py:273",
    "fused_factor_bl": "pycllp_tpu/ops/batchlast.py:195",
    "facsol_bl": "pycllp_tpu/ops/batchlast.py:247",
    "df_chol_bl": "pycllp_tpu/ops/df64.py:264",
    "df_solve_bl": "pycllp_tpu/ops/df64.py:295",
    "slice_rounds_bl": "pycllp_tpu/ops/df64.py:504",
    # the slicing kernel with the group GEMMs and the f64 sum of _ozaki_matmul
    # (pycllp_tpu/ops/df64.py:547) around it
    "ozaki_product_bl": "pycllp_tpu/ops/df64.py:504",
}
KERNEL_RTOL = 1e-4  # f32 kernels vs plain and vs the f32 reference set (smoke's bound)
F64_RTOL = 1e-12  # FP64 kernels vs their plain versions
# max relative objective error of the audited lanes of the NARROW path.
# The JAX reference, run on the CPU at this exact input and these options,
# audits at 2.2535e-3: its lane 18 ends STALLED at that error (the port
# lands on the same lane at the same error), so 2e-3 would fail it.
AUDIT_MAX = 3e-3
OK_SHARE = 0.99  # narrow path: OPTIMAL + STALLED share of lanes
# narrow path: ITERATION_LIMIT lanes (bucket overflow).  The JAX reference on
# the CPU leaves 67 at this input; on the card the left-looking solve gives
# 63 (the streaming design) and the column-oriented forward pass that the
# lane-group solve had gave 20.  The band holds the solve to the reference's
# loop order.
NARROW_LIMIT_BAND = (40, 100)
REF_NARROW_LIMIT = 67
CONTRACT = 1e-6  # wide finish: audited relative objective error, per lane
PROBE_OPTIMAL = 0.9  # probes: OPTIMAL share (tests_tpu/smoke.py's bound)
MAIN_OPTIMAL = 0.99  # full main path: OPTIMAL share

N_LP, M, N = 65536, 64, 64
# the BENCH_FINISH=0 operating point of bench.py, through the registry
SOLVER_KW = dict(
    dtype="float32", tol=1e-5, maxiter=40, stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, init_point="mehrotra",
    chunk=16384, compact_cap=12, compact_bucket=5120,
)
# bench.py's bench_options() at its defaults (BENCH_FINISH=1): the f32 bulk,
# then the wide f64 crossover finish on the mixed1 engine
BENCH_OPTIONS = dict(
    tol=1e-6, maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05,
    refine_steps=0, kkt_refine=3, kkt_refine_pred=0, kkt_warmup=0, gondzio_correctors=0,
    init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5, finish_maxiter=20,
    finish_gondzio=0, finish_mode="crossover", crossover_kset="mixed1", crossover_repair=2,
    crossover_refine=2, crossover_feas_tol=1e-9, finish_kkt_refine=0,
)
# bench.py's run_throughput scan arguments
SCAN_KW = dict(chunk=16384, keys=("objective", "status", "iterations"), compact_cap=12,
               compact_bucket=5120, finish_cap=3, finish_bucket=1024)
# BASELINE.md config 5 as written, on bench.py's run_sweep path with
# BENCH_TOTAL=1000000: 1,000,000 scenarios = 61 chunks of 16,384 + 576, so 62
# chunks in windows of 4, the last window of 2 and its second chunk ragged
SWEEP_N = 1_000_000
SWEEP_KW = dict(chunk=16384, compact_cap=12, compact_bucket=5120, window_chunks=4,
                finish_cap=3, finish_bucket=1024)
SWEEP_OBJ_RTOL = 1e-9  # resumed vs uninterrupted sweep: same kernels, same inputs
SWEEP_KILL_WINDOWS = 8  # the child sweep kills itself after this many windows (32 chunks)
# config 5's sharded form (scenario_sweep(mesh=)): one sharded_hsd_solve a
# chunk, no scan, so cut to 7 chunks + a ragged 576; killed after chunk 3
SWEEP_PARALLEL_N = 7 * 16384 + 576
SWEEP_PARALLEL_KILL = 3
# the wide audit: scipy highs on this many evenly spaced lanes, plus the
# non-OPTIMAL lanes up to a cap, in a process pool
WIDE_AUDIT_LANES = 2048
WIDE_AUDIT_STRAGGLERS = 256
AUDIT_WORKERS = 8
# config 5 audited beyond the grid: after the named lanes off the grid and
# every non-OPTIMAL lane (no cap), the first OFF_GRID_LANES of a seeded random
# permutation of the lanes off the 2,048-lane grid, fed to the pool in
# batches.  The sample is what a budget of 120 s of pool wall audits on the
# card's host (120,576 lanes in 124.1 s, 8 processes, H100 machine).  A fixed
# count keeps the audited lanes the same in every run, and no batch is taken
# after OFF_GRID_CEILING_S of pool wall (a slower host audits a prefix).
OFF_GRID_LANES = 120_000
OFF_GRID_CEILING_S = 180.0
OFF_GRID_BATCH = 256
OFF_GRID_SEED = 11
# The wide audits hold each OPTIMAL lane to CONTRACT, except the lanes named
# here with a limit of their own.  Each ends OPTIMAL as a wide-IPM point (its
# crossover vertex was rejected), accepted by ρ-indicators ≤ tol, which do not
# bound the objective error by tol, and the JAX reference itself ends it above
# the contract on the CPU, regenerated alone or in the 64 lanes around it
# (tests/test_torch_audit.py).  The card's reading repeats in every run (H100
# 80GB HBM3, 700 W); each limit is 1.5x it.
# - 584269 (on the grid): the reference 1.70e-6 in 64 lanes (2.98e-7 alone);
#   the card 2.0049e-6.
# - 380766 (off the grid): the reference 1.33e-6 alone, 1.38e-6 in 64 lanes;
#   the card 1.4014e-6.
# - 819372 (off the grid): the reference 3.23e-6 alone (in 64 lanes its
#   crossover accepts a vertex, 5.5e-14); the card 1.2298e-6.
CONFIG5_OVER_CONTRACT = {584269: 3e-6, 380766: 2.1e-6, 819372: 1.85e-6}
# the fastform factor against the plain FP64 factor of the f64-formed M:
# about 10x the card's reading (2.9e-7, H100 80GB HBM3, 700 W).  A sanity
# bound: at d within f32's range both formations agree to f32 noise, so what
# tells them apart is the NaN lane of a d beyond f32's range and the
# NUMERICAL mix (tests/test_torch_df64.py, tests/test_torch_finish.py)
FASTFORM_RTOL = 3e-6
REF_FASTFORM_NUMERICAL = "15.8K of 16.4K lanes NUMERICAL (the JAX reference on a TPU)"
# config 4: replicas per netlib fixture (VERDICT "Next round" 3: >= 8K per
# bucket), and the lane counts the kernels are held at on its shapes
NETLIB_REPS = 8192
NETLIB_B = (1, 300, 8192)
TWOPASS_N = 4096  # per-instance lanes of the twopass ladder
TWOPASS_CAP = 6  # its pass-1 cap: below the lanes' 7-15 iterations, so pass 2 runs
CARD = torch.device("cuda", 0)
# the lane-group solves' times before their forward pass became left-looking
# (H100 80GB HBM3, 700 W; k = 1, m = 64; B = 16,384 f32, 1,024 f64)
COLUMN_ORDER_SOLVE_MS = {"solve_bl": "0.198", "df_solve_bl": "0.039-0.072"}
# the shapes the main path's phases hold each kernel at (phases 2 and 6)
MAIN_SHAPES = {
    "chol_bl": ["m=64, n=128, B=256/300/16384 (lane-group and streaming)",
                "m=100, B=300; m=300, B=40 (lane-group); m=341, B=40 (streaming)"],
    "solve_bl": ["m=64, B=256/300/16384, k=1/2/3 (lane-group and streaming)",
                 "m=100, B=300; m=300, B=40 (lane-group); m=341, B=40 (streaming), k=1/2/3"],
    "fused_factor_bl": ["m=64, n=128, B=256/300/16384 (lane-group and streaming)",
                        "m=100, n=216, B=300 (lane-group); m=129, n=274, B=40 (streaming)"],
    "facsol_bl": ["m=64, B=256/300/16384, k=1/2/3 (lane-group and streaming)",
                  "m=100, B=300; m=300, B=40 (lane-group); m=341, B=40 (streaming), k=3"],
    "df_chol_bl": ["m=64, n=128, B=256/300 (lane-group and streaming)",
                   "m=100, B=300; m=200, B=40 (lane-group); m=241, B=40 (streaming)"],
    "df_solve_bl": ["m=64, B=256/300, k=1/2/3 (lane-group and streaming)",
                    "m=100, B=300; m=200, B=40 (lane-group); m=241, B=40 (streaming), k=1/2/3"],
    "slice_rounds_bl": ["r=128, B=16384; r=64, B=300"],
    "ozaki_product_bl": ["mv 64x128, rmv 128x64: B=1/300/1024/5120/16384; formation "
                         "4096x128: B=1/300/1024"],
}
# ozaki_product_bl's widths: the matvecs' up to a chunk, the formation's up
# to the drain's tier 1 (it forms M only in the finish); netlib's buckets
OZAKI_WIDTHS = (1, 300, 1024, 5120, 16384)
OZAKI_FORMATION_MAX_B = 1024
OZAKI_NETLIB_WIDTHS = (300, 8192)


def say(phase: str, msg: str) -> None:
    print(f"[chip_smoke] {phase}: {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).abs().max() / ref.abs().max())


def abs_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).abs().max())


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(label: str, kern, plain, reps_k: int = 10, reps_p: int = 5) -> tuple[float, float]:
    """Times in turns (plain, kernel, kernel, plain); returns mean (kernel, plain) ms."""
    p1 = time_ms(plain, reps_p)
    k1 = time_ms(kern, reps_k)
    k2 = time_ms(kern, reps_k)
    p2 = time_ms(plain, reps_p)
    say("kernel time", f"{label}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    return (k1 + k2) / 2, (p1 + p2) / 2


def designs_in_turns(label: str, new, stream, plain, reps: int = 20) -> dict:
    """A two-design kernel timed in turns (plain, streaming, lane-group,
    lane-group, streaming, plain); returns the mean ms of each as ``ms``
    (the lane-group design, the default), ``stream_ms`` and ``plain_ms``."""
    p1 = time_ms(plain, 5)
    s1 = time_ms(stream, reps)
    n1 = time_ms(new, reps)
    n2 = time_ms(new, reps)
    s2 = time_ms(stream, reps)
    p2 = time_ms(plain, 5)
    say("kernel time", f"{label}: lane-group {n1:.4f}/{n2:.4f} ms, streaming {s1:.4f}/{s2:.4f} "
        f"ms ({(s1 + s2) / (n1 + n2):.2f}x), plain {p1:.4f}/{p2:.4f} ms")
    return {"ms": (n1 + n2) / 2, "stream_ms": (s1 + s2) / 2, "plain_ms": (p1 + p2) / 2}


def lane_sweep(label: str, launch, dtype, reps: int = 20, sizes=None) -> dict:
    """The lane-group kernel at every built G (``launch(G)``; ``sizes``, or
    the factor's and solve's for ``dtype``), timed one after another (the
    label names the planned G).  Returns {G: ms}."""
    sizes = sizes or bl._LANE_GROUPS[dtype.itemsize]
    ms = {G: time_ms(lambda: launch(G), reps) for G in sizes}
    say("lane sweep", f"{label}: " + ", ".join(f"G={G} {t:.4f} ms" for G, t in ms.items()))
    return ms


# ---------------------------------------------------------------------------
# bounds and library yardsticks
# ---------------------------------------------------------------------------

# NVIDIA's H100 SXM data sheet: HBM rate, the FP32 / FP64 rates outside the
# tensor cores (the kernels use neither TF32 nor DMMA), and the dense bf16
# tensor-core rate (ozaki_product_bl's mma.sync)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: (67e12, "fp32"), torch.float64: (34e12, "fp64"),
              torch.bfloat16: (989e12, "bf16 tensor")}


def _tri(m: int) -> int:
    """Entries of an m×m lower triangle, diagonal included."""
    return m * (m + 1) // 2


def chol_flops(m: int) -> int:
    """Operations of one lane's factor: m square roots and reciprocals, the
    column scalings, and an FMA (2 operations) per trailing update."""
    return 2 * m + m * (m - 1) // 2 + 2 * sum(_tri(t) for t in range(1, m))


def solve_flops(m: int, k: int) -> int:
    """Operations of one lane's k-RHS solve: an FMA per L entry below the
    diagonal and a scaling per row, in each pass."""
    return k * (2 * m * (m - 1) + 2 * m)


def bound(nbytes: int, flops: int, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of their type."""
    peak, unit = PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    by_bytes = t_bytes >= t_ops
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if by_bytes else "operations",
            "bound_unit": "hbm" if by_bytes else unit, "bound_bytes": nbytes, "bound_flops": flops}


def chol_bound(m: int, B: int, dtype) -> dict:
    """M's lower triangle and reg read, L's lower triangle and dinv written
    (only those carry meaning)."""
    size = dtype.itemsize
    return bound((2 * _tri(m) + m + 1) * B * size, chol_flops(m) * B, dtype)


def solve_bound(m: int, B: int, k: int, dtype) -> dict:
    """L's lower triangle, dinv and R read, V written."""
    size = dtype.itemsize
    return bound((_tri(m) + m + 2 * k * m) * B * size, solve_flops(m, k) * B, dtype)


def library_chol(M_bl, reg) -> dict:
    """torch.linalg.cholesky_ex on a batch-first contiguous copy of M + reg·I
    (the one PyTorch call computing chol_bl's function; the port never calls
    it), and the permute that makes the copy, timed apart."""
    m = M_bl.shape[0]
    eye = torch.eye(m, dtype=M_bl.dtype, device=M_bl.device)
    permute_ms = time_ms(lambda: M_bl.permute(2, 0, 1).contiguous(), 10)
    Mbf = M_bl.permute(2, 0, 1).contiguous() + reg[:, None, None] * eye
    ms = time_ms(lambda: torch.linalg.cholesky_ex(Mbf), 10)
    return {"library_ms": ms, "library_permute_ms": permute_ms,
            "library_call": "torch.linalg.cholesky_ex"}


def library_solve(L_bl, R) -> dict:
    """torch.cholesky_solve on batch-first copies of L's lower triangle and
    R, and the permutes that make them, timed apart."""
    permute_ms = time_ms(lambda: (torch.tril(L_bl.permute(2, 0, 1)),
                                  R.permute(2, 1, 0).contiguous()), 10)
    Lbf = torch.tril(L_bl.permute(2, 0, 1))
    Rbf = R.permute(2, 1, 0).contiguous()  # (B, m, k)
    ms = time_ms(lambda: torch.cholesky_solve(Rbf, Lbf), 10)
    return {"library_ms": ms, "library_permute_ms": permute_ms,
            "library_call": "torch.cholesky_solve"}


def no_library(why: str) -> dict:
    return {"library_ms": None, "library_permute_ms": None, "library_call": None,
            "library_none": why}


def zero_counts() -> None:
    bl.CHOL_LAUNCHES = bl.SOLVE_LAUNCHES = 0
    bl.CHOL_SMEM_LAUNCHES = bl.SOLVE_SMEM_LAUNCHES = 0
    bl.FUSED_FACTOR_LAUNCHES = bl.FACSOL_LAUNCHES = 0
    bl.FUSED_FACTOR_SMEM_LAUNCHES = bl.FACSOL_SMEM_LAUNCHES = 0
    df64.DF_CHOL_LAUNCHES = df64.DF_SOLVE_LAUNCHES = df64.SLICE_LAUNCHES = 0
    df64.DF_CHOL_SMEM_LAUNCHES = df64.DF_SOLVE_SMEM_LAUNCHES = 0
    df64.OZAKI_LAUNCHES = df64.OZAKI_MATMUL_LAUNCHES = 0
    lanemv.LANE_MV_LAUNCHES = lanemv.LANE_RMV_LAUNCHES = lanemv.LANE_NORMAL_LAUNCHES = 0
    hsd_mod.HOST_STEPS = 0
    _loop.GATED_OFF_STEPS = _loop.HOST_SYNCS = _loop.GRAPH_CAPTURES = _loop.GRAPH_REPLAYS = 0
    _loop.STAGE_READS = _loop.SEGMENT_CALLS = 0


def read_counts() -> dict:
    return {"chol_bl": bl.CHOL_LAUNCHES, "solve_bl": bl.SOLVE_LAUNCHES,
            "fused_factor_bl": bl.FUSED_FACTOR_LAUNCHES, "facsol_bl": bl.FACSOL_LAUNCHES,
            "df_chol_bl": df64.DF_CHOL_LAUNCHES, "df_solve_bl": df64.DF_SOLVE_LAUNCHES,
            "slice_rounds_bl": df64.SLICE_LAUNCHES, "ozaki_product_bl": df64.OZAKI_LAUNCHES,
            "ozaki_products": df64.OZAKI_MATMUL_LAUNCHES, "host_steps": hsd_mod.HOST_STEPS,
            "gated_off": _loop.GATED_OFF_STEPS, "host_syncs": _loop.HOST_SYNCS,
            "graph_captures": _loop.GRAPH_CAPTURES, "graph_replays": _loop.GRAPH_REPLAYS,
            "stage_reads": _loop.STAGE_READS, "segment_calls": _loop.SEGMENT_CALLS,
            "chol_bl_smem": bl.CHOL_SMEM_LAUNCHES, "solve_bl_smem": bl.SOLVE_SMEM_LAUNCHES,
            "fused_factor_bl_smem": bl.FUSED_FACTOR_SMEM_LAUNCHES,
            "facsol_bl_smem": bl.FACSOL_SMEM_LAUNCHES,
            "df_chol_bl_smem": df64.DF_CHOL_SMEM_LAUNCHES,
            "df_solve_bl_smem": df64.DF_SOLVE_SMEM_LAUNCHES,
            "lane_mv": lanemv.LANE_MV_LAUNCHES, "lane_rmv": lanemv.LANE_RMV_LAUNCHES,
            "lane_normal": lanemv.LANE_NORMAL_LAUNCHES}


# each kernel's name in the profiler's device events (_kernel_group)
PROFILE_NAMES = {"chol_bl": "chol_bl_smem_kernel", "solve_bl": "solve_bl_smem_kernel",
                 "df_chol_bl": "chol_bl_smem_kernel<double>",
                 "df_solve_bl": "solve_bl_smem_kernel<double>",
                 "slice_rounds_bl": "slice_rounds_kernel",
                 "ozaki_product_bl": "ozaki_product_kernel",
                 "fused_factor_bl": "fused_factor_bl_smem_kernel",
                 "facsol_bl": "facsol_bl_smem_kernel"}


# the kernels with two designs: each launch counts in both counters when it
# ran the lane-group design (csrc/batchlast_smem.cuh)
TWO_DESIGNS = ("chol_bl", "solve_bl", "df_chol_bl", "df_solve_bl", "fused_factor_bl", "facsol_bl")


def check_smem_route(label: str, counts: dict) -> None:
    """Every factor, solve and fused launch of a path at m <= 128 ran the
    lane-group design, and every shared-A Ozaki product of the path was one
    ozaki_product_bl launch (none sliced by slice_rounds_bl)."""
    for name in TWO_DESIGNS:
        check(counts[f"{name}_smem"] == counts[name],
              f"{label}: {name} launched {counts[name]} times, {counts[f'{name}_smem']} of them "
              "on the lane-group design")
    check(counts["ozaki_product_bl"] == counts["ozaki_products"] and counts["slice_rounds_bl"] == 0,
          f"{label}: {counts['ozaki_products']} Ozaki products, {counts['ozaki_product_bl']} "
          f"ozaki_product_bl launches, {counts['slice_rounds_bl']} slice_rounds_bl launches")


# the shape of every shared-A Ozaki product with lanes on the card, where the
# kernel sets call it (df64._ozaki_matmul), while a phase records them; the
# products themselves are counted by df64.OZAKI_MATMUL_LAUNCHES (a product
# inside a captured block once a replay)
_PRODUCT_SHAPES = {"on": False, "shapes": []}  # (rows, n, B, levels)


def _logged_products(inner):
    def logged(W, d, *, s, n_slices, cut):
        if _PRODUCT_SHAPES["on"] and d.is_cuda and d.shape[0] and W.e.shape[0]:
            _PRODUCT_SHAPES["shapes"].append((W.e.shape[0], d.shape[1], d.shape[0], cut - 1))
        return inner(W, d, s=s, n_slices=n_slices, cut=cut)

    return logged


df64._ozaki_matmul = _logged_products(df64._ozaki_matmul)


@contextlib.contextmanager
def split_ozaki_route():
    """Route every Ozaki product through _ozaki_matmul_split (the
    slice_rounds_bl kernel, f32 torch.matmul group GEMMs, the f64 sum): the
    card's route before ozaki_product_bl, on no solver path otherwise."""
    kernel = df64._ozaki_product_bl_cuda

    def split(W, d, s, n_slices, cut):
        return df64._ozaki_matmul_split(W, d, s=s, n_slices=n_slices, cut=cut)

    # a cached graph replays the launches it captured: none may outlive the
    # change of route, either way
    _loop._clear_graphs()
    df64._ozaki_product_bl_cuda = split
    try:
        yield
    finally:
        df64._ozaki_product_bl_cuda = kernel
        _loop._clear_graphs()


@contextlib.contextmanager
def narrow_stage_counts():
    """Yield a dict that receives :func:`read_counts` at the moment the
    scan's narrow stage hands over to its finish (the entry of
    ``_hsd_scan_finish_core``), so a path's narrow launches and host
    iterations can be told from its finish's."""
    snap = {}
    finish_core = hsd_mod._hsd_scan_finish_core

    def entered(*args, **kwargs):
        snap.update(read_counts())
        return finish_core(*args, **kwargs)

    hsd_mod._hsd_scan_finish_core = entered
    try:
        yield snap
    finally:
        hsd_mod._hsd_scan_finish_core = finish_core


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s) visible; nvidia-smi: {smi}")
    return kind, smi


def phase_build() -> None:
    info = _build.build()
    _build.load()
    regs = [ln.strip() for ln in info.log.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    say("build", f"{info.path.name} in {info.seconds:.2f}s (cached={info.cached}); "
        + " | ".join(regs))


# ---------------------------------------------------------------------------
# kernel parity and times
# ---------------------------------------------------------------------------


def _inputs(B: int, seed: int, dev):
    # tests_tpu/smoke.py's construction, with A/sqrt(n) cast LAST
    rng = np.random.default_rng(seed)
    m, n = 64, 128
    A = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)
    d = rng.uniform(0.5, 2.0, size=(B, n)).astype(np.float32)
    R = rng.normal(size=(2, m, B)).astype(np.float32)
    return (torch.from_numpy(A).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(R).to(dev))


def _formed(A, d, reg_eps):
    """M (batch-last) and reg exactly as BatchLastKernels.factor forms them."""
    ctx = bl.BATCHLAST_KERNELS.prepare(A)
    m = A.shape[0]
    reg = (reg_eps * (d @ ctx.Asq.T).amax(dim=-1)).to(d.dtype)
    return (ctx.W @ d.T).reshape(m, m, d.shape[0]), reg


def _lower(L):
    return torch.tril(L.permute(2, 0, 1))


def _nan_lane_f32(A, d, R, phase: str, label: str) -> None:
    """Lane 2 with negated d is indefinite: chol_bl (then solve_bl),
    fused_factor_bl and facsol_bl NaN it and leave every other lane finite."""
    d = d.clone()
    d[2] = -d[2]
    W = bl.BATCHLAST_KERNELS.prepare(A).W
    M_bl, reg = _formed(A, d, 0.0)
    L, dinv = bl._chol_bl_cuda(M_bl, reg)
    V = bl._solve_bl_cuda(L, dinv, R[:1].contiguous())
    Lf, dinv_f = bl._fused_factor_bl_cuda(W, d.T.contiguous(), reg)
    Vf = bl._solve_bl_cuda(Lf, dinv_f, R[:1].contiguous())
    _, dinv_c, Vc = bl._facsol_bl_cuda(M_bl.clone(), reg, R.contiguous())
    torch.cuda.synchronize()
    for name, dv, VV in (("chol_bl", dinv, V), ("fused_factor_bl", dinv_f, Vf),
                         ("facsol_bl", dinv_c, Vc)):
        check(bool(torch.isnan(dv[:, 2]).any()) and bool(torch.isnan(VV[:, :, 2]).any()),
              f"{name} NaN lane at {label}: lane 2 is not NaN")
        others = torch.cat([VV[:, :, :2], VV[:, :, 3:]], dim=2)
        check(bool(torch.isfinite(others).all()), f"{name} NaN lane at {label}: another lane")
    say(phase, f"{label}: negated-d lane 2 is NaN in chol_bl (+ solve_bl), fused_factor_bl and "
        "facsol_bl, every other lane finite")


def _nan_lane_f64(A, d, R, phase: str, label: str) -> None:
    """The same for df_chol_bl (then df_solve_bl), in f64."""
    d = d.clone()
    d[2] = -d[2]
    M_bl, reg = _formed64(A, d, 0.0)
    L, dinv = df64._df_chol_bl_cuda(M_bl, reg)
    V = df64._df_solve_bl_cuda(L, dinv, R[:1].contiguous())
    torch.cuda.synchronize()
    check(bool(torch.isnan(V[0, :, 2]).any()), f"df NaN lane at {label}: lane 2 is not NaN")
    others = torch.cat([V[0, :, :2], V[0, :, 3:]], dim=1)
    check(bool(torch.isfinite(others).all()), f"df NaN lane at {label}: another lane is not finite")
    say(phase, f"{label}: negated-d lane 2 is NaN in df_chol_bl (+ df_solve_bl), every other "
        "lane finite")


def _hold_designs(chol_cuda, solve_cuda, M_bl, reg, R, rtol, label: str) -> tuple[float, float,
                                                                                    str]:
    """The factor and the k = 1, 2, 3 solves on the default (lane-group)
    and the streaming design against the plain versions: the lower
    triangle, dinv and V to ``rtol`` (k = 3 runs the lane-group solve's
    right-hand sides in two turns).  Returns (factor max abs err, solve max
    abs err, a summary)."""
    L_p, dinv_p = bl._chol_bl_plain(M_bl, reg)
    R = torch.cat([R, 2 * R[:1]])  # a third right-hand side
    e_abs = [0.0, 0.0]
    line = []
    for design in (None, "stream"):
        L_k, dinv_k = chol_cuda(M_bl, reg, design=design)
        torch.cuda.synchronize()
        e_chol = max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p))
        name = design or "lane-group"
        check(e_chol < rtol, f"factor ({name}) vs plain at {label}: rel {e_chol:.2e}")
        e_abs[0] = max(e_abs[0], abs_err(_lower(L_k), _lower(L_p)), abs_err(dinv_k, dinv_p))
        e_solve = []
        for k in (1, 2, 3):
            Rk = R[:k].contiguous()
            V_k = solve_cuda(L_p, dinv_p, Rk, design=design)
            V_p = bl._solve_bl_plain(L_p, dinv_p, Rk)
            torch.cuda.synchronize()
            e = rel_err(V_k, V_p)
            check(e < rtol, f"solve k={k} ({name}) vs plain at {label}: rel {e:.2e}")
            e_abs[1] = max(e_abs[1], abs_err(V_k, V_p))
            e_solve.append(f"{e:.1e}")
        line.append(f"{name}: chol rel {e_chol:.1e}, solve k=1/2/3 rel {'/'.join(e_solve)}")
    return e_abs[0], e_abs[1], "; ".join(line)


def _hold_large_m(dev, dtype, rtol: float) -> None:
    """The factor and the k = 1, 2, 3 solves through the default route at m
    past 64 (the lane-group kernels' 2-row-pair / 4-row and 6-pair /
    11-row instantiations) and just past the lane-group limit (the
    streaming kernels), against the plain versions, on a random SPD M; in
    float also facsol_bl there, and fused_factor_bl at m = 100 and 129."""
    chol, solve = ((bl._chol_bl_cuda, bl._solve_bl_cuda) if dtype == torch.float32
                   else (df64._df_chol_bl_cuda, df64._df_solve_bl_cuda))
    limit = max(m for m in range(1, 400) if bl.uses_smem(m, dtype))
    line = []
    for m, B in ((100, 300), (limit - 40, 40), (limit + 1, 40)):
        rng = np.random.default_rng(m)
        A = torch.from_numpy(rng.normal(size=(B, m, m + 16))).to(dev, dtype)
        M = (A @ A.mT / (m + 16)).permute(1, 2, 0).contiguous()
        M += torch.eye(m, device=dev, dtype=dtype)[:, :, None]
        reg = torch.full((B,), 1e-6, device=dev, dtype=dtype)
        R = torch.from_numpy(rng.normal(size=(3, m, B))).to(dev, dtype)
        zero_counts()
        L_k, dinv_k = chol(M, reg)
        L_p, dinv_p = bl._chol_bl_plain(M, reg)
        e = [max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p))]
        for k in (1, 2, 3):
            V_k = solve(L_p, dinv_p, R[:k].contiguous())
            e.append(rel_err(V_k, bl._solve_bl_plain(L_p, dinv_p, R[:k].contiguous())))
        torch.cuda.synchronize()
        counts = read_counts()
        name = "chol_bl" if dtype == torch.float32 else "df_chol_bl"
        design = "lane-group" if counts[f"{name}_smem"] else "streaming"
        check(design == ("lane-group" if m <= limit else "streaming"),
              f"{name} at m={m} ran the {design} design")
        check(max(e) < rtol, f"{name} / solve at m={m}, B={B}: rel {max(e):.2e}")
        line.append(f"m={m}, B={B} ({design}): chol {e[0]:.1e}, solve k=1/2/3 "
                    f"{'/'.join(f'{x:.1e}' for x in e[1:])}")
        if dtype == torch.float32:
            # facsol_bl on the same lanes, k = 3: the factor's 2- and 6-pair
            # instantiations, and the streaming kernel past the limit
            zero_counts()
            Lc, dinv_c, Vc = bl._facsol_bl_cuda(M.clone(), reg, R)
            Lp, dinv_cp, Vp = bl._facsol_bl_plain(M.clone(), reg, R)
            torch.cuda.synchronize()
            e_fs = max(rel_err(_lower(Lc), _lower(Lp)), rel_err(dinv_c, dinv_cp), rel_err(Vc, Vp))
            smem = read_counts()["facsol_bl_smem"] == 1
            check(smem == (m <= limit), f"facsol_bl at m={m} ran the "
                  f"{'lane-group' if smem else 'streaming'} design")
            check(e_fs < rtol, f"facsol_bl k=3 at m={m}, B={B}: rel {e_fs:.2e}")
            line[-1] += f", facsol k=3 {e_fs:.1e}"
    if dtype == torch.float32:
        # fused_factor_bl at m = 100 (its 2-pair instantiation) and just past
        # its lane-group limit, m = 129 (the streaming kernel)
        for m, B in ((100, 300), (bl._FUSED_MAX_M + 1, 40)):
            rng = np.random.default_rng(m)
            A = torch.from_numpy(rng.normal(size=(m, m + 16)) / np.sqrt(m + 16)).to(dev, dtype)
            A = torch.cat([A, torch.eye(m, device=dev, dtype=dtype)], dim=1)
            d = torch.from_numpy(rng.uniform(0.5, 2.0, size=(B, 2 * m + 16))).to(dev, dtype)
            W = bl.BATCHLAST_FUSED_KERNELS.prepare(A).W
            reg = torch.full((B,), 1e-6, device=dev, dtype=dtype)
            zero_counts()
            L_k, dinv_k = bl._fused_factor_bl_cuda(W, d.T.contiguous(), reg)
            L_p, dinv_p = bl._fused_factor_bl_plain(W, d.T.contiguous(), reg)
            torch.cuda.synchronize()
            e = max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p))
            smem = read_counts()["fused_factor_bl_smem"] == 1
            check(smem == (m <= bl._FUSED_MAX_M), f"fused_factor_bl at m={m} ran the "
                  f"{'lane-group' if smem else 'streaming'} design")
            check(e < rtol, f"fused_factor_bl at m={m}, B={B}: rel {e:.2e}")
            line.append(f"fused_factor m={m}, B={B} "
                        f"({'lane-group' if smem else 'streaming'}): {e:.1e}")
    say("kernel parity", f"{dtype} large m: " + "; ".join(line))


def phase_kernels(dev) -> dict:
    """chol_bl / solve_bl (f32), both designs, against their plain versions
    and the f32 reference set; returns {name: {err, ms, stream_ms,
    plain_ms, bound, library}}."""
    errs = {"chol_bl": 0.0, "solve_bl": 0.0}
    for B in (256, 300, 16384):
        A, d, R = _inputs(B, seed=B, dev=dev)
        M_bl, reg = _formed(A, d, 1e-6)
        e_c, e_s, line = _hold_designs(bl._chol_bl_cuda, bl._solve_bl_cuda, M_bl, reg, R,
                                       KERNEL_RTOL, f"m=64, B={B}")
        errs["chol_bl"] = max(errs["chol_bl"], e_c)
        errs["solve_bl"] = max(errs["solve_bl"], e_s)
        # the kernels' factor and solve against the f32 reference set (torch.linalg)
        L_k, dinv_k = bl._chol_bl_cuda(M_bl, reg)
        fac_r = REFERENCE_KERNELS.factor(PreparedA(A, A * A), d, 1e-6)
        for k in (1, 2):
            Rk = R[:k].contiguous()
            V_k = bl._solve_bl_cuda(L_k, dinv_k, Rk)
            V_r = torch.stack(REFERENCE_KERNELS.solve(fac_r, tuple(Rk[i].T for i in range(k))))
            torch.cuda.synchronize()
            e_ref = rel_err(V_k.transpose(1, 2), V_r)
            check(e_ref < KERNEL_RTOL, f"chol_bl + solve_bl k={k} vs reference at B={B}: "
                  f"rel {e_ref:.2e}")
            line += f"; k={k} vs reference set {e_ref:.1e}"
        say("kernel parity", f"B={B}: {line}")

    _nan_lane_f32(*_inputs(256, seed=9, dev=dev), "kernel parity", "m=64, n=128, B=256")
    _hold_large_m(dev, torch.float32, KERNEL_RTOL)

    # times at the narrow path's shapes (m = 64; the chunk B = 16,384 and
    # the resume bucket B = 5,120), in turns, and the lane-group sweep
    out, sweeps = {}, {}
    for B in (16384, 5120):
        A, d, R = _inputs(B, seed=1, dev=dev)
        M_bl, reg = _formed(A, d, 1e-6)
        L, dinv = bl._chol_bl_cuda(M_bl, reg)
        R1, R2 = R[:1].contiguous(), R.contiguous()
        t_chol = designs_in_turns(f"chol_bl at m=64, B={B}", lambda: bl._chol_bl_cuda(M_bl, reg),
                                  lambda: bl._chol_bl_cuda(M_bl, reg, design="stream"),
                                  lambda: bl._chol_bl_plain(M_bl, reg))
        t_solve = designs_in_turns(f"solve_bl k=1 at m=64, B={B}",
                                   lambda: bl._solve_bl_cuda(L, dinv, R1),
                                   lambda: bl._solve_bl_cuda(L, dinv, R1, design="stream"),
                                   lambda: bl._solve_bl_plain(L, dinv, R1))
        designs_in_turns(f"solve_bl k=2 at m=64, B={B}", lambda: bl._solve_bl_cuda(L, dinv, R2),
                         lambda: bl._solve_bl_cuda(L, dinv, R2, design="stream"),
                         lambda: bl._solve_bl_plain(L, dinv, R2))
        sweeps[f"chol_bl m=64 B={B}"] = lane_sweep(
            f"chol_bl at m=64, B={B} (planned G={bl.lane_plan('chol', 64, B, torch.float32).lanes})",
            lambda G: bl._chol_bl_cuda(M_bl, reg, design="smem", lanes=G), torch.float32)
        sweeps[f"solve_bl k=1 m=64 B={B}"] = lane_sweep(
            f"solve_bl k=1 at m=64, B={B} (planned G="
            f"{bl.lane_plan('solve', 64, B, torch.float32).lanes})",
            lambda G: bl._solve_bl_cuda(L, dinv, R1, design="smem", lanes=G), torch.float32)
        if B == 16384:
            out = {"chol_bl": {"err": errs["chol_bl"], **t_chol,
                               **chol_bound(64, B, torch.float32), **library_chol(M_bl, reg)},
                   "solve_bl": {"err": errs["solve_bl"], **t_solve,
                                **solve_bound(64, B, 1, torch.float32), **library_solve(L, R1)}}
        else:
            out["chol_bl"]["resume_bucket"] = {"B": B, **t_chol, **chol_bound(64, B, torch.float32)}
            out["solve_bl"]["resume_bucket"] = {"B": B, **t_solve,
                                                **solve_bound(64, B, 1, torch.float32)}
    for name, r in out.items():
        r["lane_sweep_ms"] = {k: v for k, v in sweeps.items() if k.startswith(name)}
        before = (f"; with the column-oriented forward pass: {COLUMN_ORDER_SOLVE_MS[name]} ms"
                  if name in COLUMN_ORDER_SOLVE_MS else "")
        say("kernel bound", f"{name} at m=64, B=16384: {r['ms']:.4f} ms (streaming "
            f"{r['stream_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms ({r['bound_unit']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of it), {r['library_call']} {r['library_ms']:.4f} ms "
            f"(+ permute {r['library_permute_ms']:.4f} ms){before}")
    return out


def _fused_bounds(m: int, n: int, B: int, k: int = 2) -> tuple[dict, dict]:
    """The bounds of fused_factor_bl and facsol_bl (k right-hand sides)."""
    size = 4
    # fused_factor_bl: W's lower-triangle rows, dT and reg read; L's lower
    # triangle and dinv written; the formation's FMAs and the factor's
    fused = bound((_tri(m) * n + n * B + B + (_tri(m) + m) * B) * size,
                  (2 * _tri(m) * n + chol_flops(m)) * B, torch.float32)
    # facsol_bl: chol_bl's bytes plus R read and V written
    facsol = bound((2 * _tri(m) + m + 1 + 2 * k * m) * B * size,
                   (chol_flops(m) + solve_flops(m, k)) * B, torch.float32)
    return fused, facsol


def w_bytes_per_lane(m: int, n: int, lanes: int) -> float:
    """Bytes of W a fused_factor_bl block asks for, per lane, by the
    design's formula: W's lower-triangle rows once for the block's lanes (32
    on the streaming design, G on the lane-group design).  A formula, not a
    reading: what L2 serves is not measured here."""
    return _tri(m) * n * 4 / lanes


def phase_fused_kernels(dev) -> dict:
    """fused_factor_bl / facsol_bl (f32) on both designs against their
    plain versions and against the split path they replace (matmul +
    chol_bl; chol_bl + solve_bl), k = 1/2/3 for facsol (k = 3 runs the
    lane-group kernel's right-hand sides in two turns); then times at the
    narrow stage's widths: both designs and the plain version in turns,
    the split path, the lane-group sizes.  Returns {name: {err, ms,
    stream_ms, plain_ms, split_ms, bound, ...}}."""
    errs = {"fused_factor_bl": 0.0, "facsol_bl": 0.0}
    for B in (256, 300, 16384):
        A, d, R = _inputs(B, seed=B, dev=dev)
        R = torch.cat([R, 2 * R[:1]])  # a third right-hand side
        W = bl.BATCHLAST_KERNELS.prepare(A).W
        dT = d.T.contiguous()
        M_bl, reg = _formed(A, d, 1e-6)
        L_p, dinv_p = bl._fused_factor_bl_plain(W, dT, reg)
        L_s, dinv_s = bl._chol_bl_cuda(M_bl, reg)
        line = [f"B={B}"]
        for design in (None, "stream"):
            name = design or "lane-group"
            L_k, dinv_k = bl._fused_factor_bl_cuda(W, dT, reg, design=design)
            torch.cuda.synchronize()
            e_plain = max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p))
            e_split = max(rel_err(_lower(L_k), _lower(L_s)), rel_err(dinv_k, dinv_s))
            check(e_plain < KERNEL_RTOL, f"fused_factor_bl ({name}) vs plain at B={B}: "
                  f"rel {e_plain:.2e}")
            check(e_split < KERNEL_RTOL, f"fused_factor_bl ({name}) vs chol_bl at B={B}: "
                  f"rel {e_split:.2e}")
            if design == "stream":  # the streaming kernel writes its upper triangle as zeros
                check(bool((torch.triu(L_k.permute(2, 0, 1), 1) == 0).all()),
                      f"streaming fused_factor_bl at B={B}: the upper triangle is not zero")
            same = bool(torch.equal(_lower(L_k), _lower(L_s)) and torch.equal(dinv_k, dinv_s))
            errs["fused_factor_bl"] = max(errs["fused_factor_bl"],
                                          abs_err(_lower(L_k), _lower(L_p)),
                                          abs_err(dinv_k, dinv_p))
            line.append(f"{name}: fused_factor rel {e_plain:.1e} (vs chol_bl {e_split:.1e}, "
                        f"bitwise equal {same})")
            e_line = []
            for k in (1, 2, 3):
                Rk = R[:k].contiguous()
                Lc, dinv_c, Vc = bl._facsol_bl_cuda(M_bl.clone(), reg, Rk, design=design)
                Lp, dinv_cp, Vp = bl._facsol_bl_plain(M_bl.clone(), reg, Rk)
                V_s = bl._solve_bl_cuda(L_s, dinv_s, Rk)
                torch.cuda.synchronize()
                e_plain = max(rel_err(_lower(Lc), _lower(Lp)), rel_err(dinv_c, dinv_cp),
                              rel_err(Vc, Vp))
                e_split = max(rel_err(_lower(Lc), _lower(L_s)), rel_err(dinv_c, dinv_s),
                              rel_err(Vc, V_s))
                check(e_plain < KERNEL_RTOL,
                      f"facsol_bl k={k} ({name}) vs plain at B={B}: rel {e_plain:.2e}")
                check(e_split < KERNEL_RTOL,
                      f"facsol_bl k={k} ({name}) vs chol_bl + solve_bl at B={B}: rel {e_split:.2e}")
                errs["facsol_bl"] = max(errs["facsol_bl"], abs_err(_lower(Lc), _lower(Lp)),
                                        abs_err(dinv_c, dinv_cp), abs_err(Vc, Vp))
                e_line.append(f"{e_plain:.1e} ({e_split:.1e})")
            line.append(f"{name}: facsol k=1/2/3 rel {'/'.join(e_line)} (vs chol_bl + solve_bl)")
        say("kernel parity", "; ".join(line))

    # times at the narrow stage's chunk (16,384) and the resume bucket
    # (5,120), m = 64, n = 128, in turns.  facsol_bl factors in place, so
    # each timed call (and each of the paths beside it) starts with a copy
    # of M into a work buffer.
    out = {}
    for B in (16384, 5120):
        A, d, R = _inputs(B, seed=1, dev=dev)
        W = bl.BATCHLAST_KERNELS.prepare(A).W
        dT = d.T.contiguous()
        M_bl, reg = _formed(A, d, 1e-6)
        m, n = A.shape
        Wp = bl.pack_w(W)  # as the fused-form set's prepare packs it, once per A
        R2 = R.contiguous()
        Mw = torch.empty_like(M_bl)
        t_f = designs_in_turns(f"fused_factor_bl at m=64, n=128, B={B}",
                               lambda: bl._fused_factor_bl_cuda(W, dT, reg, Wp=Wp),
                               lambda: bl._fused_factor_bl_cuda(W, dT, reg, design="stream"),
                               lambda: bl._fused_factor_bl_plain(W, dT, reg))
        _, split_f = in_turns(f"fused_factor_bl vs the split path (matmul + chol_bl) at B={B}",
                              lambda: bl._fused_factor_bl_cuda(W, dT, reg, Wp=Wp),
                              lambda: bl._chol_bl_cuda((W @ dT).reshape(m, m, B), reg))

        def facsol(design=None, lanes=None):
            Mw.copy_(M_bl)
            return bl._facsol_bl_cuda(Mw, reg, R2, design=design, lanes=lanes)

        def facsol_plain():
            Mw.copy_(M_bl)
            return bl._facsol_bl_plain(Mw, reg, R2)

        def split():
            Mw.copy_(M_bl)
            L, dinv = bl._chol_bl_cuda(Mw, reg)
            return bl._solve_bl_cuda(L, dinv, R2)

        t_c = designs_in_turns(f"facsol_bl k=2 (with the copy of M) at m=64, B={B}", facsol,
                               lambda: facsol("stream"), facsol_plain)
        _, split_c = in_turns(f"facsol_bl k=2 vs the split path (chol_bl + solve_bl k=2) at "
                              f"B={B}", facsol, split)
        copy_ms = time_ms(lambda: Mw.copy_(M_bl), 10)
        chol_ms = time_ms(lambda: bl._chol_bl_cuda(M_bl, reg), 10)
        gemm_ms = time_ms(lambda: W @ dT, 10)
        pack_ms = time_ms(lambda: bl.pack_w(W), 10)
        say("kernel time", f"at B={B}, alone: the copy of M {copy_ms:.4f} ms, chol_bl "
            f"{chol_ms:.4f} ms, the GEMM forming M {gemm_ms:.4f} ms, packing W (once per A, "
            f"in prepare) {pack_ms:.4f} ms")
        plan_f = bl.lane_plan("fused", m, B, torch.float32, n=n)
        sweep_f = lane_sweep(f"fused_factor_bl at m=64, n=128, B={B} (planned G={plan_f.lanes})",
                             lambda G: bl._fused_factor_bl_cuda(W, dT, reg, design="smem",
                                                                lanes=G, Wp=Wp),
                             torch.float32)
        sweep_c = lane_sweep(f"facsol_bl k=2 (with the copy of M) at m=64, B={B} (planned G="
                             f"{bl.lane_plan('facsol', m, B, torch.float32, k=2).lanes})",
                             lambda G: facsol("smem", G), torch.float32)
        w_bytes = {G: w_bytes_per_lane(m, n, G) for G in bl._LANE_GROUPS[4]}
        say("kernel time", f"fused_factor_bl W asked for per lane at B={B}, by the design's "
            f"formula (L2 traffic not measured): lane-group G={plan_f.lanes} "
            f"{w_bytes[plan_f.lanes]:.0f} B (all G: " + ", ".join(
                f"{G} {v:.0f}" for G, v in w_bytes.items()) + f"), streaming "
            f"{w_bytes_per_lane(m, n, 32):.0f} B")
        fused, facsol_b = _fused_bounds(m, n, B)
        no_call = "no single PyTorch call computes it; the split path is its yardstick"
        entries = {
            "fused_factor_bl": {**t_f, "split_ms": split_f, **fused, "lanes": plan_f.lanes,
                                "lane_sweep_ms": sweep_f, **no_library(no_call)},
            "facsol_bl": {**t_c, "split_ms": split_c, "copy_ms": copy_ms, **facsol_b,
                          "lane_sweep_ms": sweep_c, **no_library(no_call)}}
        for name, r in entries.items():
            if B == 16384:
                out[name] = {"err": errs[name], **r}
            else:
                out[name]["resume_bucket"] = {"B": B, **r}
    for name, r in out.items():
        say("kernel bound", f"{name} at m=64, B=16384: {r['ms']:.4f} ms (streaming "
            f"{r['stream_ms']:.4f} ms, split path {r['split_ms']:.4f} ms), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_unit']}; {r['bound_ms'] / r['ms']:.1%} of it); "
            f"at B=5120 {r['resume_bucket']['ms']:.4f} ms (streaming "
            f"{r['resume_bucket']['stream_ms']:.4f}, split {r['resume_bucket']['split_ms']:.4f}, "
            f"bound {r['resume_bucket']['bound_ms']:.4f})")
    return out


def _wide_inputs(B: int, seed: int, dev, spread: float = 0.0):
    """f64 A (64×128, /√n), d (B, 128) — uniform in [0.5, 2] or 10^U(±spread) — and R (2, 64, B)."""
    rng = np.random.default_rng(seed)
    m, n = 64, 128
    A = rng.normal(size=(m, n)) / np.sqrt(n)
    if spread:
        d = 10.0 ** rng.uniform(-spread, spread, size=(B, n))
    else:
        d = rng.uniform(0.5, 2.0, size=(B, n))
    R = rng.normal(size=(2, m, B))
    return (torch.from_numpy(A).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(R).to(dev))


def _slicing_bit_identical(rng, r: int, B: int, n: int, dev) -> list:
    """slice_rounds_bl on a normalised (r, B) operand spread over 1e±8, for
    the Ozaki parameters of the matvecs and of the formation at width n:
    bit-identical to its plain version, or raise.  Returns the (s,
    n_slices) pairs held."""
    X = rng.normal(size=(r, B)) * 10.0 ** rng.uniform(-8, 8, size=(r, B))
    X = torch.from_numpy(X / np.abs(X).max(axis=0, keepdims=True)).to(dev)
    Rh, Rl = df64._split_hi_lo(X)
    held = []
    for s, n_slices, _ in (df64.ozaki_mv_params(n), df64.ozaki_params(n)):
        S_k = df64._slice_rounds_bl_cuda(Rh, Rl, s, n_slices)
        S_p = df64._slice_rounds_bl_plain(Rh, Rl, s, n_slices)
        torch.cuda.synchronize()
        diff = abs_err(S_k, S_p)
        same = bool(torch.equal(S_k.view(torch.int32), S_p.view(torch.int32)))
        check(same and diff == 0.0, f"slice_rounds_bl ({r}, {B}) s={s} n={n_slices}: "
              f"not bit-identical (max abs diff {diff:.3e})")
        held.append((s, n_slices))
    return held


def _formed64(A, d, reg_eps):
    """f64 batch-last M = A·diag(d)·Aᵀ and reg = reg_eps·max(diag)."""
    m = A.shape[0]
    W = (A[:, None, :] * A[None, :, :]).reshape(m * m, -1)
    reg = reg_eps * (d @ (A * A).T).amax(dim=-1)
    return (W @ d.T).reshape(m, m, d.shape[0]).contiguous(), reg


def phase_wide_kernels(dev) -> dict:
    """The FP64 factor/solve and the slicing kernel against their plain
    versions, the df64 and Ozaki contracts, and times at the wide path's
    shapes; returns {name: (max_abs_err, ms, plain_ms)}."""
    errs = {"df_chol_bl": 0.0, "df_solve_bl": 0.0, "slice_rounds_bl": 0.0}
    for B in (256, 300):
        A, d, R = _wide_inputs(B, seed=100 + B, dev=dev)
        M_bl, reg = _formed64(A, d, 1e-12)
        e_c, e_s, line = _hold_designs(df64._df_chol_bl_cuda, df64._df_solve_bl_cuda, M_bl, reg,
                                       R, F64_RTOL, f"f64 m=64, B={B}")
        errs["df_chol_bl"] = max(errs["df_chol_bl"], e_c)
        errs["df_solve_bl"] = max(errs["df_solve_bl"], e_s)
        say("kernel parity", f"f64 B={B}: {line}")

    _nan_lane_f64(*_wide_inputs(256, seed=9, dev=dev), "kernel parity", "m=64, n=128, B=256")
    _hold_large_m(dev, torch.float64, F64_RTOL)

    # slicing: bit-identical to the plain version
    rng = np.random.default_rng(7)
    for r, B in ((128, 16384), (64, 300)):
        _slicing_bit_identical(rng, r, B, 128, dev)
        say("kernel parity", f"slice_rounds_bl ({r}, {B}): bit-identical to plain for "
            f"(s, n_slices) = {df64.ozaki_mv_params(128)[:2]} and {df64.ozaki_params(128)[:2]}")

    # check_df64 (tests_tpu/smoke.py): backward error at a 1e±12 spread
    kset = df64.DF64_FINISH_KERNELS
    A, d, R = _wide_inputs(256, seed=1, dev=dev, spread=12)
    r = R[0].T.contiguous()
    ctx = kset.prepare(A)
    fac = kset.factor(ctx, d, 1e-12)
    (v,) = kset.solve(fac, (r,))
    check(bool(torch.isfinite(v).all()), "df64 solve produced non-finite values")
    Mf = torch.einsum("mn,bn,kn->bmk", A, d, A) + fac.reg[:, None, None] * torch.eye(64, device=dev,
                                                                                     dtype=A.dtype)
    res = (torch.einsum("bmk,bk->bm", Mf, v) - r).abs()
    scale = Mf.abs().sum(-1).amax(-1) * v.abs().amax(-1) + r.abs().amax(-1)
    back = float((res.amax(-1) / scale).max())
    check(back < 1e-11, f"df64 backward error {back:.2e} at a 1e±12 spread")
    # ... and agreement with the f64 reference set at a moderate spread
    _, d2, _ = _wide_inputs(256, seed=2, dev=dev, spread=3)
    (v2,) = kset.solve(kset.factor(ctx, d2, 1e-12), (r,))
    fac_r = REFERENCE_KERNELS.factor(PreparedA(A, A * A), d2, 1e-12)
    (v_r,) = REFERENCE_KERNELS.solve(fac_r, (r,))
    agree = float(((v2 - v_r).abs() / v_r.abs().amax(-1, keepdim=True).clamp(min=1e-30)).max())
    check(agree < 1e-7, f"df64 vs f64 reference set rel {agree:.2e} at a 1e±3 spread")
    say("df64 contract", f"backward error {back:.2e} (< 1e-11) at 1e±12; "
        f"vs f64 reference set {agree:.2e} (< 1e-7) at 1e±3")

    # check_ozaki: the formation against an f64 einsum at a 1e±30 spread
    A, d, _ = _wide_inputs(512, seed=3, dev=dev, spread=30)
    ctx = kset.prepare(A)
    s, n_slices, cut = df64.ozaki_params(128)
    Mo = df64._ozaki_matmul(ctx.Woz, d, s=s, n_slices=n_slices, cut=cut)
    M_ref = torch.einsum("mn,bn,kn->mkb", A, d, A).reshape(64 * 64, 512)
    oz = float(((Mo - M_ref).abs() / M_ref.abs().amax(0, keepdim=True)).max())
    check(oz < 2.5e-13, f"Ozaki formation rel {oz:.2e} of the output scale")
    say("Ozaki contract", f"formation vs f64 einsum {oz:.2e} of the output scale (< 2.5e-13) "
        "at a 1e±30 spread")

    # times, in turns, at the wide path's shapes
    # times at the drain tiers' widths (tier 1: 1,024 lanes, tier 2: 256),
    # in turns, and the lane-group sweep
    out, sweeps = {}, {}
    for B in (1024, 256):
        A, d, R = _wide_inputs(B, seed=5, dev=dev)
        M_bl, reg = _formed64(A, d, 1e-12)
        L, dinv = df64._df_chol_bl_cuda(M_bl, reg)
        R1, R2 = R[:1].contiguous(), R.contiguous()
        t_chol = designs_in_turns(f"df_chol_bl at m=64, B={B}",
                                  lambda: df64._df_chol_bl_cuda(M_bl, reg),
                                  lambda: df64._df_chol_bl_cuda(M_bl, reg, design="stream"),
                                  lambda: df64._df_chol_bl_plain(M_bl, reg))
        t_solve = designs_in_turns(f"df_solve_bl k=1 at m=64, B={B}",
                                   lambda: df64._df_solve_bl_cuda(L, dinv, R1),
                                   lambda: df64._df_solve_bl_cuda(L, dinv, R1, design="stream"),
                                   lambda: df64._df_solve_bl_plain(L, dinv, R1))
        designs_in_turns(f"df_solve_bl k=2 at m=64, B={B}",
                         lambda: df64._df_solve_bl_cuda(L, dinv, R2),
                         lambda: df64._df_solve_bl_cuda(L, dinv, R2, design="stream"),
                         lambda: df64._df_solve_bl_plain(L, dinv, R2))
        sweeps[f"df_chol_bl m=64 B={B}"] = lane_sweep(
            f"df_chol_bl at m=64, B={B} (planned G="
            f"{bl.lane_plan('chol', 64, B, torch.float64).lanes})",
            lambda G: df64._df_chol_bl_cuda(M_bl, reg, design="smem", lanes=G), torch.float64)
        sweeps[f"df_solve_bl k=1 m=64 B={B}"] = lane_sweep(
            f"df_solve_bl k=1 at m=64, B={B} (planned G="
            f"{bl.lane_plan('solve', 64, B, torch.float64).lanes})",
            lambda G: df64._df_solve_bl_cuda(L, dinv, R1, design="smem", lanes=G), torch.float64)
        if B == 1024:
            out["df_chol_bl"] = {"err": errs["df_chol_bl"], **t_chol,
                                 **chol_bound(64, B, torch.float64), **library_chol(M_bl, reg)}
            out["df_solve_bl"] = {"err": errs["df_solve_bl"], **t_solve,
                                  **solve_bound(64, B, 1, torch.float64), **library_solve(L, R1)}
        else:
            out["df_chol_bl"]["tier2"] = {"B": B, **t_chol, **chol_bound(64, B, torch.float64),
                                          **library_chol(M_bl, reg)}
            out["df_solve_bl"]["tier2"] = {"B": B, **t_solve,
                                           **solve_bound(64, B, 1, torch.float64),
                                           **library_solve(L, R1)}
    for name in ("df_chol_bl", "df_solve_bl"):
        r = out[name]
        r["lane_sweep_ms"] = {k: v for k, v in sweeps.items() if k.startswith(name)}
        say("kernel bound", f"{name} at m=64, B=1024: {r['ms']:.4f} ms (streaming "
            f"{r['stream_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms ({r['bound_unit']}; "
            f"{r['bound_ms'] / r['ms']:.1%} of it), {r['library_call']} {r['library_ms']:.4f} ms "
            f"(+ permute {r['library_permute_ms']:.4f} ms); at B=256 {r['tier2']['ms']:.4f} ms "
            f"(streaming {r['tier2']['stream_ms']:.4f}, {r['library_call']} "
            f"{r['tier2']['library_ms']:.4f} ms)" + (
                f"; with the column-oriented forward pass: {COLUMN_ORDER_SOLVE_MS[name]} ms"
                if name in COLUMN_ORDER_SOLVE_MS else ""))

    s, n_slices, _ = df64.ozaki_mv_params(128)
    times = {}
    for B in (16384, 32768):
        X = torch.rand((128, B), dtype=torch.float64, device=dev) * 2 - 1
        Rh, Rl = df64._split_hi_lo(X)
        t = in_turns(f"slice_rounds_bl at (128, {B}), s={s}, n_slices={n_slices}",
                     lambda: df64._slice_rounds_bl_cuda(Rh, Rl, s, n_slices),
                     lambda: df64._slice_rounds_bl_plain(Rh, Rl, s, n_slices))
        times.setdefault("slice_rounds_bl", t)
    # slicing: the (hi, lo) pair read, n_slices f32 bands written; per slice
    # a scaling, a rounding, a scaling and the 9 f32 additions of the two-sum
    out["slice_rounds_bl"] = {
        "err": errs["slice_rounds_bl"], "ms": times["slice_rounds_bl"][0],
        "plain_ms": times["slice_rounds_bl"][1],
        **bound((8 + 4 * n_slices) * 128 * 16384, 12 * n_slices * 128 * 16384, torch.float32),
        **no_library("no single PyTorch call cuts the Ozaki slices")}
    return out


def _ozaki_operands(A64, bits: int | None = None, mv_bits: int | None = None) -> list:
    """The three shared-A Ozaki products on A (m, n) f64, as the kernel sets
    prepare them at these widths (None: the defaults): [(label, W (rows, k)
    f64, OzakiOperand, (s, n_slices, cut))] for the matvec, the transposed
    matvec and the normal-matrix formation."""
    m, n = A64.shape
    W = (A64[:, None, :] * A64[None, :, :]).reshape(m * m, n)
    out = []
    for label, Wx, params in (("mv", A64, df64.ozaki_mv_params(n, mv_bits)),
                              ("rmv", A64.T.contiguous(), df64.ozaki_mv_params(m, mv_bits)),
                              ("formation", W, df64.ozaki_params(n, bits))):
        s, n_slices, cut = params
        out.append((label, Wx, df64._ozaki_prepare(Wx, s=s, n_slices=n_slices, cut=cut), params))
    return out


def _ozaki_lanes(B: int, k: int, rng, dev) -> torch.Tensor:
    """d (B, k) f64 spread over 1e±30 (the solver caps d at 1e30); where B
    allows, lane 0 all zero (its max clamps to f32's tiny), lane 1 with an
    exact power of two as its max (the ceil(log2) edge) and lane 2 NaN."""
    d = 10.0 ** rng.uniform(-30, 30, size=(B, k))
    if B >= 3:
        d[0] = 0.0
        d[1] = rng.uniform(0.1, 1.0, k) * 2.0 ** 40
        d[1, k // 2] = 2.0 ** 40
        d[2, k // 3] = np.nan
    return torch.from_numpy(d).to(dev)


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> tuple[bool, float]:
    """(equal bit for bit with NaN in the same places, max |a − b| elsewhere)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False, float("nan")
    a0, b0 = torch.where(na, 0.0, a), torch.where(nb, 0.0, b)
    return (torch.equal(a0.view(torch.int64), b0.view(torch.int64)),
            float((a0 - b0).abs().max()) if a0.numel() else 0.0)


def _hold_ozaki_product(op, d, kw: dict, at: str) -> None:
    """ozaki_product_bl on (op, d) BITWISE against the split route and the
    plain version; the NaN lane 2 NaN in every row and nowhere else, the
    zero lane 0 (B >= 3)."""
    out_k = df64._ozaki_product_bl_cuda(op, d, kw["s"], kw["n_slices"], kw["cut"])
    out_s = df64._ozaki_matmul_split(op, d, **kw)
    out_p = df64._ozaki_matmul_plain(op, d, **kw)
    torch.cuda.synchronize()
    same_s, diff_s = _bitwise(out_k, out_s)
    same_p, diff_p = _bitwise(out_k, out_p)
    check(same_s, f"ozaki_product_bl vs the split route at {at}: not bitwise equal "
          f"(max abs diff {diff_s:.3e})")
    check(same_p, f"ozaki_product_bl vs its plain version at {at}: not bitwise "
          f"equal (max abs diff {diff_p:.3e})")
    if d.shape[0] >= 3:
        check(bool(torch.isnan(out_k[:, 2]).all()) and not bool(
            torch.isnan(out_k[:, :2]).any() or torch.isnan(out_k[:, 3:]).any()),
              f"ozaki_product_bl at {at}: the NaN lane is not exactly lane 2")
        check(not out_k[:, 0].any(), f"ozaki_product_bl at {at}: the zero lane is not 0")


def ozaki_bound(rows: int, k: int, B: int, n_slices: int, cut: int) -> dict:
    """ozaki_product_bl's least time: packed W, W's row scales and d read,
    the f64 output written; 2·rows·k·B tensor-core operations a pair (k,
    l) of the cut − 1 levels, on bf16 at its dense peak."""
    pairs = sum(len(ks) for _, ks in df64._group_levels(n_slices, cut))
    rows_pad = -(-rows // df64.OZAKI_ROW_PAD) * df64.OZAKI_ROW_PAD
    nbytes = n_slices * rows_pad * (-(-k // 16) * 16) * 2 + rows * 8 + B * k * 8 + rows * B * 8
    return {**bound(nbytes, pairs * 2 * rows * k * B, torch.bfloat16), "pairs": pairs}


def phase_ozaki_kernels(dev, smi: str) -> dict:
    """ozaki_product_bl at every shape the solver paths give it: the main
    cell's matvec (64×128), transposed matvec (128×64) and formation
    (4,096×128) at B = 1 … 16,384 (the formation to 1,024), and netlib's
    (m = 27/50/56, their m² formations) at B = 300 and 8,192.  Each is held
    BITWISE to the split route (slice_rounds_bl, f32 GEMMs, f64 sum) and to
    the plain version, NaN lane in place; then timed in turns against the
    split route, beside one torch.matmul of the f64 W and d (the library
    call for the same product) and its bound."""
    rng = np.random.default_rng(10)
    A_main = torch.from_numpy(rng.normal(size=(64, 128)) / np.sqrt(128)).to(dev)
    cases = [("main", A_main, OZAKI_WIDTHS)]
    for fx in ("afiro", "sc50a", "adlittle"):
        cases.append((fx, torch.from_numpy(_netlib_eq(fx)[1]).to(dev), OZAKI_NETLIB_WIDTHS))
    rows_out, held, main = [], [], None
    zero_counts()
    for src, A64, widths in cases:
        for label, Wx, op, (s, n_slices, cut) in _ozaki_operands(A64):
            rows, k = Wx.shape
            for B in widths:
                if label == "formation" and src == "main" and B > OZAKI_FORMATION_MAX_B:
                    continue
                d = _ozaki_lanes(B, k, rng, dev)
                kw = dict(s=s, n_slices=n_slices, cut=cut)
                at = f"{src} {label} {rows}x{k}, B={B}, (s, n_slices, cut)=({s}, {n_slices}, {cut})"
                _hold_ozaki_product(op, d, kw, at)
                held.append(at)
                t_k, t_s = in_turns(f"ozaki_product_bl vs the split route at {at}",
                                    lambda: df64._ozaki_product_bl_cuda(op, d, s, n_slices, cut),
                                    lambda: df64._ozaki_matmul_split(op, d, **kw))
                lib = time_ms(lambda: Wx @ d.T, 5)
                bd = ozaki_bound(rows, k, B, n_slices, cut)
                row = {"src": src, "use": label, "rows": rows, "n": k, "B": B, "s": s,
                       "n_slices": n_slices, "cut": cut, "ms": t_k, "split_ms": t_s,
                       "library_ms": lib, **bd}
                rows_out.append(row)
                if src == "main" and label == "formation" and B == OZAKI_FORMATION_MAX_B:
                    t_p = time_ms(lambda: df64._ozaki_matmul_plain(op, d, **kw), 5)
                    main = dict(row, plain_ms=t_p)
    counts = read_counts()
    check(counts["ozaki_product_bl"] > 0 and counts["ozaki_products"] == 0,
          f"ozaki kernels: launches {counts['ozaki_product_bl']}")
    say("ozaki kernels", f"ozaki_product_bl bitwise equal to the split route and to its plain "
        f"version at {len(held)} shapes (zero, power-of-two and NaN lanes at B >= 3) on {smi}")
    for r in rows_out:
        say("kernel bound", f"ozaki_product_bl {r['src']} {r['use']} {r['rows']}x{r['n']}, "
            f"B={r['B']}: {r['ms']:.4f} ms, split route {r['split_ms']:.4f} ms "
            f"({r['split_ms'] / r['ms']:.1f}x), torch.matmul f64 {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_unit']}; {r['bound_ms'] / r['ms']:.1%} of it; "
            f"{r['pairs']} pairs)")
    return {"ozaki_product_bl": {
        "err": 0.0, "ms": main["ms"], "plain_ms": main["plain_ms"], "split_ms": main["split_ms"],
        **{k_: main[k_] for k_ in ("bound_ms", "bound_by", "bound_unit", "bound_bytes",
                                   "bound_flops")},
        "library_ms": main["library_ms"], "library_permute_ms": None,
        "library_call": "torch.matmul (f64 W @ d.T)", "by_shape": rows_out, "held_at": held}}


# ---------------------------------------------------------------------------
# solver paths
# ---------------------------------------------------------------------------


def audit(lp, objective, lanes) -> dict:
    """scipy highs on the given lanes: {lane: relative objective error}.

    ``objective`` is in the standard (max cᵀx) form of ``lp``; the
    equality-form solve's objective is its negative."""
    from scipy.optimize import linprog

    A = np.asarray(lp.A, np.float64)
    n = A.shape[1]
    rels = {}
    for i in lanes:
        res = linprog(-np.asarray(lp.c[i], np.float64), A_ub=A,
                      b_ub=np.asarray(lp.b[i], np.float64),
                      bounds=[(0, None)] * n, method="highs")
        check(res.status == 0, f"scipy could not solve lane {i}: {res.message}")
        rels[int(i)] = abs(float(objective[i]) - (-res.fun)) / max(1.0, abs(res.fun))
    return rels


def _highs_objectives(job) -> list:
    """scipy highs on a group of lanes of one shared-A Vanderbei LP: ``job``
    is (A, b rows, c rows); returns max cᵀx of each lane (a pool worker)."""
    from scipy.optimize import linprog

    A, bs, cs = job
    funs = []
    for b, c in zip(bs, cs):
        res = linprog(-c, A_ub=A, b_ub=b, bounds=[(0, None)] * A.shape[1], method="highs")
        if res.status != 0:
            raise RuntimeError(f"scipy could not solve a lane: {res.message}")
        funs.append(-float(res.fun))
    return funs


def wide_audit(label: str, lp, objective, status, named: dict | None = None) -> dict:
    """scipy highs on WIDE_AUDIT_LANES evenly spaced lanes plus the
    non-OPTIMAL lanes (at most WIDE_AUDIT_STRAGGLERS, the cap reported), in
    a pool of AUDIT_WORKERS processes.  Prints max, mean, p99 and p99.9 of
    the relative objective error; each audited OPTIMAL lane must be within
    CONTRACT, a lane that ``named`` maps to a limit within that limit (it
    must be among the evenly spaced lanes); the non-OPTIMAL ones are
    reported."""
    named = named or {}
    N = len(objective)
    stragglers = np.flatnonzero(status != int(Status.OPTIMAL))
    taken = stragglers[:WIDE_AUDIT_STRAGGLERS]
    spaced = set(np.linspace(0, N - 1, WIDE_AUDIT_LANES, dtype=int).tolist())
    check(set(named) <= spaced, f"{label}: named lanes {sorted(set(named) - spaced)} not audited")
    lanes = np.array(sorted(spaced | set(taken.tolist())))
    A = np.asarray(lp.A, np.float64)
    b = np.asarray(lp.b[lanes], np.float64)
    c = np.asarray(lp.c[lanes], np.float64)
    groups = np.array_split(np.arange(len(lanes)), AUDIT_WORKERS)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(AUDIT_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        funs = np.concatenate([np.asarray(f, np.float64) for f in pool.map(
            _highs_objectives, [(A, b[g], c[g]) for g in groups])])
    secs = time.perf_counter() - t0
    rel = np.abs(np.asarray(objective, np.float64)[lanes] - funs) / np.maximum(1.0, np.abs(funs))
    opt = status[lanes] == int(Status.OPTIMAL)
    stats = {"lanes": int(len(lanes)), "optimal_lanes": int(opt.sum()),
             "non_optimal": int(len(stragglers)), "non_optimal_audited": int(len(taken)),
             "cap": WIDE_AUDIT_STRAGGLERS}
    for name, sel in (("optimal", opt), ("non_optimal", ~opt)):
        r = rel[sel]
        if len(r):
            stats[name] = {"max": float(r.max()), "mean": float(r.mean()),
                           "p99": float(np.percentile(r, 99)), "p99.9": float(np.percentile(r, 99.9)),
                           "worst_lane": int(lanes[sel][np.argmax(r)])}
    o = stats["optimal"]
    limit = np.array([named.get(int(i), CONTRACT) for i in lanes])
    over = {int(i): float(e) for i, e in zip(lanes[opt], rel[opt]) if e > CONTRACT}
    stats["optimal_over_contract"] = over
    say(f"{label} wide audit", f"scipy highs on {len(lanes)} lanes ({WIDE_AUDIT_LANES} evenly "
        f"spaced + {len(taken)} of {len(stragglers)} non-OPTIMAL, cap {WIDE_AUDIT_STRAGGLERS}) in "
        f"{secs:.1f}s on {AUDIT_WORKERS} processes: {o['max']:.4e} max (lane {o['worst_lane']}), "
        f"mean {o['mean']:.3e}, p99 {o['p99']:.3e}, p99.9 {o['p99.9']:.3e} relative objective error "
        f"on {int(opt.sum())} OPTIMAL lanes (limit {CONTRACT} each; named lanes {named}); OPTIMAL "
        f"lanes above {CONTRACT}: {len(over)} {over}"
        + (f"; non-OPTIMAL (reported, not bounded): max {stats['non_optimal']['max']:.3e}, mean "
           f"{stats['non_optimal']['mean']:.3e}" if (~opt).any() else ""))
    bad = {int(i): float(e) for i, e, lim in zip(lanes[opt], rel[opt], limit[opt])
           if not e <= lim}
    check(not bad, f"{label}: OPTIMAL lanes above their limit in the wide audit: {bad}")
    return stats


def off_grid_audit(label: str, lp, objective, status, named: dict | None = None) -> dict:
    """scipy highs, beyond :func:`wide_audit`'s grid: the ``named`` lanes
    off the grid, every non-OPTIMAL lane off the grid (no cap), then the
    first OFF_GRID_LANES of a seeded random permutation of the rest, in
    batches of OFF_GRID_BATCH on AUDIT_WORKERS processes; no batch is taken
    after OFF_GRID_CEILING_S of pool wall (the batches in flight then
    finish).  Prints the lanes audited, max, p99 and p99.9 of the relative
    objective error on the OPTIMAL ones, and every OPTIMAL lane above
    CONTRACT; each OPTIMAL lane must be within CONTRACT, a named one within
    its own limit."""
    named = named or {}
    N = len(objective)
    grid = np.zeros(N, bool)
    grid[np.linspace(0, N - 1, WIDE_AUDIT_LANES, dtype=int)] = True
    first = [i for i in sorted(named) if not grid[i]]
    first += [int(i) for i in np.flatnonzero((status != int(Status.OPTIMAL)) & ~grid)
              if int(i) not in named]
    taken = np.zeros(N, bool)
    taken[first] = True
    perm = np.random.default_rng(OFF_GRID_SEED).permutation(N)
    queue = np.concatenate([np.asarray(first, dtype=np.int64),
                            perm[~grid[perm] & ~taken[perm]][:OFF_GRID_LANES]])
    batches = (queue[i:i + OFF_GRID_BATCH] for i in range(0, len(queue), OFF_GRID_BATCH))
    A = np.asarray(lp.A, np.float64)
    lanes, funs = [], []
    t0 = time.perf_counter()
    with ProcessPoolExecutor(AUDIT_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = {}
        while True:
            # two batches a worker in flight, until the budget is spent
            while len(pending) < 2 * AUDIT_WORKERS and time.perf_counter() - t0 < OFF_GRID_CEILING_S:
                batch = next(batches, None)
                if batch is None:
                    break
                job = (A, np.asarray(lp.b[batch], np.float64), np.asarray(lp.c[batch], np.float64))
                pending[pool.submit(_highs_objectives, job)] = batch
            if not pending:
                break
            done = next(as_completed(pending))
            lanes.append(pending.pop(done))
            funs.append(np.asarray(done.result(), np.float64))
    secs = time.perf_counter() - t0
    lanes, funs = np.concatenate(lanes), np.concatenate(funs)
    check(set(first) <= set(lanes.tolist()), f"{label}: named or non-OPTIMAL lanes left unaudited")
    rel = np.abs(np.asarray(objective, np.float64)[lanes] - funs) / np.maximum(1.0, np.abs(funs))
    opt = status[lanes] == int(Status.OPTIMAL)
    r = rel[opt]
    over = {int(i): float(e) for i, e in sorted(zip(lanes[opt], r), key=lambda x: -x[1])
            if e > CONTRACT}
    stats = {"lanes": int(len(lanes)), "optimal_lanes": int(opt.sum()),
             "non_optimal": int((~opt).sum()), "seconds": secs, "share": len(lanes) / N,
             "max": float(r.max()), "p99": float(np.percentile(r, 99)),
             "p99.9": float(np.percentile(r, 99.9)), "optimal_over_contract": over}
    say(f"{label} off-grid audit", f"scipy highs on {len(lanes)} lanes off the "
        f"{WIDE_AUDIT_LANES}-lane grid ({len(lanes) / N:.2%} of {N}; {len(first)} named or "
        f"non-OPTIMAL first, then {len(lanes) - len(first)} of a random sample of "
        f"{OFF_GRID_LANES}, seed {OFF_GRID_SEED}) in {secs:.1f}s of pool wall on {AUDIT_WORKERS} "
        f"processes (ceiling {OFF_GRID_CEILING_S:.0f}s): {stats['max']:.4e} "
        f"max, p99 {stats['p99']:.3e}, p99.9 {stats['p99.9']:.3e} relative objective error on "
        f"{int(opt.sum())} OPTIMAL lanes (limit {CONTRACT} each; named lanes {named}); OPTIMAL "
        f"lanes above {CONTRACT}: {len(over)} {over}"
        + (f"; non-OPTIMAL (reported, not bounded): " + ", ".join(
            f"{int(i)} {Status(int(status[i])).name} {e:.2e}"
            for i, e in zip(lanes[~opt], rel[~opt])) if (~opt).any() else ""))
    bad = {i: e for i, e in over.items() if not e <= named.get(i, CONTRACT)}
    check(not bad, f"{label}: OPTIMAL lanes above their limit in the off-grid audit: {bad}")
    return stats


def status_mix(status) -> dict:
    uniq, counts = np.unique(status, return_counts=True)
    return {Status(int(u)).name: int(c) for u, c in zip(uniq, counts)}


def phase_lanemv_kernels(dev) -> dict:
    """The lane matvec (``csrc/lanemv.cu``) for per-instance A: each mode
    against its plain version (the einsum route) within 2·k·ε of Σ|A||x|
    (k the contraction length) at the padded netlib shape and a ragged one,
    the normal product bitwise the unfused launches, then each mode timed
    in turns at the padded shape beside its bound (A read once from HBM)."""
    out = {}
    g = torch.Generator(device=dev).manual_seed(18)
    for B, m, n in ((24576, 56, 153), (300, 27, 32)):
        for dt in (torch.float32, torch.float64):
            A = torch.randn(B, m, n, device=dev, dtype=dt, generator=g)
            x = torch.randn(B, n, device=dev, dtype=dt, generator=g)
            v = torch.randn(B, m, device=dev, dtype=dt, generator=g)
            d = torch.rand(B, n, device=dev, dtype=dt, generator=g) * 10
            reg = torch.rand(B, device=dev, dtype=dt, generator=g) * 1e-3
            eps = torch.finfo(dt).eps
            absA = A.abs()
            pairs = {
                "mv": (lambda: lanemv.lane_mv(A, x), lambda: lanemv._lane_mv_plain(A, x),
                       lanemv._lane_mv_plain(absA, x.abs()) * 2 * n * eps),
                "rmv": (lambda: lanemv.lane_rmv(A, v), lambda: lanemv._lane_rmv_plain(A, v),
                        lanemv._lane_rmv_plain(absA, v.abs()) * 2 * m * eps),
                "normal": (lambda: lanemv.lane_normal(A, d, v, reg),
                           lambda: lanemv._lane_normal_plain(A, d, v, reg),
                           (lanemv._lane_mv_plain(absA, d * lanemv._lane_rmv_plain(absA, v.abs()))
                            + reg[:, None] * v.abs()) * 2 * (m + n + 2) * eps),
            }
            split = lanemv.lane_mv(A, d * lanemv.lane_rmv(A, v)) + reg[:, None] * v
            check(torch.equal(lanemv.lane_normal(A, d, v, reg), split),
                  f"lane_normal {dt} {m}x{n}: not bitwise the unfused launches")
            bound = B * m * n * dt.itemsize / HBM_BYTES_PER_S * 1e3
            for mode, (kern, plain, tol) in pairs.items():
                err = (kern() - plain()).abs()
                check(bool((err <= tol).all()), f"lane {mode} {dt} {m}x{n}: outside 2·k·ε·Σ|A||x|")
                if B < 24576:
                    continue
                ms, plain_ms = in_turns(f"lane {mode}", kern, plain)
                key = f"lane_{mode}_{str(dt)[6:]}"
                out[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                            "share": bound / ms, "max_err_over_tol": float((err / tol).max())}
                say("kernel bound", f"{key} at B={B}, {m}x{n}: {ms:.4f} ms, bound {bound:.4f} ms "
                    f"(HBM, A once; {100 * bound / ms:.1f}%), plain (einsum) {plain_ms:.4f} ms")
            del A, x, v, d, reg, absA, pairs, split
    return out


def phase_narrow_path(smi: str) -> dict:
    lp = random_standard_lp(M, N, nlp=N_LP, seed=3, dtype=np.float32)
    solver = get_solver("hsd_pallas", device="cuda", **SOLVER_KW)
    solver.init(lp)
    n_chunks = -(-N_LP // SOLVER_KW["chunk"])

    zero_counts()
    t0 = time.perf_counter()
    sol = solver.solve()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    steps, off = counts["host_steps"], counts["gated_off"]
    chol, solves = counts["chol_bl"], counts["solve_bl"]
    check_smem_route("narrow path", counts)
    say("narrow path", f"first solve {first_s:.3f}s; launches {counts}; "
        f"iterations={steps}, gated off={off}, Mehrotra starts={n_chunks}")
    check(chol > 0 and solves > 0, "a kernel of the narrow path was never launched")
    # a gated-off iteration launches what a running one does
    check(chol == steps + off + n_chunks,
          f"chol_bl launches {chol} != iterations {steps} + gated off {off} + Mehrotra starts "
          f"{n_chunks}")
    # per iteration: the joint k=2 solve, the corrector, 3 KKT sweeps
    check(solves == 5 * (steps + off) + n_chunks,
          f"solve_bl launches {solves} != 5 x ({steps} + {off}) + {n_chunks}")

    status = np.asarray(sol.status)
    check(sol.x.shape == (N_LP, N) and sol.objective.shape == (N_LP,), "solution shapes")
    ok = np.isin(status, (int(Status.OPTIMAL), int(Status.STALLED)))
    check(np.isfinite(sol.objective[ok]).all() and np.isfinite(sol.x[ok]).all(),
          "non-finite answer on an OPTIMAL/STALLED lane")
    it = np.asarray(sol.iterations)
    say("narrow path", f"status mix {status_mix(status)}; OPTIMAL+STALLED {ok.mean():.4%}; "
        f"iterations min/mean/max {it.min()}/{it.mean():.2f}/{it.max()}, p50/p90/p99 "
        f"{'/'.join(str(int(v)) for v in np.percentile(it, [50, 90, 99]))}")
    check(ok.mean() >= OK_SHARE, f"OPTIMAL+STALLED share {ok.mean():.4f} < {OK_SHARE}")
    n_limit = int((status == int(Status.ITERATION_LIMIT)).sum())
    lo, hi = NARROW_LIMIT_BAND
    say("narrow path", f"ITERATION_LIMIT {n_limit} (band {lo}-{hi} around the JAX reference's "
        f"{REF_NARROW_LIMIT})")
    check(lo <= n_limit <= hi, f"narrow ITERATION_LIMIT {n_limit} outside [{lo}, {hi}] (the JAX "
          f"reference: {REF_NARROW_LIMIT})")

    stragglers = np.flatnonzero(status != int(Status.OPTIMAL))[:64]
    lanes = sorted(set(np.linspace(0, N_LP - 1, 64, dtype=int).tolist()) | set(stragglers.tolist()))
    rels = audit(lp, sol.objective, lanes)
    worst_lane = max(rels, key=rels.get)
    worst = rels[worst_lane]
    say("narrow audit", f"scipy highs on {len(rels)} lanes (incl. {len(stragglers)} non-OPTIMAL): "
        f"max relative objective error {worst:.4e} at lane {worst_lane} "
        f"({Status(int(status[worst_lane])).name}), median {np.median(list(rels.values())):.2e} "
        f"(limit {AUDIT_MAX})")
    check(worst <= AUDIT_MAX, f"audit max {worst:.3e} > {AUDIT_MAX}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol2 = solver.solve()
    wall = time.perf_counter() - t0
    same = float((np.asarray(sol2.status) == status).mean())
    say("narrow path", f"second solve {wall:.3f}s = {N_LP / wall:.1f} LP/s "
        f"({N_LP} LPs of {M}x{N}, narrow f32; status agreement with the first solve "
        f"{same:.4%}) on {smi}")
    return counts, status


def phase_narrow_mix(smi: str, default_status) -> dict:
    """The narrow cell's status mix beside the default run's: (1) with the
    factor on the lane-group design and every f32 solve forced to the
    streaming design (left-looking forward pass, one thread a lane and
    right-hand side), which shows whether the solve's loop order moves the
    cell's ITERATION_LIMIT count; the design is forced by wrapping the
    private wrapper for this run only; (2) on the fused-form set and (3)
    on the fuse_facsol set, whose fused kernels must all run the lane-group
    design."""
    lp = random_standard_lp(M, N, nlp=N_LP, seed=3, dtype=np.float32)
    solver = get_solver("hsd_pallas", device="cuda", **SOLVER_KW)
    solver.init(lp)
    solve_cuda = bl._solve_bl_cuda

    def streaming_solve(L, dinv, R, design=None, lanes=None):
        return solve_cuda(L, dinv, R, design="stream")

    limit = int(Status.ITERATION_LIMIT)
    mixes = {"default": status_mix(default_status),
             "default_iteration_limit": int((default_status == limit).sum())}
    for label, kset in (("streaming_solve", bl.BATCHLAST_KERNELS),
                        ("fused_form", bl.BATCHLAST_FUSED_KERNELS),
                        ("facsol", bl.BatchLastKernels(fuse_facsol=True))):
        solver.kernels = kset
        if label == "streaming_solve":
            # cached graphs replay the design they captured: drop them
            # around the forced design
            _loop._clear_graphs()
            bl._solve_bl_cuda = streaming_solve
        try:
            zero_counts()
            status = np.asarray(solver.solve().status)
            counts = read_counts()
        finally:
            bl._solve_bl_cuda = solve_cuda
            if label == "streaming_solve":
                _loop._clear_graphs()
        if label == "streaming_solve":
            check(counts["solve_bl"] > 0 and counts["solve_bl_smem"] == 0,
                  f"streaming-solve run: solve_bl {counts['solve_bl']}, {counts['solve_bl_smem']} "
                  "of them on the lane-group design")
            check(counts["chol_bl_smem"] == counts["chol_bl"] > 0,
                  "streaming-solve run: the factor left the lane-group design")
        else:
            check_smem_route(f"narrow cell on {kset.name}", counts)
        mixes[label] = status_mix(status)
        mixes[f"{label}_iteration_limit"] = int((status == limit).sum())
        mixes[f"{label}_agreement"] = float((status == default_status).mean())
        say("narrow mix", f"{label} ({kset.name}): {mixes[label]}, ITERATION_LIMIT "
            f"{mixes[label + '_iteration_limit']}; status agreement with the default run "
            f"{mixes[label + '_agreement']:.4%}; launches {counts}")
    say("narrow mix", f"default: {mixes['default']}, ITERATION_LIMIT "
        f"{mixes['default_iteration_limit']}; the solve forced to the streaming (left-looking) "
        f"design: ITERATION_LIMIT {mixes['streaming_solve_iteration_limit']}; JAX reference on "
        f"the CPU: {REF_NARROW_LIMIT}; on {smi}")
    return mixes


def _probe_solve(name: str, seed: int, opts: SolverOptions, kset=bl.BATCHLAST_KERNELS):
    """One 256-lane probe solve through hsd_solve_batched on ``kset``, its
    launches checked for the lane-group route.  Returns the LPs, statuses,
    objectives, seconds, launch counts and ρ_p."""
    lp = random_standard_lp(64, 64, nlp=256, seed=seed, dtype=np.float32)
    eq = lp.to_equality_form()
    zero_counts()
    t0 = time.perf_counter()
    out = hsd_mod.hsd_solve_batched(
        np.asarray(eq.A, np.float32), np.asarray(eq.b, np.float32), np.asarray(eq.c, np.float32),
        opts, kset, device="cuda",
    )
    st = out["status"].cpu().numpy()
    obj = -out["objective"].cpu().numpy()  # the equality form minimises −cᵀx
    secs = time.perf_counter() - t0
    counts = read_counts()
    check_smem_route(name, counts)
    return lp, st, obj, secs, counts, out["rho_p"].cpu().numpy()


def _probe(name: str, seed: int, opts: SolverOptions) -> dict:
    """tests_tpu/smoke.py's 256-lane probes through hsd_solve_batched.
    Returns the launch counts, statuses, objectives and ρ_p."""
    lp, st, obj, secs, counts, rho_p = _probe_solve(name, seed, opts)
    B = len(st)
    rels = audit(lp, obj, np.linspace(0, B - 1, 64, dtype=int))
    worst = max(rels.values())
    say(name, f"{secs:.3f}s; status mix {status_mix(st)}; launches {counts}; host-loop "
        f"iterations {hsd_mod.HOST_STEPS}; audit of 64 lanes max {worst:.3e}, "
        f"mean {np.mean(list(rels.values())):.2e}; worst rho_p {rho_p.max():.3e}")
    check((st == int(Status.OPTIMAL)).mean() >= PROBE_OPTIMAL,
          f"{name}: only {(st == 0).sum()}/{B} OPTIMAL")
    check(worst <= CONTRACT, f"{name}: audit max {worst:.3e} > {CONTRACT}")
    return {"counts": counts, "status": st, "objective": obj, "rho_p": rho_p,
            "audit_max": worst}


def _fastform_probe(opts: SolverOptions) -> None:
    """The reference's recorded negative result: the df64 probe with the
    wide IPM factoring on the fast formation.  Its status mix is reported
    beside the reference's, not bounded; the FP64 factor must run."""
    name = "df64 fastform probe"
    _, st, _, secs, counts, _ = _probe_solve(name, 3, opts)
    check(counts["df_chol_bl"] > 0, f"{name}: df_chol_bl was never launched")
    say(name, f"{secs:.3f}s; status mix {status_mix(st)} of {len(st)} lanes; launches {counts}; "
        f"host-loop iterations {hsd_mod.HOST_STEPS}; the reference recorded "
        f"{REF_FASTFORM_NUMERICAL}")
    _fastform_factor()


PROBE_COMMON = dict(maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05,
                    refine_steps=0, init_point="mehrotra", finish_dtype="float64",
                    switch_tol=1e-5, finish_maxiter=20)
DF64_PROBE_OPTIONS = dict(tol=1e-6, finish_kset="df64", **PROBE_COMMON)


def phase_probes() -> dict:
    """The three probes; returns the df64 probe's run (:func:`_probe`)."""
    common = PROBE_COMMON
    # check_probe: the wide IPM finish factors on the df64 set every iteration
    df64_probe = _probe("df64 probe", 3, SolverOptions(**DF64_PROBE_OPTIONS))
    counts = df64_probe["counts"]
    check(counts["df_chol_bl"] > 0 and counts["df_solve_bl"] > 0,
          "df64 probe: df_chol_bl / df_solve_bl were never launched")
    # check_crossover_mixed: the mixed-engine crossover finish
    _probe("crossover probe", 5, SolverOptions(
        tol=2e-7, kkt_refine=2, finish_mode="crossover", crossover_kset="mixed",
        crossover_repair=2, **common))
    _fastform_probe(SolverOptions(tol=1e-6, finish_kset="df64_fastform", **common))
    return df64_probe


def _fastform_factor() -> None:
    """The fastform set's factor at m = 64, B = 256, every d in f32's range:
    its df_chol_bl launch against the plain version on the same fast-formed
    M (FP64 bound), and against the plain factor of the f64-formed M (the
    f32-level FASTFORM_RTOL: the fast formation accumulates in f32)."""
    B = 256
    A, d, _ = _inputs(B, seed=8, dev=CARD)
    A, d = A.double(), d.double() * 10.0 ** torch.linspace(-3, 3, B, device=CARD,
                                                             dtype=torch.float64)[:, None]
    fast = df64.DF64_FASTFORM_KERNELS
    m = A.shape[0]
    with hsd_mod._full_precision_matmuls():
        ctx = fast.prepare(A)
        fac = fast.factor(ctx, d, 1e-12)
        dh, dl = df64._split_hi_lo(d.T)
        M = ((ctx.Wh @ dh).double() + (ctx.Wh @ dl + ctx.Wl @ dh).double()).reshape(m, m, B)
    reg = fac.reg.to(torch.float32).to(torch.float64)
    L_plain, _ = df64._df_chol_bl_plain(M, reg)
    L64, _ = df64._df_chol_bl_plain((ctx.W @ d.T).reshape(m, m, B).contiguous(), reg)
    low = torch.tril(torch.ones(m, m, dtype=torch.bool, device=CARD))[..., None]
    L, L_plain, L64 = (torch.where(low, x, 0.0) for x in (fac.L, L_plain, L64))
    rel_plain, rel_64 = rel_err(L, L_plain), rel_err(L, L64)
    say("df64 fastform probe", f"factor m={m}, n={A.shape[1]}, B={B}, d within 1e-3..1e3: "
        f"df_chol_bl vs plain on the fast-formed M rel {rel_plain:.3e} (limit {F64_RTOL}); vs the "
        f"plain factor of the f64-formed M rel {rel_64:.3e} (limit {FASTFORM_RTOL})")
    check(rel_plain <= F64_RTOL, f"fastform factor vs plain rel {rel_plain:.3e}")
    check(rel_64 <= FASTFORM_RTOL, f"fastform factor vs the f64-formed factor rel {rel_64:.3e}")


def _bench_problem(nlp: int, m: int = M, n: int = N, dev=CARD):
    """bench.py's LPs (seed 3) as the equality form: the StandardLP for the
    audit, A on the host, b and c staged on the card (``dev``) once."""
    lp = random_standard_lp(m, n, nlp=nlp, seed=3, dtype=np.float32)
    eq = lp.to_equality_form()
    b = torch.from_numpy(np.asarray(eq.b, np.float32)).to(dev)
    c = torch.from_numpy(np.asarray(eq.c, np.float32)).to(dev)
    return lp, np.asarray(eq.A, np.float32), b, c


def _optimal_share(label: str, obj, status) -> None:
    """The main path's status bound: OPTIMAL share, finite objectives."""
    opt = status == int(Status.OPTIMAL)
    check(np.isfinite(obj[opt]).all(), f"{label}: non-finite objective on an OPTIMAL lane")
    check(opt.mean() >= MAIN_OPTIMAL, f"{label}: OPTIMAL share {opt.mean():.4f} < {MAIN_OPTIMAL}")


def _audit_main(label: str, lp, obj, status) -> None:
    """The main path's bounds: OPTIMAL share and the 64-lane audit."""
    _optimal_share(label, obj, status)
    opt = status == int(Status.OPTIMAL)
    rels = audit(lp, obj, np.linspace(0, len(obj) - 1, 64, dtype=int))
    worst_lane = max(rels, key=rels.get)
    say(f"{label} audit", f"scipy highs on 64 evenly spaced lanes: max relative objective "
        f"error {rels[worst_lane]:.4e} at lane {worst_lane}, median "
        f"{np.median(list(rels.values())):.2e} (limit {CONTRACT} per lane)")
    check(rels[worst_lane] <= CONTRACT, f"{label}: audit max {rels[worst_lane]:.3e} > {CONTRACT}")
    stragglers = np.flatnonzero(~opt)[:64]
    if len(stragglers):
        srels = audit(lp, obj, stragglers)
        say(f"{label} audit", f"{len(stragglers)} non-OPTIMAL lanes (reported, not bounded): "
            + ", ".join(f"{i} {Status(int(status[i])).name} {e:.2e}" for i, e in srels.items()))


def _scan_path(smi: str, kset, label: str, reps: tuple, ref_status=None, m: int = M,
               n: int = N) -> dict:
    """bench.py's default configuration (65,536 m×n LPs, ``hsd_solve_scan``,
    f64 crossover finish) on ``kset``: a first solve with a sync between
    the stages, then ``reps`` more solves, timed.  Returns the launch
    counts of the first solve (``total``) and at the hand-over from the
    narrow stage to the finish (``narrow``), its statuses and objectives,
    and the LPs, for the caller's audit."""
    lp, A, b, c = _bench_problem(N_LP, m, n)
    opts = SolverOptions(**BENCH_OPTIONS)

    zero_counts()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), narrow_stage_counts() as narrow:
        out = hsd_mod.hsd_solve_scan(A, b, c, opts, kset, device="cuda", stage_sync=True,
                                     **SCAN_KW)
    status = out["status"].cpu().numpy()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    check_smem_route(label, counts)
    say(label, f"{kset.name}: first solve (stage_sync) {first_s:.3f}s; launches {counts}; "
        f"at the narrow stage's end {narrow}")
    for ln in err.getvalue().splitlines():
        say(label, ln)

    obj = -out["objective"].cpu().numpy()  # the equality form minimises −cᵀx
    it = out["iterations"].cpu().numpy()
    check(obj.shape == (N_LP,) and status.shape == (N_LP,), f"{label}: solution shapes")
    opt = status == int(Status.OPTIMAL)
    say(label, f"status mix {status_mix(status)}; OPTIMAL {opt.mean():.4%}; iterations "
        f"p50/p90/p99 {'/'.join(str(int(v)) for v in np.percentile(it, [50, 90, 99]))}, "
        f"max {it.max()}")

    for rep in reps:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out2 = hsd_mod.hsd_solve_scan(A, b, c, opts, kset, device="cuda", **SCAN_KW)
        status2 = out2["status"].cpu().numpy()
        wall = time.perf_counter() - t0
        check(_loop.GRAPH_CAPTURES == 0, f"{label}: the {rep} solve captured "
              f"{_loop.GRAPH_CAPTURES} graphs")
        vs = "" if ref_status is None else (
            f"; status agreement with the default set's main path "
            f"{(status2 == ref_status).mean():.4%}")
        say(label, f"{rep} solve {wall:.3f}s = {N_LP / wall:.1f} LP/s ({N_LP} LPs of "
            f"{m}x{n}, f32 bulk + f64 crossover finish; status agreement with the first solve "
            f"{(status2 == status).mean():.4%}{vs}) on {smi}")
    return {"total": counts, "narrow": narrow, "status": status, "objective": obj, "lp": lp}


def phase_main_path(smi: str) -> dict:
    run = _scan_path(smi, bl.BATCHLAST_KERNELS, "main path", ("second", "third"))
    _optimal_share("main path", run["objective"], run["status"])
    wide_audit("main path", run["lp"], run["objective"], run["status"])
    for name in ("chol_bl", "solve_bl", "ozaki_product_bl"):
        check(run["total"][name] > 0, f"{name} was never launched on the main path")
    return run


def _kernel_group(name: str) -> str:
    """A short name for a device kernel: this repository's kernels by their
    function name, the library's by what they do."""
    for ours in ("fused_factor_bl_smem_kernel", "facsol_bl_smem_kernel", "chol_bl_smem_kernel",
                 "solve_bl_smem_kernel", "chol_bl_kernel",
                 "solve_bl_kernel", "slice_rounds_kernel", "ozaki_product_kernel",
                 "fused_factor_bl_kernel", "facsol_bl_kernel"):
        if ours in name:  # the FP64 instantiations of the batch-last templates apart
            return ours + ("<double>" if "double" in name and "ozaki" not in ours else "")
    low = name.lower()
    for kind in ("gemm", "gemv", "reduce", "elementwise", "copy", "scan", "sort", "index"):
        if kind in low:
            return kind
    return "other"


def _profiled_solve(route: str, A, b, c, opts, loop: str = "graph") -> tuple:
    """One main-cell solve under torch.profiler (stage_sync, the finish
    marked), on the kernel route or, ``route="split"``, with every Ozaki
    product on the split route, on the route ``loop`` of ``loop_route``
    (graph, loops or host).  Returns (profiler, output, launch
    counts, the Ozaki products' (rows, n, B, levels) and the slicing
    launches' (r, B, n_slices), each in launch order: on the host loop,
    one entry a launch)."""
    finish_core = hsd_mod._hsd_scan_finish_core
    slice_cuda = df64._slice_rounds_bl_cuda
    slice_shapes = []

    def marked(*args, **kwargs):
        with torch.profiler.record_function("finish stage"):
            return finish_core(*args, **kwargs)

    def slice_logged(Rh, Rl, s, n_slices):
        if Rh.numel():
            slice_shapes.append((Rh.shape[0], Rh.shape[1], n_slices))
        return slice_cuda(Rh, Rl, s, n_slices)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    hsd_mod._hsd_scan_finish_core = marked
    df64._slice_rounds_bl_cuda = slice_logged
    _PRODUCT_SHAPES.update(on=True, shapes=[])
    zero_counts()
    try:
        with split_ozaki_route() if route == "split" else contextlib.nullcontext(), \
                loop_route(loop):
            torch.cuda.synchronize()
            with contextlib.redirect_stderr(io.StringIO()), \
                    torch.profiler.profile(activities=acts, record_shapes=True) as prof:
                out = hsd_mod.hsd_solve_scan(A, b, c, opts, bl.BATCHLAST_KERNELS, device="cuda",
                                             stage_sync=True, **SCAN_KW)
                out["status"].cpu()
    finally:
        hsd_mod._hsd_scan_finish_core = finish_core
        df64._slice_rounds_bl_cuda = slice_cuda
        _PRODUCT_SHAPES["on"] = False
    return prof, out, read_counts(), list(_PRODUCT_SHAPES["shapes"]), slice_shapes


# the host ranges the profiled solves mark (record_function), mirrored on the
# device timeline: the finish, the predicate reads and the graph replays
ANNOTATIONS = ("finish stage", "predicate read", "loop replay", "segment replay")


def _device_kernels(events) -> list:
    """The device kernels of a trace, by start: copies and fills run on the
    copy engines, not the SMs, and the host's annotations are mirrored on
    the device timeline."""
    return sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset")) and e.name not in ANNOTATIONS),
                  key=lambda e: e.time_range.start)


def _stages(prof, smi: str, label: str) -> tuple[dict, list]:
    """Device time by kernel, launches and busy share of the narrow stage
    and of the finish; returns (stages, the kernel events in time order)."""
    events = prof.events()
    finish_at = min(e.time_range.start for e in events if e.name == "finish stage")
    kernels = _device_kernels(events)
    check(len(kernels) > 0, "the profiler saw no device kernel")
    stages = {}
    for stage, sel in (("narrow", lambda e: e.time_range.start < finish_at),
                       ("finish", lambda e: e.time_range.start >= finish_at)):
        ks = [e for e in kernels if sel(e)]
        # busy: the union of the kernels' intervals (they may overlap)
        busy_us, reach = 0.0, float("-inf")
        for e in ks:
            start, end = max(e.time_range.start, reach), e.time_range.end
            busy_us += max(0.0, end - start)
            reach = max(reach, end)
        busy = busy_us / 1e3
        span = (reach - ks[0].time_range.start) / 1e3
        by = {}
        for e in ks:
            g = by.setdefault(_kernel_group(e.name), [0.0, 0])
            g[0] += e.time_range.elapsed_us() / 1e3
            g[1] += 1
        top = sorted(by.items(), key=lambda kv: -kv[1][0])
        others = sorted({e.name[:60] for e in ks if _kernel_group(e.name) == "other"})[:3]
        stages[stage] = {"device_ms": busy, "span_ms": span, "idle": 1 - busy / span,
                         "launches": len(ks),
                         "by_kernel_ms": {k: round(v[0], 3) for k, v in top},
                         "by_kernel_launches": {k: v[1] for k, v in top}}
        say("profile", f"{label} {stage} stage: device busy {busy:.1f} of {span:.1f} ms "
            f"(idle {1 - busy / span:.1%}), {len(ks)} kernels; " + ", ".join(
                f"{k} {v[0]:.1f} ms/{v[1]}" for k, v in top[:9]) + f"; 'other' is e.g. {others}"
            f" on {smi}")
    return stages, kernels


# the runtime calls that launch device kernels: one graph launch, or one kernel
GRAPH_LAUNCH = "cudaGraphLaunch"
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
# the host and device clocks of a trace agree to within microseconds: a kernel
# that starts this long before the call of its correlation id was not launched
# by it
CLOCK_SKEW_US = 1000.0


def _intervals(events, name: str) -> list:
    """The host ranges of the record_function ``name``, by start."""
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == name and e.device_type == torch.autograd.DeviceType.CPU)


def _overlap(lo: float, hi: float, ranges: list) -> float:
    """The length of [lo, hi] that the (sorted, disjoint) ``ranges`` cover."""
    return sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in ranges if a < hi and b > lo)


def _enclosing(t: float, ranges: list, names: list) -> str | None:
    for (a, b), name in zip(ranges, names):
        if a <= t <= b:
            return name
    return None


def _span_split(prof, smi: str, label: str) -> dict:
    """Each stage's span on the device (first kernel's start to last
    kernel's end) split into busy time by what launched the kernel (an
    eager launch, a replay of a stage segment's graph, a replay of an IPM
    loop block's graph) and idle time by where the gap lies: between two
    kernels of one graph replay (its nodes' gaps), under a predicate read
    of the host (``_loop._host_read``), or elsewhere (the host dispatching
    eager launches and graph replays).  A kernel is matched to its launch
    by the profiler's correlation id; a graph launch to the replay range
    (``_loop._replay``'s record_function) that encloses it."""
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    # a solve with no finish mark (hsd_solve_batched) is one stage, "solve"
    marks = [e.time_range.start for e in events if e.name == "finish stage"]
    finish_at = min(marks) if marks else None
    stage_sel = ((("narrow", lambda t: t < finish_at), ("finish", lambda t: t >= finish_at))
                 if marks else (("solve", lambda t: True),))
    reads = _intervals(events, "predicate read")
    rep = sorted([(r, "segment") for r in _intervals(events, "segment replay")]
                 + [(r, "loop") for r in _intervals(events, "loop replay")])
    rep_ranges, rep_names = [r for r, _ in rep], [n for _, n in rep]
    launch = {}  # correlation id -> (what launched it, the call's host start)
    graph_calls = {}  # correlation id of a graph launch -> (its host start, its host duration)
    for e in events:
        if e.device_type != cpu:
            continue
        if e.name == GRAPH_LAUNCH:
            launch[e.id] = (_enclosing(e.time_range.start, rep_ranges, rep_names) or "graph",
                            e.time_range.start)
            graph_calls[e.id] = (e.time_range.start, e.time_range.end - e.time_range.start)
        elif e.name in KERNEL_LAUNCHES:
            launch[e.id] = ("eager", e.time_range.start)
    kernels = _device_kernels(events)
    # the copies and fills on the copy engines (input transfers, the static
    # buffers' loads, the outputs' copies, the predicates' reads)
    copies = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name.startswith(("Memcpy", "Memset"))]
    out = {}
    for stage, at in stage_sel:
        def sel(e):
            return at(e.time_range.start)

        ks = [e for e in kernels if sel(e)]
        busy = {"eager": 0.0, "segment": 0.0, "loop": 0.0, "graph": 0.0, "unmatched": 0.0}
        eager_names = collections.Counter()
        copy_names = collections.Counter(e.name for e in copies if sel(e))
        idle = {"in_graph": 0.0, "read": 0.0, "dispatch": 0.0}
        # the dispatch gaps by the launcher of the kernel that ends them
        before = dict.fromkeys(busy, 0.0)
        n = dict.fromkeys(busy, 0)
        # per graph launch: the host's time in the call, and from the call's
        # start to the graph's first kernel
        first = {}
        reach, last = float("-inf"), None
        for e in ks:
            start, end = e.time_range.start, e.time_range.end
            kind, called = launch.get(e.id, ("unmatched", start))
            if called > start + CLOCK_SKEW_US:  # a kernel starts after its launch: not its call
                kind = "unmatched"
            if kind not in ("eager", "unmatched") and e.id not in first:
                first[e.id] = (kind, start - graph_calls[e.id][0], graph_calls[e.id][1])
            if last is not None and start > reach:
                gap = start - reach
                if kind not in ("eager", "unmatched") and e.id == last.id:
                    idle["in_graph"] += gap
                else:
                    r = _overlap(reach, start, reads)
                    idle["read"] += r
                    idle["dispatch"] += gap - r
                    before[kind] += gap - r
            busy[kind] += max(0.0, end - max(start, reach))
            n[kind] += 1
            if kind == "eager":
                eager_names[e.name[:60]] += 1
            reach, last = max(reach, end), e
        launches = {}
        for kind, delay, call in first.values():
            g = launches.setdefault(kind, [0, 0.0, 0.0])
            g[0] += 1
            g[1] += call / 1e3
            g[2] += delay / 1e3
        span = (reach - ks[0].time_range.start) / 1e3
        row = {"span_ms": span, "busy_ms": {k: v / 1e3 for k, v in busy.items()},
               "idle_ms": {k: v / 1e3 for k, v in idle.items()}, "kernels": n,
               "dispatch_before_ms": {k: v / 1e3 for k, v in before.items() if v},
               "graph_launches": {k: {"n": v[0], "call_ms": v[1], "to_first_kernel_ms": v[2]}
                                  for k, v in launches.items()},
               "reads": sum(1 for a, _ in reads if at(a)),
               "read_host_ms": sum(b - a for a, b in reads if at(a)) / 1e3,
               "eager_kernels": dict(eager_names.most_common(12)),
               "copies": dict(copy_names.most_common(8))}
        out[stage] = row
        say("stage_split", f"{label} {stage}: span {span:.1f} ms = busy "
            + ", ".join(f"{k} {v:.1f}" for k, v in row["busy_ms"].items() if v)
            + " + idle " + ", ".join(f"{k} {v:.1f}" for k, v in row["idle_ms"].items())
            + f" ms; kernels " + ", ".join(f"{k} {v}" for k, v in n.items() if v)
            + f"; {row['reads']} predicate reads, {row['read_host_ms']:.1f} ms of host time in "
            f"them; dispatch gaps before " + ", ".join(
                f"{k} {v:.1f}" for k, v in row["dispatch_before_ms"].items())
            + " ms; graph launches " + ", ".join(
                f"{k} {v['n']} ({v['call_ms']:.1f} ms in the call, {v['to_first_kernel_ms']:.1f} "
                f"ms from the call to the first kernel)" for k, v in row["graph_launches"].items())
            + f"; eager kernels by name {row['eager_kernels']}; copies and fills by name "
            f"{row['copies']} on {smi}")
    return out


def _by_shape(kernels, group: str, shapes: list, bound_of) -> list:
    """Device time of one kernel's launches by shape: its events matched to
    the recorded shapes in launch order (one stream)."""
    ks = [e for e in kernels if _kernel_group(e.name) == group]
    if len(ks) != len(shapes):  # a measurement, not a check: say so and go on
        say("profile", f"{len(ks)} {group} launches in the trace but {len(shapes)} recorded: no "
            "breakdown by shape")
        return []
    by = {}
    for e, shape in zip(ks, shapes):
        by.setdefault(shape, []).append(e.time_range.elapsed_us())
    rows = []
    for shape, us in sorted(by.items(), key=lambda kv: -len(kv[1])):
        bound_us = bound_of(*shape)["bound_ms"] * 1e3
        mean_us = sum(us) / len(us)
        rows.append({"shape": shape, "launches": len(us), "mean_us": mean_us,
                     "bound_us": bound_us, "share": bound_us / mean_us})
    return rows


def _gemms_by_shape(prof) -> list:
    """The f32/f64 GEMMs of the solve by input shapes (aten::mm and
    aten::addmm, device time summed), the largest first."""
    rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::mm", "aten::addmm", "aten::bmm"):
            dev_us = getattr(e, "device_time_total", None)
            dev_us = e.cuda_time_total if dev_us is None else dev_us
            rows.append({"op": e.key, "shapes": str(e.input_shapes)[:80], "calls": e.count,
                         "device_ms": dev_us / 1e3})
    return sorted(rows, key=lambda r: -r["device_ms"])


def phase_profile(smi: str, main_run: dict) -> dict:
    """Two more solves of the main path under torch.profiler, with a sync
    between the stages: on the kernel route, then with every Ozaki product
    on the split route (the route before ozaki_product_bl).  Both must give
    the main path's statuses and objectives bit for bit.  Per route: device
    time by kernel in the narrow stage and in the finish, each stage's
    busy share (device time over the span from its first kernel to its
    last) and launches, the GEMMs by shape, and the product kernel's (or
    the slicing's) device time by shape."""
    _, A, b, c = _bench_problem(N_LP)
    opts = SolverOptions(**BENCH_OPTIONS)
    stages = {}
    for name, route, loop in (("kernel", "kernel", "graph"), ("kernel_loops", "kernel", "loops"),
                              ("kernel_host", "kernel", "host"), ("split", "split", "host")):
        prof, out, counts, products, slices = _profiled_solve(route, A, b, c, opts, loop)
        status = out["status"].cpu().numpy()
        obj = -out["objective"].cpu().numpy()
        same = np.array_equal(status, main_run["status"])
        bitwise = obj.dtype == main_run["objective"].dtype and \
            obj.tobytes() == main_run["objective"].tobytes()
        say("profile", f"{route} route, {loop} loop: statuses equal to the main path's {same}, "
            f"objectives bitwise equal {bitwise}; {counts['ozaki_products']} Ozaki products, "
            f"ozaki_product_bl {counts['ozaki_product_bl']}, slice_rounds_bl "
            f"{counts['slice_rounds_bl']}; {counts['host_steps']} iterations, "
            f"{counts['gated_off']} gated off, {counts['graph_replays']} replays, "
            f"{counts['graph_captures']} captures, {counts['host_syncs']} predicate reads")
        check(same and bitwise, f"the main cell on the {route} route, {loop} loop, differs from "
              "the main path")
        if route == "kernel":
            check(counts["ozaki_product_bl"] == counts["ozaki_products"] > 0
                  and counts["slice_rounds_bl"] == 0, f"kernel route: launches {counts}")
        else:
            check(counts["slice_rounds_bl"] == counts["ozaki_products"] > 0
                  and counts["ozaki_product_bl"] == 0, f"split route: launches {counts}")
        st, kernels = _stages(prof, smi, f"{route} route, {loop} loop,")
        st["counts"] = counts
        if route == "kernel":
            st["split"] = _span_split(prof, smi, f"{loop} route")
        # the profiler's kernels by name against the launch counters (on the
        # graph route: the capture's counts times the replays)
        for kname, group in PROFILE_NAMES.items():
            seen = sum(st[x]["by_kernel_launches"].get(group, 0) for x in ("narrow", "finish"))
            check(seen == counts[kname], f"profile {name}: the profiler saw {seen} {group} "
                  f"launches, the counter {kname} {counts[kname]}")
        say("profile", f"{name}: the profiler's kernel counts by name equal the launch counters: "
            + ", ".join(f"{k} {counts[k]}" for k in PROFILE_NAMES if counts[k]))
        st["gemms_by_shape"] = gemms = _gemms_by_shape(prof)[:8]
        say("profile", f"{route} route, GEMMs by input shape (device ms / calls): " + "; ".join(
            f"{g['op']} {g['shapes']} {g['device_ms']:.2f}/{g['calls']}" for g in gemms))
        if name == "kernel_host":
            rows = _by_shape(kernels, "ozaki_product_kernel", products,
                             lambda r, k, B, lv: ozaki_bound(r, k, B, lv, lv + 1))
            say("profile", "ozaki_product_bl by shape (rows, n, B, levels): " + "; ".join(
                f"{x['shape']} {x['launches']} launches, {x['mean_us']:.1f} us each, bound "
                f"{x['bound_us']:.2f} us ({x['share']:.1%})" for x in rows))
            st["ozaki_by_shape"] = rows
            # device time per launch of the factors and solves
            per_launch = {}
            for group in ("solve_bl_smem_kernel<double>", "chol_bl_smem_kernel<double>",
                          "solve_bl_smem_kernel", "chol_bl_smem_kernel"):
                ks = [e for e in kernels if _kernel_group(e.name) == group]
                if ks:
                    per_launch[group] = sum(e.time_range.elapsed_us() for e in ks) / len(ks)
            say("profile", "device time per launch: " + ", ".join(
                f"{k} {v:.1f} us" for k, v in per_launch.items()))
            st["per_launch_us"] = per_launch
        elif route == "split":
            # the (hi, lo) pair read, n_slices f32 bands written; 12 f32 operations a slice
            rows = _by_shape(kernels, "slice_rounds_kernel", slices, lambda r, B, ns: bound(
                (8 + 4 * ns) * r * B, 12 * ns * r * B, torch.float32))
            say("profile", "split route, slice_rounds_bl by shape (r, B, n_slices): " + "; ".join(
                f"{x['shape']} {x['launches']} launches, {x['mean_us']:.1f} us each, bound "
                f"{x['bound_us']:.2f} us ({x['share']:.1%})" for x in rows))
            st["slice_rounds_by_shape"] = rows
        stages[name] = st
    for stage in ("narrow", "finish"):
        gr, lo, ho = (stages[k][stage] for k in ("kernel", "kernel_loops", "kernel_host"))
        say("profile", f"the {stage} stage, host loop -> loops route -> graph route: launches "
            f"{ho['launches']} -> {lo['launches']} -> {gr['launches']}, device busy "
            f"{ho['device_ms']:.1f} -> {lo['device_ms']:.1f} -> {gr['device_ms']:.1f} ms, span "
            f"{ho['span_ms']:.1f} -> {lo['span_ms']:.1f} -> {gr['span_ms']:.1f} ms, idle "
            f"{ho['idle']:.1%} -> {lo['idle']:.1%} -> {gr['idle']:.1%} on {smi}")
    k_fin, s_fin = stages["kernel_host"]["finish"], stages["split"]["finish"]
    say("profile", f"the finish on the host loop, split route -> kernel route: launches {s_fin['launches']} -> "
        f"{k_fin['launches']}, device busy {s_fin['device_ms']:.1f} -> {k_fin['device_ms']:.1f} "
        f"ms, span {s_fin['span_ms']:.1f} -> {k_fin['span_ms']:.1f} ms, GEMM "
        f"{s_fin['by_kernel_ms'].get('gemm', 0.0):.1f} -> "
        f"{k_fin['by_kernel_ms'].get('gemm', 0.0):.1f} ms on {smi}")
    return stages


# ---------------------------------------------------------------------------
# the device-resident IPM loop: gated blocks replayed as CUDA graphs
# ---------------------------------------------------------------------------

# the IPM loops' predicate reads of a main-cell solve on the loops' graphs
# with eager segments (PERF.md §5): no straight-line segment may add one
LOOP_MAIN_READS = 44
# the block lengths measured on the main cell: the shipped _loop.BLOCK and
# the runner-up of the choice among 2, 3, 4 and 6 (PERF.md §6)
LOOP_BLOCKS = (3, 4)
LOOP_KEYS = ("x", "objective", "status", "iterations")


@contextlib.contextmanager
def loop_route(route: str, block: int | None = None, per_instance: int | None = None):
    """Run the solves inside on one of three routes: "graph" (the default:
    the IPM loops as gated blocks replayed as graphs, at ``block``
    iterations a block on shared A and ``per_instance`` on per-instance A,
    and the scan stages' straight-line segments replayed as graphs),
    "loops" (the loops' graphs, the segments eager: the private
    ``hsd._EAGER_SEGMENTS``) or "host" (the per-iteration host loop and
    eager segments: ``hsd._HOST_LOOP``)."""
    saved = hsd_mod._HOST_LOOP, hsd_mod._EAGER_SEGMENTS, _loop.BLOCK, _loop.BLOCK_PER_INSTANCE
    hsd_mod._HOST_LOOP = route == "host"
    hsd_mod._EAGER_SEGMENTS = route == "loops"
    _loop.BLOCK = block or saved[2]
    _loop.BLOCK_PER_INSTANCE = per_instance or saved[3]
    try:
        yield
    finally:
        hsd_mod._HOST_LOOP, hsd_mod._EAGER_SEGMENTS, _loop.BLOCK, _loop.BLOCK_PER_INSTANCE = saved


def _loop_solve(solve, route: str, block: int | None = None,
                per_instance: int | None = None, empty: bool = True) -> dict:
    """One solve on ``route``, ended by the pull of its statuses: its
    outputs (on the host), wall, peak device memory (allocated, and
    reserved from an emptied cache: the captured graphs' pool and static
    buffers included) and counts (the whole solve's, and at the narrow
    stage's end where the solve is a scan).  ``empty=False`` keeps the
    allocator's cache (a wall without its cudaMalloc calls; reserved then
    includes what earlier solves left cached)."""
    torch.cuda.synchronize()
    if empty:
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    err = io.StringIO()
    with loop_route(route, block, per_instance), narrow_stage_counts() as narrow, \
            contextlib.redirect_stderr(err):
        t0 = time.perf_counter()
        out = solve()
        out["status"].cpu()
        wall = time.perf_counter() - t0
    # the stage seconds a solve with stage_sync prints
    stages = {m[0]: float(m[1]) for m in re.findall(r"\[scan\] (\w+) stage: ([0-9.]+)s",
                                                       err.getvalue())}
    return {"out": {k: v.cpu().numpy() for k, v in out.items()}, "wall": wall,
            "mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.max_memory_reserved() / 2**30, "counts": read_counts(),
            "narrow": dict(narrow), "stages": stages}


def _same_outputs(a: dict, b: dict) -> bool:
    return all(_same_bits(a[k], b[k]) for k in LOOP_KEYS)


ROUTES = ("host", "loops", "graph")


def _loop_cell(smi: str, label: str, solve, block: int | None = None,
               turns: tuple = ROUTES + ROUTES[::-1]) -> dict:
    """One cell on the three routes (``loop_route``): a first solve each
    (the host loop's with no graph cached, so its memory is the host
    route's alone; then the loops route's, which captures the loops'
    graphs; then the graph route's, which captures its segments), then
    the routes ``turns`` in turns (host, loops, graph, graph, loops, host
    unless a cell asks for fewer).  Every solve's statuses, objectives,
    iterations and x must equal the first host-loop solve's bit for bit.
    ``block``: the block length the cell runs at, for the report."""
    _loop._clear_graphs()
    runs = [(r, _loop_solve(solve, r)) for r in ROUTES]
    runs += [(r, _loop_solve(solve, r, empty=False)) for r in turns]
    # peak memory with every route's graphs cached, each from an emptied cache
    mem = {r: _loop_solve(solve, r) for r in ROUTES}
    ref = runs[0][1]["out"]
    same = all(_same_outputs(run["out"], ref) for _, run in runs + list(mem.items()))
    first = {r: run for r, run in runs[:3]}
    by = {r: [run for rr, run in runs[3:] if rr == r] for r in ROUTES}
    cnt = {r: by[r][-1]["counts"] for r in ROUTES}
    gc, hc = cnt["graph"], cnt["host"]
    st = ref["status"]
    say("device_loop", f"{label}: graph and loops routes bitwise equal to the host loop "
        f"(statuses, objectives, iterations, x; {len(runs)} solves) {same}; status mix "
        f"{status_mix(st)}")
    say("device_loop", f"{label}: walls in turns {'/'.join(turns)} " + "/".join(
        f"{run['wall']:.3f}" for _, run in runs[3:]) + " s (the allocator's cache kept); first "
        "solves, from an emptied cache, " + ", ".join(
            f"{r} {first[r]['wall']:.3f} s ({first[r]['counts']['graph_captures']} captures, "
            f"{first[r]['mem_gib']:.2f} / {first[r]['reserved_gib']:.2f} GiB allocated / "
            "reserved)" for r in ROUTES) + "; peak memory allocated / reserved from an emptied cache, "
        "every route's graphs cached: " + ", ".join(
            f"{r} {mem[r]['mem_gib']:.2f} / {mem[r]['reserved_gib']:.2f} GiB ({mem[r]['wall']:.3f} s)"
            for r in ROUTES) + f" (host first, no graph cached, {first['host']['mem_gib']:.2f} / "
        f"{first['host']['reserved_gib']:.2f}) on {smi}")
    if by["graph"][-1]["stages"]:
        say("device_loop", f"{label}: stage seconds (stage_sync) narrow/finish: " + "; ".join(
            f"{r} " + ", ".join(f"{x['stages']['narrow']:.3f}/{x['stages']['finish']:.3f}"
                                for x in by[r]) for r in ROUTES) + f" on {smi}")
    say("device_loop", f"{label}: a solve: " + "; ".join(
        f"{r} {cnt[r]['graph_captures']} captures, {cnt[r]['graph_replays']} replays, "
        f"{cnt[r]['host_syncs']} loop predicate reads + {cnt[r]['stage_reads']} stage reads, "
        f"{cnt[r]['segment_calls']} segments, {cnt[r]['host_steps']} iterations, "
        f"{cnt[r]['gated_off']} gated off" for r in ROUTES)
        + f" (block {block or _loop.BLOCK}); narrow stage loop reads " + "/".join(
            str(by[r][-1]["narrow"].get("host_syncs")) for r in ROUTES)
        + f"; {len(_loop._GRAPHS)} graphs cached")
    check(same, f"device_loop {label}: the graph or loops route differs from the host loop")
    for r in ("loops", "graph"):
        check(cnt[r]["host_steps"] == hc["host_steps"],
              f"device_loop {label}: iterations {cnt[r]['host_steps']} on the {r} route, "
              f"{hc['host_steps']} on the host loop")
        check(cnt[r]["graph_captures"] == 0 and cnt[r]["graph_replays"] > 0,
              f"device_loop {label}: a cached solve on the {r} route captured "
              f"{cnt[r]['graph_captures']} graphs and replayed {cnt[r]['graph_replays']}")
        check(first[r]["counts"]["graph_captures"] > 0 or r == "graph" and not gc["segment_calls"],
              f"device_loop {label}: nothing was captured on the {r} route")
        check(cnt[r]["host_syncs"] + cnt[r]["stage_reads"]
              <= cnt["loops"]["host_syncs"] + cnt["loops"]["stage_reads"],
              f"device_loop {label}: the {r} route reads more predicates than the loops route")
    check(hc["graph_replays"] == hc["gated_off"] == 0, f"device_loop {label}: the host loop "
          f"replayed {hc['graph_replays']} graphs")
    for r in ROUTES:
        check_smem_route(f"device_loop {label} ({r})", cnt[r])
    return {"same": same, "status": st, "ref": ref,
            "walls": {r: [x["wall"] for x in by[r]] for r in ROUTES}
            | {f"first_{r}": first[r]["wall"] for r in ROUTES},
            "mem_gib": {r: mem[r]["mem_gib"] for r in ROUTES}
            | {"host_first": first["host"]["mem_gib"]},
            "reserved_gib": {r: mem[r]["reserved_gib"] for r in ROUTES}
            | {"host_first": first["host"]["reserved_gib"]},
            "counts": cnt | {f"first_{r}": first[r]["counts"] for r in ROUTES},
            "narrow": {r: by[r][-1]["narrow"] for r in ROUTES}}


def _capture_fault_raises(smi: str) -> None:
    """A body that reads a value back to the host cannot be captured: the
    capture raises, and nothing falls back to an eager loop."""
    def make_body(data):
        def body(s):
            if bool(s.k > 100):  # a host sync inside the loop body
                return s
            return s._replace(k=s.k + 1)
        return body

    state = hsd_mod.HSDState(*[torch.zeros((), dtype=torch.int32, device=CARD)]
                             * len(hsd_mod.HSDState._fields))
    limit = torch.full((), 5, dtype=torch.int32, device=CARD)
    try:
        _loop._device_while(lambda s, lim: s.k < lim, make_body, state, (), limit, _loop.BLOCK,
                            key=("chip_smoke", "capture fault"))
    except RuntimeError as e:
        say("device_loop", f"a body that syncs inside its block: the capture raised "
            f"({str(e).splitlines()[0][:100]}) on {smi}")
    else:
        raise RuntimeError("check failed: a capture of a body that syncs did not raise")
    torch.cuda.synchronize()


# a segment that reads a value back to the host, run in a process of its own
# (a failed capture leaves its process's capture state behind)
SEGMENT_FAULT = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from pycllp_tpu_torch.solvers import _loop

def fn(state, data):
    (x,) = state
    return x + 1 if bool(x.sum() > 0) else x  # a host read inside the segment

try:
    _loop._segment(fn, (torch.ones(4, device="cuda"),), (), ("chip_smoke", "capture fault"))
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0][:100])
else:
    print("returned")
"""


def _segment_fault_raises(smi: str) -> None:
    """A straight-line segment that reads a value back to the host cannot be
    captured: the capture raises, and nothing falls back to eager code."""
    res = subprocess.run([sys.executable, "-c", SEGMENT_FAULT, ROOT], capture_output=True,
                         text=True, timeout=300)
    line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else res.stderr[-300:]
    say("device_loop", f"a segment that syncs: {line} (exit {res.returncode}) on {smi}")
    check(res.returncode == 0 and line.startswith("raised:"),
          "a capture of a segment that syncs did not raise")


def _per_instance_blocks(smi: str, solve, ref: dict) -> dict:
    """Per-instance A at the shipped _loop.BLOCK_PER_INSTANCE against the
    shared-A block _loop.BLOCK: a first solve each (its captures), then
    cached solves in turns; each bitwise the host loop's (``ref``)."""
    shipped, other = _loop.BLOCK_PER_INSTANCE, _loop.BLOCK
    _loop._clear_graphs()
    runs = {blk: [_loop_solve(solve, "graph", per_instance=blk)] for blk in (shipped, other)}
    for blk in (shipped, other, other, shipped):
        runs[blk].append(_loop_solve(solve, "graph", per_instance=blk))
    out = {}
    for blk, rs in runs.items():
        cnt = rs[-1]["counts"]
        out[blk] = {"walls": [r["wall"] for r in rs[1:]], "first": rs[0]["wall"],
                    "gated_off": cnt["gated_off"], "syncs": cnt["host_syncs"],
                    "steps": cnt["host_steps"], "reserved_gib": rs[-1]["reserved_gib"],
                    "same": all(_same_outputs(r["out"], ref) for r in rs)}
        say("device_loop", f"per-instance A at block {blk}{' (shipped)' if blk == shipped else ''}: "
            f"walls {'/'.join(f'{w:.3f}' for w in out[blk]['walls'])} s in turns (first, with "
            f"captures, {out[blk]['first']:.3f} s); {out[blk]['steps']} iterations, "
            f"{out[blk]['gated_off']} gated off, {out[blk]['syncs']} predicate reads; peak "
            f"reserved {out[blk]['reserved_gib']:.2f} GiB; bitwise the host loop's "
            f"{out[blk]['same']} on {smi}")
        check(out[blk]["same"], f"device_loop: per-instance A at block {blk} differs from the "
              "host loop")
    _loop._clear_graphs()
    return out


# hsd_solve_batched at a chunk's width: the registry path's, on the main cell's LPs
BATCHED_N = 16384
# the routes each new cell of phase_device_loop runs in turns after its first
# solves (fewer than the main cell's six, to keep the script's wall short)
SHORT_TURNS = ("graph", "loops", "host")
# netlib padded: the graph route's peak reserved memory over the loops
# route's, each measured with only its own graphs cached
PADDED_MEMORY_RATIO = 1.5


def _batched_checks(label: str, cell: dict) -> None:
    """hsd_solve_batched and dense_path run no lax.cond: no stage read on
    any route, the graph route reads the loops route's predicates, and
    runs its straight-line code as segments."""
    cnt = cell["counts"]
    for r in ROUTES:
        check(cnt[r]["stage_reads"] == 0, f"device_loop {label}: {cnt[r]['stage_reads']} stage "
              f"reads on the {r} route")
    check(cnt["graph"]["host_syncs"] == cnt["loops"]["host_syncs"],
          f"device_loop {label}: {cnt['graph']['host_syncs']} predicate reads on the graph route, "
          f"{cnt['loops']['host_syncs']} on the loops route")
    check(cnt["graph"]["segment_calls"] > 0, f"device_loop {label}: no segment ran")


def _profiled_batched(smi: str, solve, loop: str) -> dict:
    """One cached hsd_solve_batched under torch.profiler on ``loop``: the
    span split by launcher (``_span_split``, one stage), its eager kernels
    and copies by name, and its counts (no capture, no stage read)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with loop_route(loop):
        solve()["status"].cpu()
        torch.cuda.synchronize()
        zero_counts()
        with torch.profiler.profile(activities=acts) as prof:
            solve()["status"].cpu()
    counts = read_counts()
    split = _span_split(prof, smi, f"hsd_solve_batched {BATCHED_N} lanes, {loop} route")["solve"]
    check(counts["graph_captures"] == 0 and counts["stage_reads"] == 0,
          f"device_loop: the profiled hsd_solve_batched on the {loop} route captured "
          f"{counts['graph_captures']} graphs and read {counts['stage_reads']} stage predicates")
    return {"split": split, "counts": counts}


def _own_route_memory(smi: str, label: str, solve, ref: dict) -> dict:
    """Peak memory of the loops and the graph route, each with only its own
    graphs cached (the cache cleared, a solve that captures them, then a
    solve from an emptied allocator cache), bitwise the host loop's."""
    mem = {}
    for r in ("loops", "graph"):
        _loop._clear_graphs()
        first = _loop_solve(solve, r)
        run = _loop_solve(solve, r)
        check(_same_outputs(first["out"], ref) and _same_outputs(run["out"], ref),
              f"device_loop {label}: the {r} route differs from the host loop")
        mem[r] = {"mem_gib": run["mem_gib"], "reserved_gib": run["reserved_gib"],
                  "first_reserved_gib": first["reserved_gib"], "wall": run["wall"]}
    _loop._clear_graphs()
    ratio = mem["graph"]["reserved_gib"] / mem["loops"]["reserved_gib"]
    say("device_loop", f"{label}: peak memory allocated / reserved with only the route's own graphs "
        "cached, from an emptied cache: " + ", ".join(
            f"{r} {m['mem_gib']:.2f} / {m['reserved_gib']:.2f} GiB (its capturing solve reserved "
            f"{m['first_reserved_gib']:.2f})" for r, m in mem.items())
        + f"; graph / loops reserved {ratio:.3f} (limit {PADDED_MEMORY_RATIO}) on {smi}")
    check(ratio <= PADDED_MEMORY_RATIO, f"device_loop {label}: the graph route reserves {ratio:.3f}x "
          "the loops route's memory")
    return mem | {"ratio": ratio}


def _batched_cells(smi: str) -> dict:
    """The reference's other jit programs on the three routes, bitwise the
    host loop: one hsd_solve_batched of BATCHED_N of the main cell's LPs
    (the registry path at a chunk's width, profiled on the loops and the
    graph route), each of netlib's three buckets (shared A), and
    dense_path in f32 on the same LPs."""
    _, A, b, c = _bench_problem(BATCHED_N)
    opts = SolverOptions(**BENCH_OPTIONS)
    cells = {}

    def batched():
        return hsd_mod.hsd_solve_batched(A, b, c, opts, bl.BATCHLAST_KERNELS, device="cuda")

    label = f"hsd_solve_batched ({BATCHED_N} lanes, bench options)"
    cells["batched"] = _loop_cell(smi, label, batched, turns=SHORT_TURNS)
    _batched_checks(label, cells["batched"])
    cells["batched"]["profile"] = {r: _profiled_batched(smi, batched, r) for r in ("loops", "graph")}

    names, _, buckets = _netlib_buckets()
    for i, An, bn, cn, _ in buckets:
        bt, ct = torch.from_numpy(bn).to(CARD), torch.from_numpy(cn).to(CARD)
        label = f"netlib {names[i]} ({An.shape[0]}x{An.shape[1]}, {NETLIB_REPS} replicas)"
        cells[f"netlib_{names[i]}"] = cell = _loop_cell(
            smi, label, lambda: hsd_mod.hsd_solve_batched(An, bt, ct, opts, bl.BATCHLAST_KERNELS,
                                                          device="cuda"), turns=SHORT_TURNS)
        _batched_checks(label, cell)

    o32 = SolverOptions(tol=1e-4, maxiter=40, dtype="float32")
    label = f"dense_path f32 ({BATCHED_N} lanes)"
    cells["dense_path"] = _loop_cell(
        smi, label, lambda: dense_path_solve_batched(A, b, c, o32, bl.BATCHLAST_KERNELS,
                                                     device="cuda"), turns=SHORT_TURNS)
    _batched_checks(label, cells["dense_path"])
    _loop._clear_graphs()
    return cells


def phase_device_loop(smi: str, main_run: dict) -> dict:
    """The three routes on the card (``loop_route``: the stage graphs, the
    loops' graphs with eager segments, the per-iteration host loop),
    bitwise, on the main cell, the fused-form and fuse_facsol sets,
    netlib's padded batch (per-instance A, also at the shared-A block, and
    its memory with each route's own graphs), one hsd_solve_batched of
    BATCHED_N lanes, netlib's three buckets and dense_path
    (``_batched_cells``); the block length over LOOP_BLOCKS on the main
    cell (wall, gated-off share)."""
    _, A, b, c = _bench_problem(N_LP)
    opts = SolverOptions(**BENCH_OPTIONS)
    kw = {**SCAN_KW, "keys": LOOP_KEYS}

    def scan(kset):
        return lambda: hsd_mod.hsd_solve_scan(A, b, c, opts, kset, device="cuda", **kw)

    # the main cell with a sync between the stages, for their seconds
    cells = {"main": _loop_cell(smi, "main cell", lambda: hsd_mod.hsd_solve_scan(
        A, b, c, opts, bl.BATCHLAST_KERNELS, device="cuda", stage_sync=True, **kw))}
    check(np.array_equal(cells["main"]["status"], main_run["status"]),
          "device_loop: the main cell's statuses differ from the main path's")
    reads = cells["main"]["counts"]["graph"]["host_syncs"]
    check(reads <= LOOP_MAIN_READS, f"device_loop: the main cell's IPM loops read {reads} "
          f"predicates on the graph route (the loops' graphs alone: {LOOP_MAIN_READS})")
    cells["fused_form"] = _loop_cell(smi, "fused-form set", scan(bl.BATCHLAST_FUSED_KERNELS))
    cells["facsol"] = _loop_cell(smi, "fuse_facsol set",
                                 scan(bl.BatchLastKernels(fuse_facsol=True)))
    _, stds, buckets = _netlib_buckets()
    A3, b3, c3 = (torch.from_numpy(v).to(CARD) for v in _netlib_padded(stds, buckets))
    cells["netlib_padded"] = _loop_cell(
        smi, f"netlib padded ({A3.shape[0]} lanes, per-instance {A3.shape[1]}x{A3.shape[2]})",
        lambda: hsd_mod.hsd_solve_batched(A3, b3, c3, opts, bl.BATCHLAST_KERNELS, device="cuda"),
        block=_loop.BLOCK_PER_INSTANCE)
    _batched_checks("netlib padded", cells["netlib_padded"])
    cells["netlib_padded"]["own_memory"] = _own_route_memory(
        smi, "netlib padded", lambda: hsd_mod.hsd_solve_batched(
            A3, b3, c3, opts, bl.BATCHLAST_KERNELS, device="cuda"), cells["netlib_padded"]["ref"])
    cells["netlib_padded"]["blocks"] = _per_instance_blocks(
        smi, lambda: hsd_mod.hsd_solve_batched(A3, b3, c3, opts, bl.BATCHLAST_KERNELS,
                                               device="cuda"), cells["netlib_padded"]["ref"])
    del A3, b3, c3
    cells.update(_batched_cells(smi))

    # the block length: the main cell on the graph route at each, its
    # answer bitwise the host loop's
    ref = None
    sweep = {}
    solve = scan(bl.BATCHLAST_KERNELS)
    for block in LOOP_BLOCKS:
        _loop._clear_graphs()
        first = _loop_solve(solve, "graph", block)
        runs = [_loop_solve(solve, "graph", block) for _ in range(2)]
        ref = ref or _loop_solve(solve, "host")["out"]
        cnt = runs[-1]["counts"]
        share = cnt["gated_off"] / max(1, cnt["gated_off"] + cnt["host_steps"])
        sweep[block] = {"walls": [r["wall"] for r in runs], "first": first["wall"],
                        "gated_off": cnt["gated_off"], "share": share,
                        "syncs": cnt["host_syncs"], "narrow_syncs": runs[-1]["narrow"]["host_syncs"],
                        "same": all(_same_outputs(r["out"], ref) for r in [first] + runs)}
        say("device_loop", f"block {block}: main cell walls {runs[0]['wall']:.3f}/"
            f"{runs[1]['wall']:.3f} s (first, with captures, {first['wall']:.3f} s); "
            f"{cnt['host_steps']} iterations, {cnt['gated_off']} gated off ({share:.1%}); "
            f"{cnt['host_syncs']} predicate reads ({sweep[block]['narrow_syncs']} in the narrow "
            f"stage); bitwise the host loop's {sweep[block]['same']} on {smi}")
        check(sweep[block]["same"], f"device_loop: block {block} differs from the host loop")
    best = min(sweep, key=lambda k: min(sweep[k]["walls"]))
    say("device_loop", f"fastest block on the main cell: {best} (the shipped block: "
        f"{_loop.BLOCK}) on {smi}; conditional graph nodes "
        f"(CUDAGraph.begin_capture_to_if_node) in torch {torch.__version__}: "
        f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}")
    _loop._clear_graphs()
    return {"cells": cells, "blocks": sweep}


# the Ozaki widths set for a solve (the reference's PYCLLP_OZAKI_BITS /
# PYCLLP_OZAKI_MV_BITS): the formation width whose wide phase the reference's
# sizing note records as diverging, and a matvec width below the default
WIDTH_BITS, WIDTH_MV_BITS = 56, 40
# wider formations that reach the kernel's 16- and 24-level instantiations at
# n = 128 (14 and 17 levels of 6 bits), which no default-width shape runs
WIDTH_WIDE_FORMATIONS = (84, 100)
# over the 24-level cap at every contraction length (40 levels at n = 128)
WIDTH_OVER_CAP = 200
# 17 levels at n = 128 but 25 at n = 1,024: the width alone does not decide
WIDTH_OVER_CAP_AT_N = (100, 1024)
REF_RHO_P_56 = ("a rho_p floor near 6e-4, a diverged wide phase (the reference's sizing note, "
                "pycllp_tpu/ops/df64.py:375-383)")


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def phase_ozaki_widths(dev, smi: str, probe: dict, main_run: dict) -> dict:
    """The Ozaki widths set for a solve, through the narrow set that carries
    them (``BatchLastKernels(ozaki_bits=, ozaki_mv_bits=)``).  (i) The
    default widths given explicitly: the df64 probe and the main cell's
    first solve bitwise equal (statuses, objectives) to the runs without
    them.  (ii) The df64 probe at 56 bits runs to its end, every product on
    the kernel at 8 levels; its status mix and worst rho_p are printed beside
    the 66-bit run's, not bounded.  (iii) ozaki_product_bl BITWISE against
    its plain version and the split route at the main path's shapes at 56
    bits (formation) and 40 bits (matvecs), and at two wider formations
    that reach its 16- and 24-level instantiations.  (iv) A width over the
    24-level cap raises ValueError before anything launches.  Returns the
    56-bit probe's launches."""
    # (i) the default widths, given explicitly
    explicit = bl.BatchLastKernels(ozaki_bits=df64.OZAKI_BITS, ozaki_mv_bits=df64.OZAKI_MV_BITS)
    check(explicit.finish_kernels() is df64.DF64_FINISH_KERNELS
          and explicit.finish_kernels("mixed1") is bl.BATCHLAST_KERNELS.finish_kernels("mixed1"),
          "the default widths given explicitly select other wide sets")
    _, st, obj, secs, counts, _ = _probe_solve("ozaki widths (i)", 3,
                                               SolverOptions(**DF64_PROBE_OPTIONS), explicit)
    same_probe = np.array_equal(st, probe["status"]) and _same_bits(obj, probe["objective"])
    _, A, b, c = _bench_problem(N_LP)
    zero_counts()
    t0 = time.perf_counter()
    out = hsd_mod.hsd_solve_scan(A, b, c, SolverOptions(**BENCH_OPTIONS), explicit, device="cuda",
                                 **SCAN_KW)
    st_main = out["status"].cpu().numpy()
    main_s = time.perf_counter() - t0
    check_smem_route("ozaki widths (i) main cell", read_counts())
    obj_main = -out["objective"].cpu().numpy()
    same_main = np.array_equal(st_main, main_run["status"]) and _same_bits(
        obj_main, main_run["objective"])
    say("ozaki widths", f"(i) ozaki_bits={df64.OZAKI_BITS}, ozaki_mv_bits={df64.OZAKI_MV_BITS} "
        f"given explicitly: the df64 probe ({secs:.3f}s) statuses and objectives bitwise equal to "
        f"the probe without them {same_probe}; the main cell's solve ({main_s:.3f}s, "
        f"{len(st_main)} lanes) bitwise equal to the main path's first solve {same_main}")
    check(same_probe, "ozaki widths (i): the df64 probe at the explicit default widths differs")
    check(same_main, "ozaki widths (i): the main cell at the explicit default widths differs")

    # (ii) the df64 probe at 56 bits: 8 levels of 7 bits for the formation
    _PRODUCT_SHAPES.update(on=True, shapes=[])
    try:
        lp56, st56, obj56, secs56, counts56, rho56 = _probe_solve(
            "ozaki widths (ii)", 3, SolverOptions(**DF64_PROBE_OPTIONS),
            bl.BatchLastKernels(ozaki_bits=WIDTH_BITS))
    finally:
        _PRODUCT_SHAPES["on"] = False
    levels = {}
    for rows, _n, _B, lv in _PRODUCT_SHAPES["shapes"]:
        levels.setdefault(rows, set()).add(lv)
    want = {M * M: df64.ozaki_params(2 * M, WIDTH_BITS)[1], M: df64.ozaki_mv_params(2 * M)[1],
            2 * M: df64.ozaki_mv_params(M)[1]}
    check(counts56["df_chol_bl"] > 0 and counts56["df_solve_bl"] > 0,
          "ozaki widths (ii): the 56-bit probe never ran the FP64 factor / solve")
    check(levels == {rows: {lv} for rows, lv in want.items()},
          f"ozaki widths (ii): products by rows and levels {levels}, want {want}")
    rels56 = audit(lp56, obj56, np.linspace(0, len(st56) - 1, 64, dtype=int))
    say("ozaki widths", f"(ii) the df64 probe at ozaki_bits={WIDTH_BITS} ({secs56:.3f}s) ran to "
        f"its end: status mix {status_mix(st56)}, worst rho_p {np.nanmax(rho56):.3e} "
        f"({int(np.isnan(rho56).sum())} NaN), audit of 64 lanes max {max(rels56.values()):.3e} "
        f"(reported, not bounded); at {df64.OZAKI_BITS} bits: status mix "
        f"{status_mix(probe['status'])}, worst rho_p {np.nanmax(probe['rho_p']):.3e}, audit max "
        f"{probe['audit_max']:.3e}; the reference's note expects {REF_RHO_P_56}; "
        f"{counts56['ozaki_products']} Ozaki products = {counts56['ozaki_product_bl']} "
        f"ozaki_product_bl launches, levels by rows {levels}; launches {counts56}")

    # (iii) the kernel at the new widths, at the main path's shapes
    rng = np.random.default_rng(12)
    A_main = torch.from_numpy(rng.normal(size=(M, 2 * M)) / np.sqrt(2 * M)).to(dev)
    cases = [(f"mv_bits={WIDTH_MV_BITS}", o) for o in
             _ozaki_operands(A_main, WIDTH_BITS, WIDTH_MV_BITS)[:2]]
    cases += [(f"bits={bits}", _ozaki_operands(A_main, bits)[2])
              for bits in (WIDTH_BITS,) + WIDTH_WIDE_FORMATIONS]
    held, formation_at = [], {}
    zero_counts()
    for width, (label, Wx, op, (s, n_slices, cut)) in cases:
        rows, k = Wx.shape
        for B in OZAKI_WIDTHS:
            if label == "formation" and B > OZAKI_FORMATION_MAX_B:
                continue
            d = _ozaki_lanes(B, k, rng, dev)
            kw = dict(s=s, n_slices=n_slices, cut=cut)
            _hold_ozaki_product(op, d, kw, f"{width} {label} {rows}x{k}, B={B}, "
                                f"(s, n_slices, cut)=({s}, {n_slices}, {cut})")
            held.append(f"{width} {label} B={B} ({cut - 1} levels)")
            if label == "formation" and B == OZAKI_FORMATION_MAX_B:
                formation_at[width] = (op, d, kw)
    counts = read_counts()
    check(counts["ozaki_product_bl"] == len(held) and counts["ozaki_products"] == 0,
          f"ozaki widths (iii): launches {counts}")
    # the 56-bit formation timed in turns against the default width's
    _, W66, op66, (s66, ns66, cut66) = _ozaki_operands(A_main)[2]
    d66 = _ozaki_lanes(OZAKI_FORMATION_MAX_B, W66.shape[1], rng, dev)
    op56, _, kw56 = formation_at[f"bits={WIDTH_BITS}"]
    t56, t66 = in_turns("ozaki_product_bl formation 56 vs 66 bits",
                        lambda: df64._ozaki_product_bl_cuda(op56, d66, **kw56),
                        lambda: df64._ozaki_product_bl_cuda(op66, d66, s66, ns66, cut66))
    say("ozaki widths", f"(iii) ozaki_product_bl bitwise equal to the split route and its plain "
        f"version at {len(held)} shapes: {'; '.join(held)}; the formation 4096x128 at B="
        f"{OZAKI_FORMATION_MAX_B}: {kw56['cut'] - 1} levels {t56:.4f} ms, {cut66 - 1} levels "
        f"{t66:.4f} ms on {smi}")

    # (iv) over the cap: ValueError before anything launches
    zero_counts()
    refused = {}
    for what, build in (
            (f"DoubleSingleKernels(bits={WIDTH_OVER_CAP})",
             lambda: df64.DoubleSingleKernels(bits=WIDTH_OVER_CAP)),
            (f"BatchLastKernels(ozaki_bits={WIDTH_OVER_CAP})",
             lambda: bl.BatchLastKernels(ozaki_bits=WIDTH_OVER_CAP)),
            (f'get_solver("hsd_pallas", ozaki_mv_bits={WIDTH_OVER_CAP})',
             lambda: get_solver("hsd_pallas", device="cuda", ozaki_mv_bits=WIDTH_OVER_CAP))):
        try:
            build()
        except ValueError as e:
            refused[what] = str(e)
        check(what in refused and "24 levels" in refused[what],
              f"ozaki widths (iv): {what} was not refused for the level cap")
    bits, n_long = WIDTH_OVER_CAP_AT_N
    A_long = rng.normal(size=(8, n_long)).astype(np.float32)
    b_long = torch.ones((64, 8), device=dev)
    c_long = torch.from_numpy(rng.normal(size=(64, n_long)).astype(np.float32)).to(dev)
    what = f"hsd_solve_scan on BatchLastKernels(ozaki_bits={bits}) at n = {n_long}"
    try:
        hsd_mod.hsd_solve_scan(A_long, b_long, c_long, SolverOptions(**BENCH_OPTIONS),
                               bl.BatchLastKernels(ozaki_bits=bits), device="cuda", chunk=64,
                               compact_cap=12, compact_bucket=64)
    except ValueError as e:
        refused[what] = str(e)
    check(what in refused and "25 levels" in refused[what], f"ozaki widths (iv): {what} ran")
    counts = read_counts()
    launched = {k_: v for k_, v in counts.items() if v}
    say("ozaki widths", f"(iv) refused before any launch: " + "; ".join(
        f"{k_}: {v}" for k_, v in refused.items()) + f"; launches {launched or 'none'}")
    check(not launched, f"ozaki widths (iv): something ran before the refusal: {launched}")
    return counts56


def phase_fused_paths(smi: str, ref_status) -> tuple[dict, dict]:
    """The main path's configuration on the fused-form set and on the
    fuse_facsol set.  Each narrow iteration and each chunk's Mehrotra
    start factors once; the finish keeps chol_bl / solve_bl (its mixed
    engine is built on the default set)."""
    n_chunks = -(-N_LP // SCAN_KW["chunk"])
    form = _scan_path(smi, bl.BATCHLAST_FUSED_KERNELS, "fused-form path", ("second",), ref_status)
    _audit_main("fused-form path", form["lp"], form["objective"], form["status"])
    nar, tot = form["narrow"], form["total"]
    steps, off = nar["host_steps"], nar["gated_off"]
    check(nar["fused_factor_bl"] == steps + off + n_chunks,
          f"fused_factor_bl launches {nar['fused_factor_bl']} in the narrow stage != iterations "
          f"{steps} + gated off {off} + Mehrotra starts {n_chunks}")
    check(tot["fused_factor_bl"] == nar["fused_factor_bl"],
          "fused_factor_bl was launched in the finish")
    check(nar["chol_bl"] == 0, f"chol_bl launched {nar['chol_bl']} times in the fused narrow stage")
    check(nar["solve_bl"] == 5 * (steps + off) + n_chunks,
          f"narrow solve_bl launches {nar['solve_bl']} != 5 x ({steps} + {off}) + {n_chunks}")
    say("fused-form path", f"narrow stage: fused_factor_bl {nar['fused_factor_bl']} = {steps} "
        f"iterations + {off} gated off + {n_chunks} Mehrotra starts, all "
        f"{tot['fused_factor_bl_smem']} on the lane-group design; finish: chol_bl "
        f"{tot['chol_bl']}, solve_bl {tot['solve_bl'] - nar['solve_bl']}, "
        f"{tot['host_steps'] - steps} iterations")

    facsol = _scan_path(smi, bl.BatchLastKernels(fuse_facsol=True), "facsol path", ("second",),
                        ref_status)
    _audit_main("facsol path", facsol["lp"], facsol["objective"], facsol["status"])
    nar, tot = facsol["narrow"], facsol["total"]
    steps, off = nar["host_steps"], nar["gated_off"]
    check(nar["facsol_bl"] == steps + off + n_chunks,
          f"facsol_bl launches {nar['facsol_bl']} in the narrow stage != iterations {steps} + "
          f"gated off {off} + Mehrotra starts {n_chunks}")
    check(tot["facsol_bl"] == nar["facsol_bl"], "facsol_bl was launched in the finish")
    check(nar["chol_bl"] == 0, f"chol_bl launched {nar['chol_bl']} times in the facsol narrow stage")
    # per iteration the corrector and 3 KKT sweeps; the joint k=2 solve is in facsol
    check(nar["solve_bl"] == 4 * (steps + off),
          f"narrow solve_bl launches {nar['solve_bl']} != 4 x ({steps} + {off})")
    say("facsol path", f"narrow stage: facsol_bl {nar['facsol_bl']} = {steps} iterations + {off} "
        f"gated off + {n_chunks} Mehrotra starts, all {tot['facsol_bl_smem']} on the lane-group "
        f"design, solve_bl {nar['solve_bl']} = 4 x ({steps} + {off}); finish: chol_bl "
        f"{tot['chol_bl']}, solve_bl {tot['solve_bl'] - nar['solve_bl']}")
    return form, facsol


def _sweep_child(rank: int, init_file: str, out_dir: str, sweep_dir: str,
                 kill_after: int) -> None:
    """Config 5 in a child process (one "rank" of :func:`_spawn_ranks`, no
    group): the data regenerated from seed 3 and staged on the card, the
    sweep run into ``sweep_dir``; once ``kill_after`` chunks are on disk the
    progress callback reports the child's times and kills it with SIGKILL."""
    _build.load()  # the parent built the library
    t0 = time.perf_counter()
    _, A, b, c = _bench_problem(SWEEP_N)
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    t0 = time.perf_counter()

    def kill(done, total):
        if done >= kill_after:
            _report(out_dir, rank, {"staged_s": staged_s, "solve_s": time.perf_counter() - t0,
                                    "done": done})
            os.kill(os.getpid(), signal.SIGKILL)

    scenario_sweep(A, b, c, SolverOptions(**BENCH_OPTIONS), out_dir=sweep_dir, progress=kill,
                   kset=bl.BATCHLAST_FUSED_KERNELS, device="cuda", **SWEEP_KW)
    raise RuntimeError("the config-5 child sweep ran to its end: it was not killed")


def _chunk_files(out_dir: str) -> list:
    return sorted(f for f in os.listdir(out_dir)
                  if f.startswith("chunk_") and f.endswith(".npz") and not f.endswith(".tmp.npz"))


def _stale_tmp(path: str, rows: int) -> str:
    """Plant ``path + ".tmp.npz"`` as a writer killed between its write and
    its rename leaves it, holding values no solve gives."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, objective=np.full(rows, np.nan), status=np.full(rows, 99, np.int32),
             iterations=np.full(rows, -1, np.int32))
    return tmp


def phase_sweep(smi: str) -> dict:
    """BASELINE.md config 5 as written: bench.py's run_sweep with
    BENCH_TOTAL=1000000 on the fused-form set.  (1) A child process runs it
    into a directory under build/ and is killed with SIGKILL after
    SWEEP_KILL_WINDOWS windows; (2) the last chunk of its last window is
    deleted and a stale temporary file planted, so a window is half on
    disk; (3) the sweep resumes here; (4) one uninterrupted sweep, whose
    wall is config 5's scenarios/s; (5) resumed = uninterrupted; (6) the
    status mix and the wide audit.  Returns the uninterrupted sweep's
    launches."""
    lp, A, b, c = _bench_problem(SWEEP_N)
    opts = SolverOptions(**BENCH_OPTIONS)
    kw = dict(SWEEP_KW, kset=bl.BATCHLAST_FUSED_KERNELS, device="cuda")
    chunk, window = kw["chunk"], kw["window_chunks"]
    n_chunks = -(-SWEEP_N // chunk)
    kill_after = SWEEP_KILL_WINDOWS * window
    gone = kill_after - 1  # the last chunk of the last window on disk
    say("config 5", f"{SWEEP_N} scenarios (64x64 -> 64x128, shared A, seed 3) = {n_chunks} "
        f"chunks of {chunk} (the last holds {SWEEP_N - (n_chunks - 1) * chunk}) in windows of "
        f"{window} (the last of {n_chunks - (n_chunks - 1) // window * window}); b and c staged "
        f"on the card once ({(b.numel() + c.numel()) * 4 / 1e6:.0f} MB)")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="sweep-", dir=os.path.join(ROOT, "build"))
    try:
        # (1) a real kill
        t0 = time.perf_counter()
        (child,) = _spawn_ranks(_sweep_child, 1, out_dir, kill_after, killed=True)
        child_s = time.perf_counter() - t0
        check(child["done"] == kill_after, f"the config-5 child was killed after {child['done']}")
        files = sorted(os.listdir(out_dir))
        on_disk = _chunk_files(out_dir)
        check("manifest.json" in files and on_disk == [f"chunk_{k:06d}.npz"
                                                        for k in range(kill_after)],
              f"after the kill the sweep directory holds {files}")
        check(not any(f.endswith(".tmp.npz") for f in files), "the kill left a half-written chunk")
        say("config 5", f"kill: the child died by SIGKILL after {child_s:.3f}s (data made and "
            f"staged in {child['staged_s']:.3f}s, {kill_after} chunks solved and written in "
            f"{child['solve_s']:.3f}s); on disk: manifest.json + {len(on_disk)} chunk files")

        # (2) a half-written window: its last chunk gone, a stale temporary file
        gone_path = os.path.join(out_dir, f"chunk_{gone:06d}.npz")
        os.remove(gone_path)
        tmp = _stale_tmp(gone_path, chunk)
        say("config 5", f"half-written window {SWEEP_KILL_WINDOWS}: deleted "
            f"{os.path.basename(gone_path)}, planted {os.path.basename(tmp)}; "
            f"{len(_chunk_files(out_dir))} chunk files on disk")

        # (3) the resume
        zero_counts()
        t0 = time.perf_counter()
        resumed = scenario_sweep(A, b, c, opts, out_dir=out_dir, **kw)
        resume_s = time.perf_counter() - t0
        counts = read_counts()
        check_smem_route("config 5 resume", counts)
        check(counts["fused_factor_bl"] > 0, "fused_factor_bl was never launched in the resume")
        check(resumed.n_resumed == kill_after - 1,
              f"the resumed sweep loaded {resumed.n_resumed} chunks, not {kill_after - 1}")
        check(not os.path.exists(tmp), "the stale temporary file is still there")
        check(_chunk_files(out_dir) == [f"chunk_{k:06d}.npz" for k in range(n_chunks)],
              f"after the resume the directory holds {sorted(os.listdir(out_dir))}")
        with np.load(gone_path) as data:
            lo = gone * chunk
            check(np.array_equal(data["status"], resumed.status[lo:lo + chunk])
                  and np.array_equal(data["objective"], resumed.objective[lo:lo + chunk]),
                  f"{os.path.basename(gone_path)} does not hold the resumed answers")
        solved = n_chunks - resumed.n_resumed
        say("config 5", f"resume: {resumed.n_resumed} chunks loaded, {solved} solved and written "
            f"(window {SWEEP_KILL_WINDOWS} re-solved whole: {window - 1} of its chunks solved "
            f"again, not written) in {resume_s:.3f}s; launches {counts}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # (4) uninterrupted, no out_dir: config 5's wall
    marks = []
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured = []  # graphs captured by the end of each window, and their keys
    cached = set(_loop._GRAPHS)

    def progress(done, total):
        marks.append(time.perf_counter())
        captured.append((_loop.GRAPH_CAPTURES, set(_loop._GRAPHS) - cached))

    whole = scenario_sweep(A, b, c, opts, progress=progress, **kw)
    whole_s = time.perf_counter() - t0
    counts = read_counts()
    late = [_graph_name(k) for k in captured[-1][1] - captured[0][1]]
    captured = [n for n, _ in captured]
    say("config 5", f"uninterrupted sweep: {captured[0]} graphs captured in its first window, "
        f"{captured[-1] - captured[0]} after it {late}; {len(_loop._GRAPHS)} graphs cached")
    check(captured[-1] == captured[0], f"config 5: the uninterrupted sweep captured "
          f"{captured[-1] - captured[0]} graphs after its first window")
    check_smem_route("config 5", counts)
    for name in ("fused_factor_bl", "solve_bl", "ozaki_product_bl"):
        check(counts[name] > 0, f"{name} was never launched in the config-5 sweep")
    windows = np.diff([t0] + marks)
    say("config 5", f"uninterrupted, no out_dir: {whole_s:.3f}s = {SWEEP_N / whole_s:.1f} "
        f"scenarios/s on {smi}; windows of {window} chunks: first {windows[0]:.3f}s, then mean "
        f"{windows[1:-1].mean():.3f}s (min {windows[1:-1].min():.3f}, max "
        f"{windows[1:-1].max():.3f}); the last window ({n_chunks - (len(windows) - 1) * window} "
        f"chunks, one ragged) {windows[-1]:.3f}s; launches {counts}")
    say("config 5", f"transcript: chunks on disk after the kill {kill_after}, after the deletion "
        f"{kill_after - 1}; loaded {resumed.n_resumed}; solved {solved}; child {child_s:.3f}s, "
        f"resume {resume_s:.3f}s, uninterrupted {whole_s:.3f}s; kill + resume "
        f"{child_s + resume_s:.3f}s")

    # (5) resumed vs uninterrupted
    same_status = bool(np.array_equal(resumed.status, whole.status))
    rel = np.abs(resumed.objective - whole.objective) / np.maximum(1.0, np.abs(whole.objective))
    bitwise = bool(np.array_equal(resumed.objective, whole.objective))
    say("config 5", f"resumed vs uninterrupted: statuses identical {same_status}, objective max "
        f"rel {rel.max():.3e} (limit {SWEEP_OBJ_RTOL}), bitwise equal {bitwise}, iterations equal "
        f"{bool(np.array_equal(resumed.iterations, whole.iterations))}")
    check(same_status, "resumed and uninterrupted sweeps disagree on a status")
    check(rel.max() <= SWEEP_OBJ_RTOL, f"resumed vs uninterrupted objective rel {rel.max():.3e}")

    # (5b) the first window again, as one hsd_solve_scan, on the three routes:
    # x too, and the uninterrupted sweep's answers, bit for bit
    first = window * chunk
    scan_kw = {k: v for k, v in SWEEP_KW.items() if k != "window_chunks"}
    outs = {}
    for route in ("graph", "loops", "host"):
        zero_counts()
        t0 = time.perf_counter()
        with loop_route(route):
            out = hsd_mod.hsd_solve_scan(A, b[:first], c[:first], opts,
                                         bl.BATCHLAST_FUSED_KERNELS, device="cuda",
                                         keys=LOOP_KEYS, **scan_kw)
            outs[route] = {k: v.cpu().numpy() for k, v in out.items()}
        route_s = time.perf_counter() - t0
        same = all(_same_bits(outs[route][k], getattr(whole, k)[:first])
                   for k in ("status", "objective", "iterations"))
        say("config 5", f"the first window ({window} chunks) on the {route} route: {route_s:.3f}s "
            f"({_loop.GRAPH_CAPTURES} captures; the sweep's first window {windows[0]:.3f}s); "
            f"statuses, objectives and iterations bitwise the uninterrupted sweep's {same}, x "
            f"bitwise the graph route's {_same_bits(outs[route]['x'], outs['graph']['x'])}")
        check(same and _same_bits(outs[route]["x"], outs["graph"]["x"]),
              f"config 5: the first window on the {route} route differs")

    # (6) the status mix and the wide audit
    say("config 5", f"status mix {status_mix(whole.status)}; OPTIMAL "
        f"{(whole.status == int(Status.OPTIMAL)).mean():.4%}; iterations p50/p99/max "
        f"{'/'.join(str(int(v)) for v in np.percentile(whole.iterations, [50, 99]))}/"
        f"{whole.iterations.max()}")
    _optimal_share("config 5", -whole.objective, whole.status)
    grid = set(np.linspace(0, SWEEP_N - 1, WIDE_AUDIT_LANES, dtype=int).tolist())
    wide_audit("config 5", lp, -whole.objective, whole.status,
               {i: v for i, v in CONFIG5_OVER_CONTRACT.items() if i in grid})
    off_grid_audit("config 5", lp, -whole.objective, whole.status,
                   {i: v for i, v in CONFIG5_OVER_CONTRACT.items() if i not in grid})
    return counts


def _graph_name(key) -> str:
    """The name a cached graph's key gives: a segment's function, a loop's
    caller."""
    return str(key[1][0] if key[0] == "segment" else key[0][0])


def phase_metrics() -> None:
    """Per-iteration metrics: one 4,096-lane solve with log_every=1."""
    B = 4096
    lp = random_standard_lp(M, N, nlp=B, seed=5, dtype=np.float32)
    eq = lp.to_equality_form()
    kw = {k: v for k, v in SOLVER_KW.items() if k not in ("chunk", "compact_cap", "compact_bucket")}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="metrics-", suffix=".jsonl", dir=os.path.join(ROOT, "build"))
    os.close(fd)
    try:
        zero_counts()
        with metrics_to_jsonl(path):
            out = hsd_mod.hsd_solve_batched(
                np.asarray(eq.A, np.float32), np.asarray(eq.b, np.float32),
                np.asarray(eq.c, np.float32), SolverOptions(log_every=1, **kw),
                bl.BATCHLAST_KERNELS, device="cuda",
            )
        out["status"].cpu()
        with open(path) as f:
            records = [json.loads(line) for line in f]
    finally:
        os.remove(path)
    steps = hsd_mod.HOST_STEPS
    check_smem_route("metrics", read_counts())
    check(len(records) == steps, f"{len(records)} metric records for {steps} host iterations")
    check(records[0]["active"] == B and records[0]["iter"] == 0 and records[0]["phase"] == "float32",
          f"first record {records[0]}")
    say("metrics", f"{len(records)} records = host iterations; first {records[0]}; "
        f"last {records[-1]}")


# ---------------------------------------------------------------------------
# the netlib shapes, config 4, config 2, config 1 and the registry, twopass,
# the CLI and checked_solve
# ---------------------------------------------------------------------------


def _netlib_eq(name: str):
    """A fixture's standard form and its equality-form A (f64), the shapes
    config 4 solves at: afiro 27×59, sc50a 50×98, adlittle 56×153."""
    std = netlib.load_fixture(name).lp.to_standard_form()[0]
    return std, np.asarray(std.to_equality_form().A, np.float64)


def _shape_inputs(A64, B: int, seed: int, dev, dtype=np.float32, k: int = 2):
    """A (the fixture's equality A / √n), d uniform in [0.5, 2], R (k, m, B)."""
    rng = np.random.default_rng(seed)
    m, n = A64.shape
    A = (A64 / np.sqrt(n)).astype(dtype)
    d = rng.uniform(0.5, 2.0, size=(B, n)).astype(dtype)
    R = rng.normal(size=(k, m, B)).astype(dtype)
    return (torch.from_numpy(A).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(R).to(dev))


def _per_instance_M(A3, d, reg_eps):
    """M and reg exactly as BatchLastKernels.factor forms them for a
    per-instance (B, m, n) A (ops/batchlast.py), with TF32 off as in a solve."""
    with hsd_mod._full_precision_matmuls():
        reg = (reg_eps * torch.einsum("bmn,bn->bm", A3 * A3, d).amax(dim=-1)).to(d.dtype)
        return ((A3 * d[:, None, :]) @ A3.mT).permute(1, 2, 0).contiguous(), reg


def phase_netlib_kernels(dev, smi: str) -> dict:
    """Every kernel against its plain version at the shapes the netlib
    paths give it: the f32 four at m = 27/50/56 and B = 1/300/8,192,
    chol_bl on a per-instance M (m = 56, B = 300), the FP64 pair and the
    slicing at m = 27/56, B = 300; times at m = 56, B = 8,192.  Returns
    {name: {"err": max abs err, "held_at": [...], "ms": t, "plain_ms": t}}."""
    res = {k: {"err": 0.0, "held_at": []} for k in SOURCES}
    zero_counts()

    def hold(name, err_abs, rel, bound, shape):
        check(rel < bound, f"{name} vs plain at {shape}: rel {rel:.2e} (bound {bound})")
        res[name]["err"] = max(res[name]["err"], err_abs)
        if shape not in res[name]["held_at"]:
            res[name]["held_at"].append(shape)

    for fx in ("afiro", "sc50a", "adlittle"):
        _, A64 = _netlib_eq(fx)
        m, n = A64.shape
        for B in NETLIB_B:
            A, d, R = _shape_inputs(A64, B, seed=B + m, dev=dev)
            shape = f"m={m}, n={n}, B={B}"
            W = bl.BATCHLAST_KERNELS.prepare(A).W
            dT = d.T.contiguous()
            M_bl, reg = _formed(A, d, 1e-6)
            L_k, dinv_k = bl._chol_bl_cuda(M_bl, reg)
            L_p, dinv_p = bl._chol_bl_plain(M_bl, reg)
            Lf_k, dinvf_k = bl._fused_factor_bl_cuda(W, dT, reg)
            Lf_p, dinvf_p = bl._fused_factor_bl_plain(W, dT, reg)
            torch.cuda.synchronize()
            hold("chol_bl", max(abs_err(_lower(L_k), _lower(L_p)), abs_err(dinv_k, dinv_p)),
                 max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p)), KERNEL_RTOL, shape)
            hold("fused_factor_bl",
                 max(abs_err(_lower(Lf_k), _lower(Lf_p)), abs_err(dinvf_k, dinvf_p)),
                 max(rel_err(_lower(Lf_k), _lower(Lf_p)), rel_err(dinvf_k, dinvf_p)),
                 KERNEL_RTOL, shape)
            e_fsplit = max(rel_err(_lower(Lf_k), _lower(L_k)), rel_err(dinvf_k, dinv_k))
            check(e_fsplit < KERNEL_RTOL,
                  f"fused_factor_bl vs chol_bl at {shape}: rel {e_fsplit:.2e}")
            rels = [f"fused_factor vs chol_bl {e_fsplit:.1e}"]
            for k in (1, 2):
                Rk = R[:k].contiguous()
                V_k = bl._solve_bl_cuda(L_k, dinv_k, Rk)
                V_p = bl._solve_bl_plain(L_k, dinv_k, Rk)
                Lc, dinv_c, Vc = bl._facsol_bl_cuda(M_bl.clone(), reg, Rk)
                Lp, dinv_cp, Vp = bl._facsol_bl_plain(M_bl.clone(), reg, Rk)
                torch.cuda.synchronize()
                hold("solve_bl", abs_err(V_k, V_p), rel_err(V_k, V_p), KERNEL_RTOL, f"{shape}, k=1/2")
                e_fs = max(rel_err(_lower(Lc), _lower(Lp)), rel_err(dinv_c, dinv_cp), rel_err(Vc, Vp))
                hold("facsol_bl", max(abs_err(_lower(Lc), _lower(Lp)), abs_err(dinv_c, dinv_cp),
                                      abs_err(Vc, Vp)), e_fs, KERNEL_RTOL, f"{shape}, k=1/2")
                e_csplit = max(rel_err(_lower(Lc), _lower(L_k)), rel_err(dinv_c, dinv_k),
                               rel_err(Vc, V_k))
                check(e_csplit < KERNEL_RTOL,
                      f"facsol_bl k={k} vs chol_bl + solve_bl at {shape}: rel {e_csplit:.2e}")
                rels.append(f"solve k={k} {rel_err(V_k, V_p):.1e}, facsol k={k} {e_fs:.1e} (vs "
                            f"chol_bl + solve_bl {e_csplit:.1e})")
            say("netlib kernels", f"{fx} {shape}: chol rel "
                f"{max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p)):.1e}, "
                f"fused_factor rel {rel_err(_lower(Lf_k), _lower(Lf_p)):.1e}, " + ", ".join(rels))
            if B == 300:
                _nan_lane_f32(A, d, R, "netlib kernels", f"{fx} {shape}")

    # per-instance M: the padded netlib batch (three distinct 56×153 A)
    stds = [_netlib_eq(fx)[0] for fx in netlib.fixture_names()]
    A_pad, _, _, _, _ = netlib.pad_and_mask(stds, np.float64)
    mp = A_pad.shape[1]
    A_eq = np.concatenate([A_pad, np.broadcast_to(np.eye(mp), (len(stds), mp, mp))], axis=2)
    B = 300
    rng = np.random.default_rng(56)
    A3 = torch.from_numpy(A_eq[np.arange(B) % len(stds)].astype(np.float32)).to(dev)
    d = torch.from_numpy(rng.uniform(0.5, 2.0, size=(B, A_eq.shape[2])).astype(np.float32)).to(dev)
    M_bl, reg = _per_instance_M(A3, d, 1e-6)
    L_k, dinv_k = bl._chol_bl_cuda(M_bl, reg)
    L_p, dinv_p = bl._chol_bl_plain(M_bl, reg)
    torch.cuda.synchronize()
    shape = f"per-instance M, m={mp}, n={A_eq.shape[2]}, B={B}"
    e = max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p))
    hold("chol_bl", max(abs_err(_lower(L_k), _lower(L_p)), abs_err(dinv_k, dinv_p)), e,
         KERNEL_RTOL, shape)
    say("netlib kernels", f"chol_bl on a {shape}: rel {e:.1e}")

    # the FP64 pair and the slicing at m = 27 and 56
    for fx in ("afiro", "adlittle"):
        _, A64 = _netlib_eq(fx)
        m, n = A64.shape
        A, d, R = _shape_inputs(A64, 300, seed=m, dev=dev, dtype=np.float64)
        shape = f"m={m}, n={n}, B=300"
        M_bl, reg = _formed64(A, d, 1e-12)
        L_k, dinv_k = df64._df_chol_bl_cuda(M_bl, reg)
        L_p, dinv_p = df64._df_chol_bl_plain(M_bl, reg)
        torch.cuda.synchronize()
        e_chol = max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p))
        hold("df_chol_bl", max(abs_err(_lower(L_k), _lower(L_p)), abs_err(dinv_k, dinv_p)),
             e_chol, F64_RTOL, shape)
        line = [f"{fx} {shape}: df_chol rel {e_chol:.1e}"]
        for k in (1, 2):
            Rk = R[:k].contiguous()
            V_k = df64._df_solve_bl_cuda(L_k, dinv_k, Rk)
            V_p = df64._df_solve_bl_plain(L_k, dinv_k, Rk)
            torch.cuda.synchronize()
            hold("df_solve_bl", abs_err(V_k, V_p), rel_err(V_k, V_p), F64_RTOL, f"{shape}, k=1/2")
            line.append(f"df_solve k={k} rel {rel_err(V_k, V_p):.1e}")
        _nan_lane_f64(A, d, R, "netlib kernels", f"{fx} {shape}")
        # slicing: bit-identical, at r = 2·m (an Ozaki matvec operand pair)
        r = 2 * m
        for s_, n_slices in _slicing_bit_identical(np.random.default_rng(r), r, 300, n, dev):
            hold("slice_rounds_bl", 0.0, 0.0, 1.0, f"r={r}, B=300, s={s_}, n_slices={n_slices}")
        line.append(f"slice_rounds_bl ({r}, 300) bit-identical")
        say("netlib kernels", "; ".join(line))

    # times at m = 56 (adlittle), B = 8,192, in turns
    _, A64 = _netlib_eq("adlittle")
    B = NETLIB_B[-1]
    A, d, R = _shape_inputs(A64, B, seed=1, dev=dev)
    m, n = A64.shape
    W = bl.BATCHLAST_KERNELS.prepare(A).W
    Wp = bl.pack_w(W)
    dT = d.T.contiguous()
    M_bl, reg = _formed(A, d, 1e-6)
    L, dinv = bl._chol_bl_cuda(M_bl, reg)
    R1, R2 = R[:1].contiguous(), R.contiguous()
    Mw = torch.empty_like(M_bl)

    counts = read_counts()
    for name in ("fused_factor_bl", "facsol_bl"):
        check(counts[f"{name}_smem"] == counts[name] > 0,
              f"netlib kernels: {name} launched {counts[name]} times, {counts[name + '_smem']} of "
              "them on the lane-group design")
    say("netlib kernels", f"every fused_factor_bl ({counts['fused_factor_bl']}) and facsol_bl "
        f"({counts['facsol_bl']}) launch at m = 27/50/56 ran the lane-group design")

    def facsol(design=None):
        Mw.copy_(M_bl)
        return bl._facsol_bl_cuda(Mw, reg, R2, design=design)

    def facsol_plain():
        Mw.copy_(M_bl)
        return bl._facsol_bl_plain(Mw, reg, R2)

    def split():
        Mw.copy_(M_bl)
        Ls, dinv_s = bl._chol_bl_cuda(Mw, reg)
        return bl._solve_bl_cuda(Ls, dinv_s, R2)

    at = f"m={m}, n={n}, B={B}"
    two = {
        "chol_bl": designs_in_turns(f"chol_bl at {at}", lambda: bl._chol_bl_cuda(M_bl, reg),
                                    lambda: bl._chol_bl_cuda(M_bl, reg, design="stream"),
                                    lambda: bl._chol_bl_plain(M_bl, reg)),
        "solve_bl": designs_in_turns(f"solve_bl k=1 at {at}",
                                     lambda: bl._solve_bl_cuda(L, dinv, R1),
                                     lambda: bl._solve_bl_cuda(L, dinv, R1, design="stream"),
                                     lambda: bl._solve_bl_plain(L, dinv, R1)),
        "fused_factor_bl": designs_in_turns(
            f"fused_factor_bl at {at}", lambda: bl._fused_factor_bl_cuda(W, dT, reg, Wp=Wp),
            lambda: bl._fused_factor_bl_cuda(W, dT, reg, design="stream"),
            lambda: bl._fused_factor_bl_plain(W, dT, reg)),
        "facsol_bl": designs_in_turns(f"facsol_bl k=2 (with the copy of M) at {at}", facsol,
                                      lambda: facsol("stream"), facsol_plain),
    }
    _, two["fused_factor_bl"]["split_ms"] = in_turns(
        f"fused_factor_bl vs the split path (matmul + chol_bl) at {at}",
        lambda: bl._fused_factor_bl_cuda(W, dT, reg, Wp=Wp),
        lambda: bl._chol_bl_cuda((W @ dT).reshape(m, m, B), reg))
    _, two["facsol_bl"]["split_ms"] = in_turns(
        f"facsol_bl k=2 vs the split path (chol_bl + solve_bl k=2) at {at}", facsol, split)
    fused, facsol_b = _fused_bounds(m, n, B)
    bounds = {"chol_bl": chol_bound(m, B, torch.float32),
              "solve_bl": solve_bound(m, B, 1, torch.float32),
              "fused_factor_bl": fused, "facsol_bl": facsol_b}
    for name, t in two.items():
        res[name].update(t)
        res[name]["bound_ms"] = bounds[name]["bound_ms"]
    say("netlib kernels", f"the times above at {at} on {smi}")
    return res


def audit_eq(A, b, c, objective, lanes) -> dict:
    """scipy highs on equality-form lanes (A shared or per lane):
    {lane: relative objective error}."""
    from scipy.optimize import linprog

    rels = {}
    for i in lanes:
        Ai = np.asarray(A[i] if A.ndim == 3 else A, np.float64)
        res = linprog(np.asarray(c[i], np.float64), A_eq=Ai, b_eq=np.asarray(b[i], np.float64),
                      bounds=(0, None), method="highs")
        check(res.status == 0, f"scipy could not solve lane {i}: {res.message}")
        rels[int(i)] = abs(float(objective[i]) - res.fun) / max(1.0, abs(res.fun))
    return rels


def _audit_netlib(label: str, A, b, c, obj, status) -> None:
    """64 evenly spaced lanes (≤ 1e-6 each where OPTIMAL) and up to 64
    non-OPTIMAL lanes (reported)."""
    opt = status == int(Status.OPTIMAL)
    lanes = np.linspace(0, len(obj) - 1, 64, dtype=int)
    rels = audit_eq(A, b, c, obj, lanes)
    bounded = {i: e for i, e in rels.items() if opt[i]}
    worst = max(bounded, key=bounded.get)
    say(label, f"audit: scipy highs on 64 evenly spaced lanes ({len(bounded)} OPTIMAL), max "
        f"relative objective error {bounded[worst]:.4e} at lane {worst} (limit {CONTRACT})")
    check(bounded[worst] <= CONTRACT, f"{label}: audit max {bounded[worst]:.3e} > {CONTRACT}")
    stragglers = np.flatnonzero(~opt)[:64]
    if len(stragglers):
        srels = audit_eq(A, b, c, obj, stragglers)
        say(label, f"{len(stragglers)} non-OPTIMAL lanes (reported, not bounded): "
            + ", ".join(f"{i} {Status(int(status[i])).name} {e:.2e}" for i, e in srels.items()))


def _timed_solve(A, b, c, opts, dev):
    """hsd_solve_batched on BATCHLAST_KERNELS twice; the second is timed
    (ended by the pull of the statuses) and counted."""
    hsd_mod.hsd_solve_batched(A, b, c, opts, bl.BATCHLAST_KERNELS, device=dev)["status"].cpu()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = hsd_mod.hsd_solve_batched(A, b, c, opts, bl.BATCHLAST_KERNELS, device=dev)
    status = out["status"].cpu().numpy()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_smem_route("netlib", counts)
    return out["objective"].cpu().numpy(), status, wall, counts


def _netlib_buckets():
    """Config 4's replicas as bench.py's run_netlib builds them: per
    bucket (one fixture each), its index, A, b (scaled per replica), c
    and the scales; and the fixtures' names and standard forms."""
    names = netlib.fixture_names()
    stds = [_netlib_eq(nm)[0] for nm in names]
    rng = np.random.default_rng(7)
    out = []
    for _, idxs in sorted(netlib.bucket_problems(stds).items()):
        check(len(idxs) == 1, "a netlib bucket holds more than one structure")
        i = idxs[0]
        eq = stds[i].to_equality_form()
        scale = (1.0 + 0.1 * rng.random((NETLIB_REPS, 1))).astype(np.float32)
        A = np.asarray(eq.A, np.float32)
        b = np.asarray(eq.b, np.float32).reshape(1, -1) * scale
        c = np.ascontiguousarray(np.broadcast_to(np.asarray(eq.c, np.float32).reshape(1, -1),
                                                 (NETLIB_REPS, eq.c.shape[-1])))
        out.append((i, A, b, c, scale[:, 0]))
    return names, stds, out


def _netlib_padded(stds, buckets):
    """The padded heterogeneous batch of the buckets' replicas, in bucket
    order: per-instance equality-form A3, b3 and c3 (f32, on the host)."""
    order = [i for i, *_ in buckets]
    A_pad, b_pad, c_pad, _, _ = netlib.pad_and_mask([stds[i] for i in order], np.float32)
    mp = A_pad.shape[1]
    eye = np.broadcast_to(np.eye(mp, dtype=np.float32), (len(order), mp, mp))
    A_eq = np.concatenate([A_pad, eye], axis=2)
    c_eq = np.concatenate([-c_pad, np.zeros((len(order), mp), np.float32)], axis=1)
    lane_of = np.repeat(np.arange(len(order)), NETLIB_REPS)
    A3 = np.ascontiguousarray(A_eq[lane_of])
    b3 = b_pad[lane_of].copy()
    for k, (i, *_, scale) in enumerate(buckets):
        b3[k * NETLIB_REPS:(k + 1) * NETLIB_REPS, :stds[i].nrows] *= scale[:, None]
    c3 = np.ascontiguousarray(c_eq[lane_of])
    return A3, b3, c3


def phase_netlib(smi: str, dev) -> dict:
    """Config 4 as bench.py's run_netlib builds it, at 8,192 replicas per
    fixture: one shared-A solve per bucket, then the padded heterogeneous
    batch (per-instance A) of the same replicas."""
    opts = SolverOptions(**BENCH_OPTIONS)
    names, stds, buckets = _netlib_buckets()
    say("netlib", f"buckets {[names[i] for i, *_ in buckets]}")
    counts = {k: 0 for k in SOURCES}
    bucketed, walls = [], []
    for i, A, b, c, _ in buckets:
        obj, status, wall, cnt = _timed_solve(A, torch.from_numpy(b).to(dev),
                                              torch.from_numpy(c).to(dev), opts, dev)
        check(cnt["chol_bl"] > 0 and cnt["solve_bl"] > 0,
              f"netlib {names[i]}: chol_bl / solve_bl were never launched")
        for k in SOURCES:
            counts[k] += cnt[k]
        say("netlib", f"{names[i]} ({A.shape[0]}x{A.shape[1]}, shared A, {NETLIB_REPS} replicas): "
            f"status mix {status_mix(status)}; second solve {wall:.3f}s = "
            f"{NETLIB_REPS / wall:.1f} LP/s; launches {cnt} on {smi}")
        check((status == int(Status.OPTIMAL)).mean() >= MAIN_OPTIMAL,
              f"netlib {names[i]}: OPTIMAL share {(status == 0).mean():.4f}")
        _audit_netlib(f"netlib {names[i]}", A, b, c, obj, status)
        bucketed.append((obj, status))
        walls.append(wall)
    total = NETLIB_REPS * len(buckets)
    say("netlib", f"bucketed batch: {total} LPs over {len(buckets)} buckets in {sum(walls):.3f}s = "
        f"{total / sum(walls):.1f} LP/s on {smi}")

    # the padded heterogeneous batch of the same replicas: per-instance A
    A3, b3, c3 = _netlib_padded(stds, buckets)
    say("netlib padded", f"{A3.shape[0]} lanes, per-instance A {A3.shape[1]}x{A3.shape[2]} "
        f"({A3.nbytes / 2**30:.2f} GiB in f32)")
    obj, status, wall, cnt = _timed_solve(torch.from_numpy(A3).to(dev), torch.from_numpy(b3).to(dev),
                                          torch.from_numpy(c3).to(dev), opts, dev)
    check(cnt["chol_bl"] > 0 and cnt["solve_bl"] > 0, "netlib padded: chol_bl / solve_bl never launched")
    for k in SOURCES:
        counts[k] += cnt[k]
    say("netlib padded", f"status mix {status_mix(status)}; second solve {wall:.3f}s = "
        f"{A3.shape[0] / wall:.1f} LP/s; launches {cnt} on {smi}")
    ref_obj = np.concatenate([o for o, _ in bucketed])
    ref_st = np.concatenate([s for _, s in bucketed])
    both = (status == int(Status.OPTIMAL)) & (ref_st == int(Status.OPTIMAL))
    rel = np.abs(obj - ref_obj) / np.maximum(1.0, np.abs(ref_obj))
    say("netlib padded", f"vs bucketed: {both.sum()}/{len(both)} lanes OPTIMAL in both, max "
        f"relative objective difference {rel[both].max():.3e} (limit {CONTRACT}); padded/bucketed "
        f"cost ratio {wall / sum(walls):.3f} ({wall:.3f}s vs {sum(walls):.3f}s)")
    check(both.mean() >= MAIN_OPTIMAL, f"netlib padded: OPTIMAL in both on {both.mean():.4f}")
    check(rel[both].max() <= CONTRACT, f"netlib padded vs bucketed: {rel[both].max():.3e}")
    _audit_netlib("netlib padded", A3, b3, c3, obj, status)
    return counts


def phase_config2(smi: str) -> dict:
    """Config 2 (batch32) at 65,536 lanes: 32×32 LPs on the main path."""
    run = _scan_path(smi, bl.BATCHLAST_KERNELS, "config 2 (32x32)", ("second",), m=32, n=32)
    _audit_main("config 2 (32x32)", run["lp"], run["objective"], run["status"])
    check(run["total"]["chol_bl"] > 0, "config 2: chol_bl was never launched")
    return run["total"]


def phase_config1(smi: str) -> dict:
    """Config 1 (bench.py run_correctness) through hsd_pallas on the card,
    every registry backend on the same batch (schur, with no process
    group, on a mesh of one device), and dense_path in f32 on
    BATCHLAST_KERNELS against the reference set."""
    lp = random_standard_lp(30, 50, nlp=64, seed=1)

    def max_rel(obj):
        return max(audit(lp, obj, range(64)).values())

    zero_counts()
    s = get_solver("hsd_pallas", device="cuda", tol=1e-7, dtype="float32", finish_dtype="float64")
    s.init(lp)
    sol = s.solve()
    counts = read_counts()
    check_smem_route("config 1", counts)
    e = max_rel(sol.objective)
    say("config 1", f"hsd_pallas f32 + f64 finish on 64 LPs of 30x50: status mix "
        f"{status_mix(sol.status)}; max rel vs scipy {e:.3e} (limit {CONTRACT}); launches {counts} "
        f"on {smi}")
    check(e <= CONTRACT, f"config 1: max rel {e:.3e}")
    check(counts["chol_bl"] > 0, "config 1: chol_bl was never launched")

    names = available_solvers()
    check(names == ["cpp_hsd", "dense_path", "hsd", "hsd_pallas", "schur", "scipy"],
          f"available_solvers() = {names}")
    line = []
    for name in names:
        s = get_solver(name, tol=1e-8, device="cuda")
        s.init(lp)
        sol = s.solve()
        e = max_rel(sol.objective)
        check((np.asarray(sol.status) == int(Status.OPTIMAL)).all(), f"registry {name}: not all OPTIMAL")
        check(e <= CONTRACT, f"registry {name}: max rel vs scipy {e:.3e}")
        line.append(f"{name} {e:.2e}")
    say("registry", "every backend on config 1's batch, max rel vs scipy: " + ", ".join(line))

    # dense_path in f32: the batch-last kernels vs the reference set, both on
    # the card; bounds from the CPU run (96.9-98.4% agreement, 3.9e-6-8.3e-6)
    eq = lp.to_equality_form()
    A, b, c = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c))
    o32 = SolverOptions(tol=1e-4, maxiter=40, dtype="float32")
    zero_counts()
    out = dense_path_solve_batched(A, b, c, o32, bl.BATCHLAST_KERNELS, device="cuda")
    st = out["status"].cpu().numpy()
    dcounts = read_counts()
    check_smem_route("dense_path f32", dcounts)
    ref_out = dense_path_solve_batched(A, b, c, o32, REFERENCE_KERNELS, device="cuda")
    rst = ref_out["status"].cpu().numpy()
    both = (st == int(Status.OPTIMAL)) & (rst == int(Status.OPTIMAL))
    o, ro = out["objective"].cpu().numpy(), ref_out["objective"].cpu().numpy()
    rel = np.abs(o - ro) / np.maximum(1.0, np.abs(ro))
    agree = float((st == rst).mean())
    say("dense_path f32", f"BATCHLAST_KERNELS {status_mix(st)} vs reference set {status_mix(rst)}: "
        f"status agreement {agree:.4%} (limit 90%), {both.sum()} lanes OPTIMAL in both, max rel "
        f"{rel[both].max() if both.any() else float('nan'):.3e} (limit 1e-4); launches {dcounts} "
        f"on {smi}")
    check(dcounts["chol_bl"] > 0 and dcounts["solve_bl"] > 0, "dense_path f32: kernels not launched")
    check(agree >= 0.9, f"dense_path f32: status agreement {agree:.4f}")
    check(both.any() and rel[both].max() <= 1e-4, "dense_path f32: objectives disagree")
    return counts


def phase_twopass(smi: str) -> dict:
    """hsd_solve_two_pass: the per-instance ladder on 4,096 lanes, and the
    shared-A delegation against hsd_solve_scan, on BATCHLAST_KERNELS."""
    kw = {k: v for k, v in SOLVER_KW.items() if k not in ("chunk", "compact_cap", "compact_bucket")}
    opts = SolverOptions(**kw)
    lp = random_standard_lp(32, 32, nlp=TWOPASS_N, seed=11, dtype=np.float32, shared_A=False)
    eq = lp.to_equality_form()
    A, b, c = (torch.from_numpy(np.asarray(v, np.float32)).to(CARD) for v in (eq.A, eq.b, eq.c))
    keys = ("objective", "status", "iterations")
    zero_counts()
    t0 = time.perf_counter()
    two = hsd_solve_two_pass(A, b, c, opts, bl.BATCHLAST_KERNELS, pass1_maxiter=TWOPASS_CAP,
                             min_bucket=1024, keys=keys, device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_smem_route("twopass", counts)
    full = hsd_mod.hsd_solve_batched(A, b, c, opts, bl.BATCHLAST_KERNELS, device="cuda")
    agree = float((two["status"] == full["status"].cpu().numpy()).mean())
    remnant = int((two["iterations"] > TWOPASS_CAP).sum())
    say("twopass", f"{TWOPASS_N} per-instance 32x64 lanes: {wall:.3f}s; status mix "
        f"{status_mix(two['status'])}; lanes re-solved in pass 2 past the cap of {TWOPASS_CAP} "
        f"{remnant}; status agreement with one full-budget solve {agree:.4%} (limit 99%); "
        f"launches {counts} on {smi}")
    check(counts["chol_bl"] > 0, "twopass: chol_bl was never launched")
    check(remnant > 0, "twopass: no lane reached pass 2")
    check(agree >= 0.99, f"twopass: status agreement {agree:.4f}")

    N2 = 2 * TWOPASS_N
    _, A2, b2, c2 = _bench_problem(N2)
    two = hsd_solve_two_pass(A2, b2, c2, opts, bl.BATCHLAST_KERNELS, chunk=TWOPASS_N,
                             pass1_maxiter=12, keys=keys, device="cuda")
    scan = hsd_mod.hsd_solve_scan(A2, b2, c2, opts, bl.BATCHLAST_KERNELS, chunk=TWOPASS_N,
                                  keys=keys, compact_cap=12, compact_bucket=N2, device="cuda")
    same = all(np.array_equal(two[k], scan[k].cpu().numpy()) for k in keys)
    say("twopass", f"shared A ({N2} 64x128 lanes, chunks of {TWOPASS_N}): delegation bitwise "
        f"equal to hsd_solve_scan {same}")
    check(same, "twopass shared-A delegation differs from hsd_solve_scan")
    return counts


def phase_cli(kind: str, smi: str) -> None:
    """The CLI as a subprocess on the card: afiro from an MPS file, and info."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cli-", dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "afiro.mps")
        with open(path, "w") as f:
            f.write(write_mps(netlib.load_fixture("afiro").lp, name="AFIRO"))
        cmd = [sys.executable, "-m", "pycllp_tpu_torch", "solve", path, "--solver", "hsd_pallas",
               "--dtype", "float32", "--finish-dtype", "float64"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI solve exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    ref = netlib.FIXTURE_OBJECTIVES["afiro"]
    e = abs(out["objective"] - ref) / max(1.0, abs(ref))
    say("cli", f"python -m pycllp_tpu_torch solve afiro.mps --solver hsd_pallas --dtype float32 "
        f"--finish-dtype float64: {json.dumps(out)} in {wall:.2f}s (process start included); "
        f"rel vs FIXTURE_OBJECTIVES {e:.2e} (limit {CONTRACT}) on {smi}")
    check(out["status"] == "OPTIMAL" and e <= CONTRACT, "CLI solve: wrong answer")
    info = subprocess.run([sys.executable, "-m", "pycllp_tpu_torch", "info"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600, check=True).stdout
    say("cli", "info: " + " | ".join(info.strip().splitlines()))
    check(kind in info, f"CLI info does not name the card {kind!r}")


def phase_checked_solve(smi: str) -> None:
    """checked_solve on a clean narrow batch of TWOPASS_N lanes: an empty report."""
    kw = {k: v for k, v in SOLVER_KW.items() if k not in ("chunk", "compact_cap", "compact_bucket")}
    _, A, b, c = _bench_problem(TWOPASS_N)
    out, report = checked_solve(A, b, c, SolverOptions(**kw), bl.BATCHLAST_KERNELS, device="cuda")
    st = out["status"].cpu().numpy()
    say("checked_solve", f"{TWOPASS_N} lanes: status mix {status_mix(st)}; report {report} on {smi}")
    check(report == [] and not (st == int(Status.NUMERICAL)).any(), "checked_solve: not clean")


# ---------------------------------------------------------------------------
# the parallel layer: ranks that share the one card
# ---------------------------------------------------------------------------

# (c) of scenario_parallel: the first lanes of the main cell, solved with
# hsd_solve_batched on each rank at the main options, collective and local
PARALLEL_N = 8192
PARALLEL_AGREE = 0.999  # status agreement of (c) with the unsharded solve
ANY_REPS = 200  # CollectiveAny calls timed per rank
RANK_TIMEOUT_S = 900  # the ranks of one spawn must have ended by then
# big_lp: one dense 512 × 4,096 equality LP, B = 2, f32 + f64 finish at
# __graft_entry__.py's options; the registry's schur solver on a 512 × 3,583
# Vanderbei LP, whose equality form has 4,095 columns (odd: padded to 4,096)
BIG_M, BIG_N, BIG_B = 512, 4096, 2
BIG_STD_N = BIG_N - 1 - BIG_M
BIG_OPTIONS = dict(tol=1e-6, maxiter=40, dtype="float32", init_point="mehrotra",
                   finish_dtype="float64", switch_tol=1e-4, finish_maxiter=20)
DCHOL_RTOL = 1e-10  # the row-sharded FP64 factor vs torch.linalg.cholesky


def _spawn_ranks(fn, nprocs: int, *args, killed: bool = False) -> list:
    """Run ``fn(rank, init_file, out_dir, *args)`` on ``nprocs`` processes
    (spawn start method, ``file://`` rendezvous under ``build/``) and return
    the report each rank wrote with :func:`_report`, by rank.  Every rank
    must exit 0 or, with ``killed``, die by SIGKILL after reporting; a rank
    that raises, or runs past RANK_TIMEOUT_S, fails the run."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-", dir=os.path.join(ROOT, "build")) as tmp:
        procs = [ctx.Process(target=fn, args=(r, os.path.join(tmp, "rendezvous"), tmp) + args)
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        want = -signal.SIGKILL if killed else 0
        check(codes == [want] * nprocs, f"the ranks of {fn.__name__} exited with {codes}")
        reports = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                reports.append(pickle.load(f))  # written by _report in this run
    return reports


def _report(out_dir: str, rank: int, report: dict) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(report, f)


def _join(rank: int, init_file: str, world: int, backend: str, card: int = 0):
    """Start this rank's group on ``card``; returns the scenario mesh."""
    torch.cuda.set_device(card)
    check(parallel.initialize(f"file://{init_file}", world_size=world, rank=rank, backend=backend,
                              timeout_s=600), "the process group did not start")
    _build.load()  # the parent built the library; load it before any timing
    return parallel.scenario_mesh()


def _any_us(mesh, dev=CARD) -> float:
    """Host time of one CollectiveAny call on a 16,384-lane mask, in µs."""
    gate = parallel.CollectiveAny(mesh)
    mask = torch.zeros(16384, dtype=torch.bool, device=dev)
    gate(mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ANY_REPS):
        gate(mask)
    return (time.perf_counter() - t0) / ANY_REPS * 1e6


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return out, time.perf_counter() - t0


def _rank_scan_nccl(rank: int, init_file: str, out_dir: str) -> None:
    """(a): one rank on NCCL runs the main cell through
    sharded_hsd_solve_scan, in turns with hsd_solve_scan on the same data
    (plain, sharded, sharded, plain), after one untimed plain solve."""
    mesh = _join(rank, init_file, 1, "nccl")
    check(dist.get_backend() == "nccl" and mesh.size() == 1, "not a one-rank NCCL mesh")
    _, A, b, c = _bench_problem(N_LP)
    opts = SolverOptions(**BENCH_OPTIONS)

    def plain():
        return hsd_mod.hsd_solve_scan(A, b, c, opts, bl.BATCHLAST_KERNELS, device="cuda",
                                      **SCAN_KW)

    def sharded():
        return parallel.sharded_hsd_solve_scan(A, b, c, opts, mesh, bl.BATCHLAST_KERNELS,
                                               device="cuda", **SCAN_KW)

    _timed(plain)  # the process's first solve: allocator and library set-up
    ref, p1 = _timed(plain)
    zero_counts()
    out, s1 = _timed(sharded)
    counts = read_counts()
    _, s2 = _timed(sharded)
    _, p2 = _timed(plain)
    _report(out_dir, rank, {"ref": ref, "out": out, "counts": counts, "plain_s": (p1, p2),
                            "sharded_s": (s1, s2), "any_us": _any_us(mesh)})
    dist.destroy_process_group()


def _rank_two_on_one_card(rank: int, init_file: str, out_dir: str) -> None:
    """(b) and (c) on one of two gloo ranks that share the card: the main
    cell through sharded_hsd_solve_scan (32,768 lanes a rank), then
    sharded_hsd_solve on PARALLEL_N lanes on the fused-form set, with
    collective and with local termination."""
    mesh = _join(rank, init_file, 2, "gloo")
    _, A, b, c = _bench_problem(N_LP)
    opts = SolverOptions(**BENCH_OPTIONS)
    rep = {"any_us": _any_us(mesh)}
    zero_counts()
    rep["scan"], rep["scan_first_s"] = _timed(lambda: parallel.sharded_hsd_solve_scan(
        A, b, c, opts, mesh, bl.BATCHLAST_KERNELS, device="cuda", **SCAN_KW))
    rep["scan_counts"] = read_counts()
    _, rep["scan_s"] = _timed(lambda: parallel.sharded_hsd_solve_scan(
        A, b, c, opts, mesh, bl.BATCHLAST_KERNELS, device="cuda", **SCAN_KW))
    for term in ("collective", "local"):
        zero_counts()
        out, secs = _timed(lambda: parallel.sharded_hsd_solve(
            A, b[:PARALLEL_N], c[:PARALLEL_N], opts, mesh, bl.BATCHLAST_FUSED_KERNELS,
            termination=term, device="cuda"))
        rep[term] = {"status": out["status"], "objective": out["objective"], "s": secs,
                     "counts": read_counts()}
    if rank:  # rank 0 carries the gathered arrays; the others their counts
        rep["scan"] = None
        for term in ("collective", "local"):
            rep[term].update(status=None, objective=None)
    _report(out_dir, rank, rep)
    dist.destroy_process_group()


def _big_lp_data():
    """The big LP: one dense 512 × 4,096 equality LP with planted
    certificates, two lanes of perturbed b/c, in f32; and the schur
    solver's 512 × 3,583 Vanderbei LP (two lanes)."""
    rng = np.random.default_rng(0)
    A, b0, c0 = random_equality_lp(BIG_M, BIG_N, seed=9)
    b = np.stack([b0 * (1 + 0.05 * rng.random(BIG_M)) for _ in range(BIG_B)]).astype(np.float32)
    c = np.stack([c0 + 0.02 * rng.random(BIG_N) for _ in range(BIG_B)]).astype(np.float32)
    std = random_standard_lp(BIG_M, BIG_STD_N, nlp=BIG_B, seed=12, dtype=np.float32)
    return A.astype(np.float32), b, c, std


def _spd_fp64(seed: int = 4):
    """(2, 512, 512) FP64 SPD matrices on the card and a right-hand side."""
    g = torch.Generator(device=CARD).manual_seed(seed)
    X = torch.randn((2, BIG_M, 2 * BIG_M), generator=g, device=CARD, dtype=torch.float64)
    M = X @ X.mT + BIG_M * torch.eye(BIG_M, device=CARD, dtype=torch.float64)
    return M, torch.randn((2, BIG_M), generator=g, device=CARD, dtype=torch.float64)


def _rank_big_lp(rank: int, init_file: str, out_dir: str) -> None:
    """big_lp on one of two gloo ranks that share the card."""
    _join(rank, init_file, 2, "gloo")
    mesh = parallel.model_mesh()
    A, b, c, std = _big_lp_data()
    opts = SolverOptions(**BIG_OPTIONS)
    rep = {}
    for factor in ("replicated", "sharded"):
        out, secs = _timed(lambda: parallel.column_sharded_hsd_solve(
            A, b, c, opts, mesh, factor, device="cuda"))
        rep[factor] = {"status": out["status"], "objective": out["objective"],
                       "iterations": out["iterations"], "x_shape": out["x"].shape, "s": secs}
    solver = get_solver("schur", mesh=mesh, device="cuda", **BIG_OPTIONS)
    solver.init(std)
    t0 = time.perf_counter()
    sol = solver.solve()
    rep["schur"] = {"status": sol.status, "objective": sol.objective,
                    "iterations": sol.iterations, "x_shape": sol.x.shape,
                    "s": time.perf_counter() - t0}
    M, r = _spd_fp64()
    mb = BIG_M // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Lw, kks = rowshard_cholesky(M[:, rank * mb:(rank + 1) * mb].contiguous(), mesh, 2)
    x = rowshard_cholesky_solve(Lw, kks, r, mesh, 2)
    torch.cuda.synchronize()
    rep["dchol"] = {"Lw": Lw.cpu(), "x": x.cpu(), "s": time.perf_counter() - t0}
    _report(out_dir, rank, rep)
    dist.destroy_process_group()


def phase_scenario_parallel(smi: str) -> dict:
    """The scenario-sharded layer on the main cell: (a) one NCCL rank,
    sharded scan vs hsd_solve_scan; (b) two gloo ranks on the one card,
    the sharded scan; (c) sharded_hsd_solve on PARALLEL_N lanes, collective
    and local.  The ranks share cuda:0, so their walls measure the
    collective's cost and correctness, not scaling."""
    (a,) = _spawn_ranks(_rank_scan_nccl, 1)
    st, ref_st = a["out"]["status"], a["ref"]["status"]
    obj, ref_obj = a["out"]["objective"], a["ref"]["objective"]
    rel_a = float((np.abs(obj - ref_obj) / np.maximum(1.0, np.abs(ref_obj))).max())
    check_smem_route("scenario_parallel (a)", a["counts"])
    say("scenario_parallel", f"(a) 1 rank, NCCL: sharded_hsd_solve_scan vs hsd_solve_scan on "
        f"{N_LP} LPs: statuses equal {np.array_equal(st, ref_st)}, objective max rel {rel_a:.3e} "
        f"(limit 1e-12); walls in turns plain {a['plain_s'][0]:.3f}/{a['plain_s'][1]:.3f} s, "
        f"sharded {a['sharded_s'][0]:.3f}/{a['sharded_s'][1]:.3f} s; CollectiveAny "
        f"{a['any_us']:.1f} us a call (NCCL, 1 rank); launches {a['counts']} on {smi}")
    check(np.array_equal(st, ref_st), "(a) sharded scan statuses differ from hsd_solve_scan")
    check(rel_a <= 1e-12, f"(a) objectives differ by {rel_a:.3e}")

    lp, _, _, _ = _bench_problem(N_LP)
    ranks = _spawn_ranks(_rank_two_on_one_card, 2)
    scan = ranks[0]["scan"]
    for r, rep in enumerate(ranks):
        check_smem_route(f"scenario_parallel (b) rank {r}", rep["scan_counts"])
        for term in ("collective", "local"):
            check_smem_route(f"scenario_parallel (c) {term} rank {r}", rep[term]["counts"])
    n_opt = int((scan["status"] == int(Status.OPTIMAL)).sum())
    rel_b = np.abs(scan["objective"] - obj) / np.maximum(1.0, np.abs(obj))
    say("scenario_parallel", f"(b) 2 gloo ranks on one card, {N_LP // 2} lanes a rank: "
        f"{n_opt}/{N_LP} OPTIMAL; objectives vs (a) max rel {rel_b.max():.3e}; walls rank 0/1 "
        f"first {ranks[0]['scan_first_s']:.3f}/{ranks[1]['scan_first_s']:.3f} s, second "
        f"{ranks[0]['scan_s']:.3f}/{ranks[1]['scan_s']:.3f} s; CollectiveAny "
        f"{ranks[0]['any_us']:.1f}/{ranks[1]['any_us']:.1f} us a call (gloo through the host); "
        f"launches rank 0 {ranks[0]['scan_counts']}, rank 1 {ranks[1]['scan_counts']} on {smi}")
    check(n_opt == N_LP, f"(b) {n_opt}/{N_LP} OPTIMAL")
    _audit_main("scenario_parallel (b)", lp, -scan["objective"], scan["status"])
    check(rel_b.max() <= CONTRACT, f"(b) objectives differ from (a) by {rel_b.max():.3e}")

    # (c): against one unsharded solve of the same lanes, in this process
    _, A, b, c = _bench_problem(N_LP)
    zero_counts()
    ref = hsd_mod.hsd_solve_batched(A, b[:PARALLEL_N], c[:PARALLEL_N],
                                    SolverOptions(**BENCH_OPTIONS), bl.BATCHLAST_FUSED_KERNELS,
                                    device="cuda")
    ref_st, ref_obj = ref["status"].cpu().numpy(), ref["objective"].cpu().numpy()
    ref_steps = hsd_mod.HOST_STEPS
    for term in ("collective", "local"):
        out = ranks[0][term]
        agree = float((out["status"] == ref_st).mean())
        both = (out["status"] == int(Status.OPTIMAL)) & (ref_st == int(Status.OPTIMAL))
        rel = float((np.abs(out["objective"] - ref_obj) / np.maximum(1.0, np.abs(ref_obj)))[
            both].max())
        steps = [rep[term]["counts"]["host_steps"] for rep in ranks]
        say("scenario_parallel", f"(c) {term}: sharded_hsd_solve on {PARALLEL_N} lanes "
            f"({bl.BATCHLAST_FUSED_KERNELS.name}): status agreement with the unsharded "
            f"solve {agree:.4%} (limit {PARALLEL_AGREE:.1%}), objective max rel {rel:.3e} on "
            f"{int(both.sum())} lanes OPTIMAL in both; host-loop iterations rank 0/1 {steps} "
            f"(unsharded {ref_steps}); walls {ranks[0][term]['s']:.3f}/{ranks[1][term]['s']:.3f} "
            f"s; launches rank 0 {ranks[0][term]['counts']} on {smi}")
        check(agree >= PARALLEL_AGREE, f"(c) {term}: status agreement {agree:.4f}")
        check(rel <= CONTRACT, f"(c) {term}: objectives differ by {rel:.3e}")
        if term == "collective":
            check(steps[0] == steps[1], f"(c) collective: host-loop iterations differ {steps}")
    check(ranks[0]["collective"]["counts"]["fused_factor_bl"] > 0,
          "(c) fused_factor_bl was never launched")
    launches = {}
    for name in SOURCES:
        launches[name] = {
            "a_nccl_scan": a["counts"][name],
            "b_gloo_scan": [rep["scan_counts"][name] for rep in ranks],
            "c_collective": [rep["collective"]["counts"][name] for rep in ranks],
            "c_local": [rep["local"]["counts"][name] for rep in ranks],
        }
    return launches


def _record_savez() -> list:
    """Record the file names this process writes through ``np.savez`` from
    now on: the sweep's chunk files (each first written to its .tmp.npz)."""
    written = []
    savez = np.savez

    def recording(path, **arrays):
        written.append(os.path.basename(path))
        savez(path, **arrays)

    np.savez = recording
    return written


def _rank_sweep(rank: int, init_file: str, out_dir: str, sweep_dir: str, backend: str,
                kill_after: int) -> None:
    """config 5's sharded form on one of two ranks: scenario_sweep(mesh=)
    into ``sweep_dir``, each chunk through sharded_hsd_solve with
    CollectiveAny.  With ``kill_after`` > 0 the rank reports and then kills
    itself with SIGKILL from the progress callback once that many chunks
    are done; otherwise it resumes the sweep and reports.  The report holds
    the host-loop count after each chunk, the files written, the walls and
    the launches."""
    card = rank if backend == "nccl" else 0
    mesh = _join(rank, init_file, 2, backend, card)
    dev = torch.device(CARD.type, card)
    _, A, b, c = _bench_problem(SWEEP_PARALLEL_N, dev=dev)
    opts = SolverOptions(**BENCH_OPTIONS)
    rep = {"any_us": _any_us(mesh, dev), "steps": [], "done": []}
    written = _record_savez()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def progress(done, total):
        rep["steps"].append(hsd_mod.HOST_STEPS)
        rep["done"].append(done)
        if kill_after and done >= kill_after:
            rep.update(written=list(written), s=time.perf_counter() - t0, counts=read_counts())
            _report(out_dir, rank, rep)
            os.kill(os.getpid(), signal.SIGKILL)

    res = scenario_sweep(A, b, c, opts, chunk=SWEEP_KW["chunk"], out_dir=sweep_dir, mesh=mesh,
                         progress=progress, kset=bl.BATCHLAST_FUSED_KERNELS, device=dev)
    check(not kill_after, "the sharded sweep ran to its end: it was not killed")
    rep.update(written=list(written), s=time.perf_counter() - t0, counts=read_counts(),
               status=res.status, objective=res.objective, n_resumed=res.n_resumed)
    _report(out_dir, rank, rep)
    dist.destroy_process_group()


def _per_chunk(rep: dict) -> dict:
    """{chunk: host-loop iterations} of the chunks a sweep solved (a loaded
    chunk adds none)."""
    steps = np.diff([0] + rep["steps"])
    return {d - 1: int(s) for d, s in zip(rep["done"], steps) if s}


def phase_sweep_parallel(smi: str, backend: str = "gloo") -> dict:
    """Config 5's sharded form: scenario_sweep(mesh=) on two ranks
    (``gloo``: both share cuda:0; ``nccl``: one card each), killed by
    SIGKILL after SWEEP_PARALLEL_KILL chunks and resumed by a fresh group,
    against the unsharded sweep (solve_fn = hsd_solve_batched) here.
    Returns the resumed group's launches per kernel and rank."""
    n_chunks = -(-SWEEP_PARALLEL_N // SWEEP_KW["chunk"])
    label = f"sweep_parallel ({backend})"
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    sweep_dir = tempfile.mkdtemp(prefix="sweep-parallel-", dir=os.path.join(ROOT, "build"))
    try:
        killed = _spawn_ranks(_rank_sweep, 2, sweep_dir, backend, SWEEP_PARALLEL_KILL,
                              killed=True)
        on_disk = _chunk_files(sweep_dir)
        check(on_disk == [f"chunk_{k:06d}.npz" for k in range(SWEEP_PARALLEL_KILL)]
              and os.path.exists(os.path.join(sweep_dir, "manifest.json")),
              f"{label}: after the kill the directory holds {sorted(os.listdir(sweep_dir))}")
        tmp = _stale_tmp(os.path.join(sweep_dir, f"chunk_{SWEEP_PARALLEL_KILL:06d}.npz"),
                         SWEEP_KW["chunk"])
        resumed = _spawn_ranks(_rank_sweep, 2, sweep_dir, backend, 0)
        check(not os.path.exists(tmp), f"{label}: the stale temporary file is still there")
        check(_chunk_files(sweep_dir) == [f"chunk_{k:06d}.npz" for k in range(n_chunks)],
              f"{label}: after the resume the directory holds {sorted(os.listdir(sweep_dir))}")
    finally:
        shutil.rmtree(sweep_dir, ignore_errors=True)

    # the unsharded reference: the same sweep, each chunk one hsd_solve_batched
    _, A, b, c = _bench_problem(SWEEP_PARALLEL_N)
    opts = SolverOptions(**BENCH_OPTIONS)
    ref_rep = {"steps": [], "done": []}

    def unsharded(Ab, bb, cb):
        return hsd_mod.hsd_solve_batched(Ab, bb, cb, opts, bl.BATCHLAST_FUSED_KERNELS,
                                         device="cuda")

    def progress(done, total):
        ref_rep["steps"].append(hsd_mod.HOST_STEPS)
        ref_rep["done"].append(done)

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = scenario_sweep(A, b, c, opts, chunk=SWEEP_KW["chunk"], solve_fn=unsharded,
                         progress=progress, device="cuda")
    ref_s = time.perf_counter() - t0
    ref_steps = _per_chunk(ref_rep)

    for r in range(2):
        check_smem_route(f"{label} killed rank {r}", killed[r]["counts"])
        check_smem_route(f"{label} resumed rank {r}", resumed[r]["counts"])
        check(resumed[r]["n_resumed"] == SWEEP_PARALLEL_KILL,
              f"{label}: rank {r} loaded {resumed[r]['n_resumed']} chunks")
    steps = [{**_per_chunk(killed[r]), **_per_chunk(resumed[r])} for r in range(2)]
    check(steps[0] == steps[1] == ref_steps,
          f"{label}: host-loop iterations per chunk rank 0 {steps[0]}, rank 1 {steps[1]}, "
          f"unsharded {ref_steps}")
    check(killed[1]["written"] == [] and resumed[1]["written"] == [],
          f"{label}: rank 1 wrote {killed[1]['written'] + resumed[1]['written']}")
    want = [[f"chunk_{k:06d}.npz.tmp.npz" for k in ks]
            for ks in (range(SWEEP_PARALLEL_KILL), range(SWEEP_PARALLEL_KILL, n_chunks))]
    check([killed[0]["written"], resumed[0]["written"]] == want,
          f"{label}: rank 0 wrote {killed[0]['written']} then {resumed[0]['written']}")
    out = resumed[0]
    same = bool(np.array_equal(out["status"], ref.status))
    rel = np.abs(out["objective"] - ref.objective) / np.maximum(1.0, np.abs(ref.objective))
    bitwise = bool(np.array_equal(out["objective"], ref.objective))
    for r in range(1, 2):
        check(np.array_equal(resumed[r]["status"], out["status"])
              and np.array_equal(resumed[r]["objective"], out["objective"]),
              f"{label}: the ranks' answers differ")
    solved = SWEEP_PARALLEL_N - SWEEP_PARALLEL_KILL * SWEEP_KW["chunk"]
    say(label, f"{SWEEP_PARALLEL_N} scenarios = {n_chunks} chunks (the last holds "
        f"{SWEEP_PARALLEL_N - (n_chunks - 1) * SWEEP_KW['chunk']}), 2 ranks ({backend}), "
        f"fused-form set, one sharded_hsd_solve a chunk: killed (SIGKILL, both ranks) after "
        f"{SWEEP_PARALLEL_KILL} chunks in {killed[0]['s']:.3f}/{killed[1]['s']:.3f}s = "
        f"{SWEEP_PARALLEL_KILL * SWEEP_KW['chunk'] / killed[0]['s']:.1f} scenarios/s; a fresh "
        f"group loaded {out['n_resumed']} and solved {n_chunks - out['n_resumed']} in "
        f"{out['s']:.3f}/{resumed[1]['s']:.3f}s = {solved / out['s']:.1f} scenarios/s "
        f"({out['s'] / (n_chunks - out['n_resumed']):.3f}s a chunk); unsharded sweep "
        f"{ref_s:.3f}s ({ref_s / n_chunks:.3f}s a chunk); CollectiveAny "
        f"{out['any_us']:.1f}/{resumed[1]['any_us']:.1f} us a call on {smi}")
    say(label, f"resumed vs unsharded: statuses equal {same}, objective max rel {rel.max():.3e} "
        f"(limit {SWEEP_OBJ_RTOL}), bitwise {bitwise}; host-loop iterations per chunk, both ranks "
        f"= unsharded: {ref_steps}; files written: rank 0 {len(want[0])} + {len(want[1])}, rank 1 "
        f"0; status mix {status_mix(out['status'])}; launches resumed rank 0 "
        f"{resumed[0]['counts']}")
    check(same, f"{label}: the resumed sharded sweep's statuses differ from the unsharded sweep's")
    check(rel.max() <= SWEEP_OBJ_RTOL, f"{label}: objectives differ by {rel.max():.3e}")
    return {name: [rep["counts"][name] for rep in resumed] for name in SOURCES}


def _highs(job) -> float:
    """scipy's HiGHS (interior point, then crossover) objective of one big
    LP: ``job`` is ("eq", c, A, b) or ("ub", c, A, b)."""
    from scipy.optimize import linprog

    form, cost, A, rhs = job
    kw = dict(A_eq=A, b_eq=rhs) if form == "eq" else dict(A_ub=A, b_ub=rhs)
    res = linprog(cost, bounds=[(0, None)] * A.shape[1], method="highs-ipm", **kw)
    if res.status != 0:
        raise RuntimeError(f"highs could not solve the big LP: {res.message}")
    return float(res.fun)


def phase_big_lp(smi: str) -> None:
    """The column-sharded big LP on two gloo ranks that share the card: both
    factor strategies, the registry's schur solver (odd n, padded), and the
    row-sharded FP64 factor against torch.linalg.cholesky; audited against
    HiGHS, whose four solves run in a pool after the ranks are done."""
    ranks = _spawn_ranks(_rank_big_lp, 2)
    A, b, c, std = _big_lp_data()
    A64 = A.astype(np.float64)
    jobs = [("eq", c[i].astype(np.float64), A64, b[i].astype(np.float64)) for i in range(BIG_B)]
    jobs += [("ub", -np.asarray(std.c[i], np.float64), np.asarray(std.A, np.float64),
              np.asarray(std.b[i], np.float64)) for i in range(BIG_B)]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        funs = list(pool.map(_highs, jobs))
    highs_s = time.perf_counter() - t0
    for label in ("replicated", "sharded", "schur"):
        outs = [rep[label] for rep in ranks]
        for rep in outs[1:]:
            check(np.array_equal(rep["status"], outs[0]["status"])
                  and np.array_equal(rep["objective"], outs[0]["objective"]),
                  f"big_lp {label}: the ranks' answers differ")
        out = outs[0]
        if label == "schur":  # the registry's answer is in Vanderbei (max) form
            ref = funs[BIG_B:]
            rels = [abs(float(out["objective"][i]) + ref[i]) / max(1.0, abs(ref[i]))
                    for i in range(BIG_B)]
            shape = f"{BIG_M}x{BIG_STD_N} Vanderbei (equality form {BIG_M}x{BIG_N - 1}, padded)"
            want_x = (BIG_B, BIG_STD_N)
        else:
            rels = [abs(float(out["objective"][i]) - funs[i]) / max(1.0, abs(funs[i]))
                    for i in range(BIG_B)]
            shape = f"{BIG_M}x{BIG_N} equality"
            want_x = (BIG_B, BIG_N)
        say("big_lp", f"{label}: {shape}, B={BIG_B}, f32 + f64 finish, 2 gloo ranks on one card: "
            f"status {out['status'].tolist()}, iterations {out['iterations'].tolist()}, rel vs "
            f"HiGHS {', '.join(f'{e:.2e}' for e in rels)} (limit {CONTRACT}); walls rank 0/1 "
            f"{outs[0]['s']:.3f}/{outs[1]['s']:.3f} s on {smi}")
        check((out["status"] == int(Status.OPTIMAL)).all(), f"big_lp {label}: not all OPTIMAL")
        check(max(rels) <= CONTRACT, f"big_lp {label}: rel vs HiGHS {max(rels):.3e}")
        check(tuple(out["x_shape"]) == want_x, f"big_lp {label}: x shape {out['x_shape']}")
    M, r = _spd_fp64()
    L = torch.linalg.cholesky(M).cpu()
    Lw = torch.cat([rep["dchol"]["Lw"] for rep in ranks], dim=1)
    rel_l = rel_err(Lw, L)
    x_ref = torch.linalg.solve(M, r[..., None])[..., 0].cpu()
    rel_x = max(rel_err(rep["dchol"]["x"], x_ref) for rep in ranks)
    say("big_lp", f"rowshard_cholesky, m={BIG_M}, B=2, FP64, 2 ranks: L vs torch.linalg.cholesky "
        f"rel {rel_l:.3e}, solve vs torch.linalg.solve rel {rel_x:.3e} (limit {DCHOL_RTOL}); "
        f"factor + solve {ranks[0]['dchol']['s']:.3f}/{ranks[1]['dchol']['s']:.3f} s on {smi}; "
        f"HiGHS audit of {len(jobs)} LPs in a pool {highs_s:.1f}s")
    check(rel_l <= DCHOL_RTOL and rel_x <= DCHOL_RTOL, "big_lp: the row-sharded factor disagrees")


def main() -> None:
    t_start = time.perf_counter()
    kind, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    measured = phase_kernels(dev)
    measured.update(phase_wide_kernels(dev))
    measured.update(phase_fused_kernels(dev))
    measured.update(phase_ozaki_kernels(dev, smi))
    lane = phase_lanemv_kernels(dev)
    narrow, narrow_status = phase_narrow_path(smi)
    phase_narrow_mix(smi, narrow_status)
    probe = phase_probes()
    main_run = phase_main_path(smi)
    profile = phase_profile(smi, main_run)
    phase_device_loop(smi, main_run)
    widths = phase_ozaki_widths(dev, smi, probe, main_run)
    form, facsol = phase_fused_paths(smi, main_run["status"])
    sweep_counts = phase_sweep(smi)
    phase_metrics()
    held = phase_netlib_kernels(dev, smi)
    netlib_counts = phase_netlib(smi, dev)
    config2 = phase_config2(smi)
    config1 = phase_config1(smi)
    twopass = phase_twopass(smi)
    phase_cli(kind, smi)
    phase_checked_solve(smi)
    parallel = phase_scenario_parallel(smi)
    sweep_parallel = phase_sweep_parallel(smi)
    if torch.cuda.device_count() > 1:  # one rank a card over NCCL
        phase_sweep_parallel(smi, backend="nccl")
    phase_big_lp(smi)
    _segment_fault_raises(smi)
    _capture_fault_raises(smi)  # last: it leaves a failed capture behind
    # launches: each kernel's count on the full main path that runs it (the
    # default set's, or the fused set's for the fused kernels; the slicing
    # pass runs only on the split route, the main cell's profiled solve with
    # every Ozaki product routed there); the narrow path's, the df64
    # probe's (which must run the FP64 factor/solve) and the sweep's beside it
    path_of = {"fused_factor_bl": ("fused-form path", form), "facsol_bl": ("facsol path", facsol),
               "slice_rounds_bl": ("main path, split route (phase_profile)",
                                   {"total": profile["split"]["counts"]})}
    report = []
    for name, r in measured.items():
        path, run = path_of.get(name, ("main path", main_run))
        report.append({"name": name, "route": "cuda", "source": SOURCES[name],
                       "replaces": REPLACES[name], "launches": run["total"][name], "path": path,
                       "narrow_path_launches": narrow[name],
                       "df64_probe_launches": probe["counts"][name],
                       "ozaki_widths_launches": widths[name],
                       "sweep_launches": sweep_counts[name],
                       "netlib_launches": netlib_counts[name], "config2_launches": config2[name],
                       "config1_launches": config1[name], "twopass_launches": twopass[name],
                       "parallel_launches": parallel[name],
                       "sweep_parallel_launches": sweep_parallel[name],
                       "max_abs_err": max(r["err"], held[name]["err"]), "ms": r["ms"],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "bound_unit": r["bound_unit"],
                       "library_ms": r["library_ms"],
                       "library_permute_ms": r["library_permute_ms"],
                       "library_call": r["library_call"], "library_none": r.get("library_none"),
                       "netlib_ms": held[name].get("ms"),
                       "netlib_plain_ms": held[name].get("plain_ms"),
                       "held_at": MAIN_SHAPES[name] + held[name]["held_at"] + r.get("held_at", [])})
        if name in TWO_DESIGNS:
            # the lane-group design's launches on the same path (all of them),
            # the streaming design's time in the same turns, the other widths
            report[-1].update({
                "source": "pycllp_tpu_torch/csrc/batchlast_smem.cuh",
                "instantiated_in": SOURCES[name],
                "smem_launches": run["total"][f"{name}_smem"], "stream_ms": r["stream_ms"],
                "netlib_stream_ms": held[name].get("stream_ms"),
                "netlib_bound_ms": held[name].get("bound_ms"),
                "lane_sweep_ms": r["lane_sweep_ms"],
                "other_width": r.get("resume_bucket") or r.get("tier2")})
        if name in ("fused_factor_bl", "facsol_bl"):
            report[-1].update({"split_ms": r["split_ms"], "netlib_split_ms": held[name]["split_ms"]})
        if name == "ozaki_product_bl":
            report[-1].update({"split_ms": r["split_ms"], "by_shape": r["by_shape"],
                               "profiled_by_shape": profile["kernel_host"]["ozaki_by_shape"]})
        # device time of the kernel in the profiled main-path solve, by stage
        # (the slicing pass's in the split route's)
        group = PROFILE_NAMES.get(name)
        prof_run = profile["split" if name == "slice_rounds_bl" else "kernel"]
        report[-1].update({f"{stage}_device_ms": prof_run[stage]["by_kernel_ms"].get(group, 0.0)
                           for stage in ("narrow", "finish")})
    say("wall", f"the whole script {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": report, "lane_matvec": lane}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
