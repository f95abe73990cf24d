"""On-card smoke run of the PyTorch/CUDA port (``pycllp_tpu_torch``).

Builds the hand-written CUDA kernels from the sources in this checkout
(``csrc/batchlast.cu`` and ``csrc/df64.cu``), holds each against its plain
PyTorch version on the card, and drives the port's paths:

1. device and build;
2. kernel parity and times: ``chol_bl``/``solve_bl`` (f32), the fused
   ``fused_factor_bl``/``facsol_bl`` (f32, also against the split path
   they replace), the FP64 ``df_chol_bl``/``df_solve_bl`` and the Ozaki
   ``slice_rounds_bl``, plus the df64 and Ozaki accuracy contracts of
   ``tests_tpu/smoke.py``;
3. the narrow main path — 65,536 dense 64×64 LPs through
   ``get_solver("hsd_pallas", device="cuda")`` at the ``BENCH_FINISH=0``
   options;
4. two 256-lane probes with a wide finish (a df64 IPM finish, and a
   mixed-engine crossover finish), each audited against scipy;
5. the full main path — ``bench.py``'s default configuration: the same
   65,536 LPs through ``hsd_solve_scan`` with the wide f64 crossover
   finish and its drain tiers — audited to the 1e-6 contract;
6. the same configuration on the fused-form set
   (``BATCHLAST_FUSED_KERNELS``) and on the ``fuse_facsol`` set, each
   audited and with its kernel's launches tied to the narrow iterations;
7. the checkpointed scenario sweep (``scenario_sweep``, ``bench.py``'s
   ``run_sweep`` configuration: 131,072 scenarios) on the fused-form
   set, interrupted after its first window, resumed, and compared with
   an uninterrupted sweep;
8. per-iteration metrics (``log_every=1``) of a 4,096-lane solve through
   ``metrics_to_jsonl``.

Usage (from the repository root, one CUDA card):

    python3 chip_smoke.py

Every phase prints lines; any failure raises and the script exits
non-zero (there is no CPU fallback).  The line before the last is the
kernel report as JSON, the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from pycllp_tpu_torch import SolverOptions, Status, get_solver  # noqa: E402
from pycllp_tpu_torch.io.generate import random_standard_lp  # noqa: E402
from pycllp_tpu_torch.ops import _build  # noqa: E402
from pycllp_tpu_torch.ops import batchlast as bl  # noqa: E402
from pycllp_tpu_torch.ops import df64  # noqa: E402
from pycllp_tpu_torch.ops.reference import REFERENCE_KERNELS, PreparedA  # noqa: E402
from pycllp_tpu_torch.solvers import hsd as hsd_mod  # noqa: E402
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
}
REPLACES = {
    "chol_bl": "pycllp_tpu/ops/batchlast.py:223",
    "solve_bl": "pycllp_tpu/ops/batchlast.py:273",
    "fused_factor_bl": "pycllp_tpu/ops/batchlast.py:195",
    "facsol_bl": "pycllp_tpu/ops/batchlast.py:247",
    "df_chol_bl": "pycllp_tpu/ops/df64.py:264",
    "df_solve_bl": "pycllp_tpu/ops/df64.py:295",
    "slice_rounds_bl": "pycllp_tpu/ops/df64.py:504",
}
KERNEL_RTOL = 1e-4  # f32 kernels vs plain and vs the f32 reference set (smoke's bound)
F64_RTOL = 1e-12  # FP64 kernels vs their plain versions
# max relative objective error of the audited lanes of the NARROW path.
# The JAX reference, run on the CPU at this exact input and these options,
# audits at 2.2535e-3: its lane 18 ends STALLED at that error (the port
# lands on the same lane at the same error), so 2e-3 would fail it.
AUDIT_MAX = 3e-3
OK_SHARE = 0.99  # narrow path: OPTIMAL + STALLED share of lanes
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
# bench.py's run_sweep: 131,072 scenarios in windows of 4 chunks, at the
# same scan arguments
SWEEP_N = 131072
SWEEP_KW = dict(chunk=16384, compact_cap=12, compact_bucket=5120, window_chunks=4,
                finish_cap=3, finish_bucket=1024)
SWEEP_OBJ_RTOL = 1e-9  # resumed vs uninterrupted sweep: same kernels, same inputs


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


def zero_counts() -> None:
    bl.CHOL_LAUNCHES = bl.SOLVE_LAUNCHES = 0
    bl.FUSED_FACTOR_LAUNCHES = bl.FACSOL_LAUNCHES = 0
    df64.DF_CHOL_LAUNCHES = df64.DF_SOLVE_LAUNCHES = df64.SLICE_LAUNCHES = 0
    hsd_mod.HOST_STEPS = 0


def read_counts() -> dict:
    return {"chol_bl": bl.CHOL_LAUNCHES, "solve_bl": bl.SOLVE_LAUNCHES,
            "fused_factor_bl": bl.FUSED_FACTOR_LAUNCHES, "facsol_bl": bl.FACSOL_LAUNCHES,
            "df_chol_bl": df64.DF_CHOL_LAUNCHES, "df_solve_bl": df64.DF_SOLVE_LAUNCHES,
            "slice_rounds_bl": df64.SLICE_LAUNCHES, "host_steps": hsd_mod.HOST_STEPS}


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


def phase_kernels(dev) -> dict:
    """chol_bl / solve_bl (f32) against their plain versions; returns
    {name: (max_abs_err, ms, plain_ms)}."""
    errs = {"chol_bl": 0.0, "solve_bl": 0.0}
    for B in (256, 300, 16384):
        A, d, R = _inputs(B, seed=B, dev=dev)
        M_bl, reg = _formed(A, d, 1e-6)
        L_k, dinv_k = bl._chol_bl_cuda(M_bl, reg)
        L_p, dinv_p = bl._chol_bl_plain(M_bl, reg)
        torch.cuda.synchronize()
        e_chol = max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p))
        check(e_chol < KERNEL_RTOL, f"chol_bl vs plain at B={B}: rel {e_chol:.2e}")
        errs["chol_bl"] = max(errs["chol_bl"], abs_err(_lower(L_k), _lower(L_p)),
                              abs_err(dinv_k, dinv_p))
        # f32 reference set (torch.linalg) on the same data
        fac_r = REFERENCE_KERNELS.factor(PreparedA(A, A * A), d, 1e-6)
        line = [f"B={B}: chol rel {e_chol:.1e}"]
        for k in (1, 2):
            Rk = R[:k].contiguous()
            V_k = bl._solve_bl_cuda(L_k, dinv_k, Rk)
            V_p = bl._solve_bl_plain(L_k, dinv_k, Rk)
            V_r = torch.stack(REFERENCE_KERNELS.solve(fac_r, tuple(Rk[i].T for i in range(k))))
            torch.cuda.synchronize()
            e_plain = rel_err(V_k, V_p)
            e_ref = rel_err(V_k.transpose(1, 2), V_r)
            check(e_plain < KERNEL_RTOL, f"solve_bl k={k} vs plain at B={B}: rel {e_plain:.2e}")
            check(e_ref < KERNEL_RTOL, f"solve_bl k={k} vs reference at B={B}: rel {e_ref:.2e}")
            errs["solve_bl"] = max(errs["solve_bl"], abs_err(V_k, V_p))
            line.append(f"solve k={k} rel {e_plain:.1e} (vs reference set {e_ref:.1e})")
        say("kernel parity", "; ".join(line))

    # a lane with negated d is indefinite: NaN there, finite elsewhere
    A, d, R = _inputs(256, seed=9, dev=dev)
    d[2] = -d[2]
    M_bl, reg = _formed(A, d, 0.0)
    L_k, dinv_k = bl._chol_bl_cuda(M_bl, reg)
    V_k = bl._solve_bl_cuda(L_k, dinv_k, R[:1].contiguous())
    torch.cuda.synchronize()
    check(bool(torch.isnan(V_k[0, :, 2]).any()), "NaN lane: lane 2 is not NaN")
    others = torch.cat([V_k[0, :, :2], V_k[0, :, 3:]], dim=1)
    check(bool(torch.isfinite(others).all()), "NaN lane: another lane is not finite")
    say("kernel parity", "chol_bl: negated-d lane 2 is NaN, the other 255 lanes finite")

    # times at the narrow path's shapes (m = 64, B = 16,384), in turns
    A, d, R = _inputs(16384, seed=1, dev=dev)
    M_bl, reg = _formed(A, d, 1e-6)
    L, dinv = bl._chol_bl_cuda(M_bl, reg)
    R1, R2 = R[:1].contiguous(), R.contiguous()
    t_chol = in_turns("chol_bl at m=64, B=16384", lambda: bl._chol_bl_cuda(M_bl, reg),
                      lambda: bl._chol_bl_plain(M_bl, reg))
    t_solve = in_turns("solve_bl k=1 at m=64, B=16384", lambda: bl._solve_bl_cuda(L, dinv, R1),
                       lambda: bl._solve_bl_plain(L, dinv, R1))
    in_turns("solve_bl k=2 at m=64, B=16384", lambda: bl._solve_bl_cuda(L, dinv, R2),
             lambda: bl._solve_bl_plain(L, dinv, R2))
    return {"chol_bl": (errs["chol_bl"], *t_chol), "solve_bl": (errs["solve_bl"], *t_solve)}


def phase_fused_kernels(dev) -> dict:
    """fused_factor_bl / facsol_bl (f32) against their plain versions and
    against the split path they replace (matmul + chol_bl; chol_bl +
    solve_bl); returns {name: (max_abs_err, ms, plain_ms)}."""
    errs = {"fused_factor_bl": 0.0, "facsol_bl": 0.0}
    for B in (256, 300, 16384):
        A, d, R = _inputs(B, seed=B, dev=dev)
        W = bl.BATCHLAST_KERNELS.prepare(A).W
        dT = d.T.contiguous()
        M_bl, reg = _formed(A, d, 1e-6)
        L_k, dinv_k = bl._fused_factor_bl_cuda(W, dT, reg)
        L_p, dinv_p = bl._fused_factor_bl_plain(W, dT, reg)
        L_s, dinv_s = bl._chol_bl_cuda(M_bl, reg)
        torch.cuda.synchronize()
        e_plain = max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p))
        e_split = max(rel_err(_lower(L_k), _lower(L_s)), rel_err(dinv_k, dinv_s))
        check(e_plain < KERNEL_RTOL, f"fused_factor_bl vs plain at B={B}: rel {e_plain:.2e}")
        check(e_split < KERNEL_RTOL, f"fused_factor_bl vs chol_bl at B={B}: rel {e_split:.2e}")
        check(bool((torch.triu(L_k.permute(2, 0, 1), 1) == 0).all()),
              f"fused_factor_bl at B={B}: the upper triangle is not zero")
        errs["fused_factor_bl"] = max(errs["fused_factor_bl"], abs_err(_lower(L_k), _lower(L_p)),
                                      abs_err(dinv_k, dinv_p))
        line = [f"B={B}: fused_factor rel {e_plain:.1e} (vs chol_bl {e_split:.1e})"]
        for k in (1, 2):
            Rk = R[:k].contiguous()
            Lc, dinv_c, Vc = bl._facsol_bl_cuda(M_bl.clone(), reg, Rk)
            Lp, dinv_cp, Vp = bl._facsol_bl_plain(M_bl.clone(), reg, Rk)
            V_s = bl._solve_bl_cuda(L_s, dinv_s, Rk)
            torch.cuda.synchronize()
            e_plain = max(rel_err(_lower(Lc), _lower(Lp)), rel_err(dinv_c, dinv_cp),
                          rel_err(Vc, Vp))
            e_split = max(rel_err(_lower(Lc), _lower(L_s)), rel_err(dinv_c, dinv_s),
                          rel_err(Vc, V_s))
            check(e_plain < KERNEL_RTOL, f"facsol_bl k={k} vs plain at B={B}: rel {e_plain:.2e}")
            check(e_split < KERNEL_RTOL,
                  f"facsol_bl k={k} vs chol_bl + solve_bl at B={B}: rel {e_split:.2e}")
            errs["facsol_bl"] = max(errs["facsol_bl"], abs_err(_lower(Lc), _lower(Lp)),
                                    abs_err(dinv_c, dinv_cp), abs_err(Vc, Vp))
            line.append(f"facsol k={k} rel {e_plain:.1e} (vs chol_bl + solve_bl {e_split:.1e})")
        say("kernel parity", "; ".join(line))

    # a lane with negated d is indefinite: NaN there, finite elsewhere
    A, d, R = _inputs(256, seed=9, dev=dev)
    d[2] = -d[2]
    W = bl.BATCHLAST_KERNELS.prepare(A).W
    M_bl, reg = _formed(A, d, 0.0)
    L_k, dinv_k = bl._fused_factor_bl_cuda(W, d.T.contiguous(), reg)
    V_k = bl._solve_bl_cuda(L_k, dinv_k, R[:1].contiguous())
    _, dinv_c, V_c = bl._facsol_bl_cuda(M_bl.clone(), reg, R.contiguous())
    torch.cuda.synchronize()
    for name, dinv, V in (("fused_factor_bl", dinv_k, V_k), ("facsol_bl", dinv_c, V_c)):
        check(bool(torch.isnan(dinv[:, 2]).any()) and bool(torch.isnan(V[:, :, 2]).any()),
              f"{name} NaN lane: lane 2 is not NaN")
        others = torch.cat([V[:, :, :2], V[:, :, 3:]], dim=2)
        check(bool(torch.isfinite(others).all()), f"{name} NaN lane: another lane is not finite")
    say("kernel parity", "fused_factor_bl, facsol_bl: negated-d lane 2 is NaN, "
        "the other 255 lanes finite")

    # times at the narrow stage's chunk (16,384) and the resume bucket
    # (5,120), m = 64, n = 128, in turns.  facsol_bl factors in place, so
    # each timed call (and each of the paths beside it) starts with a copy
    # of M into a work buffer.
    times = {}
    for B in (16384, 5120):
        A, d, R = _inputs(B, seed=1, dev=dev)
        W = bl.BATCHLAST_KERNELS.prepare(A).W
        dT = d.T.contiguous()
        M_bl, reg = _formed(A, d, 1e-6)
        m = A.shape[0]
        R2 = R.contiguous()
        Mw = torch.empty_like(M_bl)
        t = in_turns(f"fused_factor_bl at m=64, n=128, B={B}",
                     lambda: bl._fused_factor_bl_cuda(W, dT, reg),
                     lambda: bl._fused_factor_bl_plain(W, dT, reg))
        in_turns(f"fused_factor_bl vs the split path (matmul + chol_bl) at B={B}",
                 lambda: bl._fused_factor_bl_cuda(W, dT, reg),
                 lambda: bl._chol_bl_cuda((W @ dT).reshape(m, m, B), reg))
        times.setdefault("fused_factor_bl", t)

        def facsol():
            Mw.copy_(M_bl)
            return bl._facsol_bl_cuda(Mw, reg, R2)

        def facsol_plain():
            Mw.copy_(M_bl)
            return bl._facsol_bl_plain(Mw, reg, R2)

        def split():
            Mw.copy_(M_bl)
            L, dinv = bl._chol_bl_cuda(Mw, reg)
            return bl._solve_bl_cuda(L, dinv, R2)

        t = in_turns(f"facsol_bl k=2 (with the copy of M) at m=64, B={B}", facsol, facsol_plain)
        in_turns(f"facsol_bl k=2 vs the split path (chol_bl + solve_bl k=2) at B={B}", facsol, split)
        copy_ms = time_ms(lambda: Mw.copy_(M_bl), 10)
        chol_ms = time_ms(lambda: bl._chol_bl_cuda(M_bl, reg), 10)
        gemm_ms = time_ms(lambda: W @ dT, 10)
        say("kernel time", f"at B={B}, alone: the copy of M {copy_ms:.4f} ms, chol_bl "
            f"{chol_ms:.4f} ms, the GEMM forming M {gemm_ms:.4f} ms")
        times.setdefault("facsol_bl", t)
    return {k: (errs[k], *times[k]) for k in errs}


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
        L_k, dinv_k = df64._df_chol_bl_cuda(M_bl, reg)
        L_p, dinv_p = df64._df_chol_bl_plain(M_bl, reg)
        torch.cuda.synchronize()
        e_chol = max(rel_err(_lower(L_k), _lower(L_p)), rel_err(dinv_k, dinv_p))
        check(e_chol < F64_RTOL, f"df_chol_bl vs plain at B={B}: rel {e_chol:.2e}")
        errs["df_chol_bl"] = max(errs["df_chol_bl"], abs_err(_lower(L_k), _lower(L_p)),
                                 abs_err(dinv_k, dinv_p))
        line = [f"B={B}: df_chol rel {e_chol:.1e}"]
        for k in (1, 2):
            Rk = R[:k].contiguous()
            V_k = df64._df_solve_bl_cuda(L_k, dinv_k, Rk)
            V_p = df64._df_solve_bl_plain(L_k, dinv_k, Rk)
            torch.cuda.synchronize()
            e = rel_err(V_k, V_p)
            check(e < F64_RTOL, f"df_solve_bl k={k} vs plain at B={B}: rel {e:.2e}")
            errs["df_solve_bl"] = max(errs["df_solve_bl"], abs_err(V_k, V_p))
            line.append(f"df_solve k={k} rel {e:.1e}")
        say("kernel parity", "; ".join(line))

    # a lane with negated d is indefinite: NaN there, finite elsewhere
    A, d, R = _wide_inputs(256, seed=9, dev=dev)
    d[2] = -d[2]
    M_bl, reg = _formed64(A, d, 0.0)
    L_k, dinv_k = df64._df_chol_bl_cuda(M_bl, reg)
    V_k = df64._df_solve_bl_cuda(L_k, dinv_k, R[:1].contiguous())
    torch.cuda.synchronize()
    check(bool(torch.isnan(V_k[0, :, 2]).any()), "df NaN lane: lane 2 is not NaN")
    others = torch.cat([V_k[0, :, :2], V_k[0, :, 3:]], dim=1)
    check(bool(torch.isfinite(others).all()), "df NaN lane: another lane is not finite")
    say("kernel parity", "df_chol_bl: negated-d lane 2 is NaN, the other 255 lanes finite")

    # slicing: bit-identical to the plain version
    rng = np.random.default_rng(7)
    for r, B in ((128, 16384), (64, 300)):
        X = rng.normal(size=(r, B)) * 10.0 ** rng.uniform(-8, 8, size=(r, B))
        X = torch.from_numpy(X / np.abs(X).max(axis=0, keepdims=True)).to(dev)
        Rh, Rl = df64._split_hi_lo(X)
        for params in (df64.ozaki_mv_params(128), df64.ozaki_params(128)):
            s, n_slices, _ = params
            S_k = df64._slice_rounds_bl_cuda(Rh, Rl, s, n_slices)
            S_p = df64._slice_rounds_bl_plain(Rh, Rl, s, n_slices)
            torch.cuda.synchronize()
            diff = abs_err(S_k, S_p)
            same = bool(torch.equal(S_k.view(torch.int32), S_p.view(torch.int32)))
            check(same and diff == 0.0, f"slice_rounds_bl ({r}, {B}) s={s} n={n_slices}: "
                  f"not bit-identical (max abs diff {diff:.3e})")
            errs["slice_rounds_bl"] = max(errs["slice_rounds_bl"], diff)
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
    Mo = df64._ozaki_matmul(*ctx.Woz, d.T, s=s, n_slices=n_slices, cut=cut)
    M_ref = torch.einsum("mn,bn,kn->mkb", A, d, A).reshape(64 * 64, 512)
    oz = float(((Mo - M_ref).abs() / M_ref.abs().amax(0, keepdim=True)).max())
    check(oz < 2.5e-13, f"Ozaki formation rel {oz:.2e} of the output scale")
    say("Ozaki contract", f"formation vs f64 einsum {oz:.2e} of the output scale (< 2.5e-13) "
        "at a 1e±30 spread")

    # times, in turns, at the wide path's shapes
    times = {}
    for B in (1024, 256):
        A, d, R = _wide_inputs(B, seed=5, dev=dev)
        M_bl, reg = _formed64(A, d, 1e-12)
        t = in_turns(f"df_chol_bl at m=64, B={B}", lambda: df64._df_chol_bl_cuda(M_bl, reg),
                     lambda: df64._df_chol_bl_plain(M_bl, reg))
        times.setdefault("df_chol_bl", t)
        if B == 1024:
            L, dinv = df64._df_chol_bl_cuda(M_bl, reg)
            R1, R2 = R[:1].contiguous(), R.contiguous()
            times["df_solve_bl"] = in_turns(
                "df_solve_bl k=1 at m=64, B=1024", lambda: df64._df_solve_bl_cuda(L, dinv, R1),
                lambda: df64._df_solve_bl_plain(L, dinv, R1))
            in_turns("df_solve_bl k=2 at m=64, B=1024", lambda: df64._df_solve_bl_cuda(L, dinv, R2),
                     lambda: df64._df_solve_bl_plain(L, dinv, R2))
    s, n_slices, _ = df64.ozaki_mv_params(128)
    for B in (16384, 32768):
        X = torch.rand((128, B), dtype=torch.float64, device=dev) * 2 - 1
        Rh, Rl = df64._split_hi_lo(X)
        t = in_turns(f"slice_rounds_bl at (128, {B}), s={s}, n_slices={n_slices}",
                     lambda: df64._slice_rounds_bl_cuda(Rh, Rl, s, n_slices),
                     lambda: df64._slice_rounds_bl_plain(Rh, Rl, s, n_slices))
        times.setdefault("slice_rounds_bl", t)
    return {k: (errs[k], *times[k]) for k in errs}


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


def status_mix(status) -> dict:
    uniq, counts = np.unique(status, return_counts=True)
    return {Status(int(u)).name: int(c) for u, c in zip(uniq, counts)}


def phase_narrow_path(smi: str) -> dict:
    lp = random_standard_lp(M, N, nlp=N_LP, seed=3, dtype=np.float32)
    solver = get_solver("hsd_pallas", device="cuda", **SOLVER_KW)
    solver.init(lp)
    n_chunks = -(-N_LP // SOLVER_KW["chunk"])

    zero_counts()
    t0 = time.perf_counter()
    sol = solver.solve()
    first_s = time.perf_counter() - t0
    counts, steps = read_counts(), hsd_mod.HOST_STEPS
    chol, solves = counts["chol_bl"], counts["solve_bl"]
    say("narrow path", f"first solve {first_s:.3f}s; launches {counts}; "
        f"host-loop iterations={steps}, Mehrotra starts={n_chunks}")
    check(chol > 0 and solves > 0, "a kernel of the narrow path was never launched")
    check(chol == steps + n_chunks,
          f"chol_bl launches {chol} != host iterations {steps} + Mehrotra starts {n_chunks}")
    # per iteration: the joint k=2 solve, the corrector, 3 KKT sweeps
    check(solves == 5 * steps + n_chunks,
          f"solve_bl launches {solves} != 5 x {steps} + {n_chunks}")

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
    return counts


def _probe(name: str, seed: int, opts: SolverOptions) -> dict:
    """tests_tpu/smoke.py's 256-lane probes through hsd_solve_batched."""
    B = 256
    lp = random_standard_lp(64, 64, nlp=B, seed=seed, dtype=np.float32)
    eq = lp.to_equality_form()
    zero_counts()
    t0 = time.perf_counter()
    out = hsd_mod.hsd_solve_batched(
        np.asarray(eq.A, np.float32), np.asarray(eq.b, np.float32), np.asarray(eq.c, np.float32),
        opts, bl.BATCHLAST_KERNELS, device="cuda",
    )
    st = out["status"].cpu().numpy()
    obj = -out["objective"].cpu().numpy()  # the equality form minimises −cᵀx
    secs = time.perf_counter() - t0
    counts = read_counts()
    rels = audit(lp, obj, np.linspace(0, B - 1, 64, dtype=int))
    worst = max(rels.values())
    say(name, f"{secs:.3f}s; status mix {status_mix(st)}; launches {counts}; host-loop "
        f"iterations {hsd_mod.HOST_STEPS}; audit of 64 lanes max {worst:.3e}, "
        f"mean {np.mean(list(rels.values())):.2e}")
    check((st == int(Status.OPTIMAL)).mean() >= PROBE_OPTIMAL,
          f"{name}: only {(st == 0).sum()}/{B} OPTIMAL")
    check(worst <= CONTRACT, f"{name}: audit max {worst:.3e} > {CONTRACT}")
    return counts


def phase_probes() -> dict:
    common = dict(maxiter=40, dtype="float32", stall_patience=3, stall_rtol=0.05, refine_steps=0,
                  init_point="mehrotra", finish_dtype="float64", switch_tol=1e-5,
                  finish_maxiter=20)
    # check_probe: the wide IPM finish factors on the df64 set every iteration
    counts = _probe("df64 probe", 3, SolverOptions(tol=1e-6, finish_kset="df64", **common))
    check(counts["df_chol_bl"] > 0 and counts["df_solve_bl"] > 0,
          "df64 probe: df_chol_bl / df_solve_bl were never launched")
    # check_crossover_mixed: the mixed-engine crossover finish
    _probe("crossover probe", 5, SolverOptions(
        tol=2e-7, kkt_refine=2, finish_mode="crossover", crossover_kset="mixed",
        crossover_repair=2, **common))
    return counts


def _bench_problem(nlp: int):
    """bench.py's LPs (seed 3) as the equality form: the StandardLP for the
    audit, A on the host, b and c staged on the card once."""
    lp = random_standard_lp(M, N, nlp=nlp, seed=3, dtype=np.float32)
    eq = lp.to_equality_form()
    dev = torch.device("cuda", 0)
    b = torch.from_numpy(np.asarray(eq.b, np.float32)).to(dev)
    c = torch.from_numpy(np.asarray(eq.c, np.float32)).to(dev)
    return lp, np.asarray(eq.A, np.float32), b, c


def _audit_main(label: str, lp, obj, status) -> None:
    """The main path's bounds: OPTIMAL share and the 64-lane audit."""
    opt = status == int(Status.OPTIMAL)
    check(np.isfinite(obj[opt]).all(), f"{label}: non-finite objective on an OPTIMAL lane")
    check(opt.mean() >= MAIN_OPTIMAL, f"{label}: OPTIMAL share {opt.mean():.4f} < {MAIN_OPTIMAL}")
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


def _scan_path(smi: str, kset, label: str, reps: tuple, ref_status=None) -> dict:
    """bench.py's default configuration (65,536 LPs, ``hsd_solve_scan``,
    f64 crossover finish) on ``kset``: a first solve with a sync between
    the stages, its bounds, then ``reps`` more solves, timed.  Returns
    the launch counts of the first solve (``total``) and at the hand-over
    from the narrow stage to the finish (``narrow``), and its statuses."""
    lp, A, b, c = _bench_problem(N_LP)
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
    _audit_main(label, lp, obj, status)

    for rep in reps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out2 = hsd_mod.hsd_solve_scan(A, b, c, opts, kset, device="cuda", **SCAN_KW)
        status2 = out2["status"].cpu().numpy()
        wall = time.perf_counter() - t0
        vs = "" if ref_status is None else (
            f"; status agreement with the default set's main path "
            f"{(status2 == ref_status).mean():.4%}")
        say(label, f"{rep} solve {wall:.3f}s = {N_LP / wall:.1f} LP/s ({N_LP} LPs of "
            f"{M}x{N}, f32 bulk + f64 crossover finish; status agreement with the first solve "
            f"{(status2 == status).mean():.4%}{vs}) on {smi}")
    return {"total": counts, "narrow": narrow, "status": status}


def phase_main_path(smi: str) -> dict:
    run = _scan_path(smi, bl.BATCHLAST_KERNELS, "main path", ("second", "third"))
    for name in ("chol_bl", "solve_bl", "slice_rounds_bl"):
        check(run["total"][name] > 0, f"{name} was never launched on the main path")
    return run


def phase_fused_paths(smi: str, ref_status) -> tuple[dict, dict]:
    """The main path's configuration on the fused-form set and on the
    fuse_facsol set.  Each narrow iteration and each chunk's Mehrotra
    start factors once; the finish keeps chol_bl / solve_bl (its mixed
    engine is built on the default set)."""
    n_chunks = -(-N_LP // SCAN_KW["chunk"])
    form = _scan_path(smi, bl.BATCHLAST_FUSED_KERNELS, "fused-form path", ("second",), ref_status)
    nar, tot = form["narrow"], form["total"]
    steps = nar["host_steps"]
    check(nar["fused_factor_bl"] == steps + n_chunks,
          f"fused_factor_bl launches {nar['fused_factor_bl']} in the narrow stage != host "
          f"iterations {steps} + Mehrotra starts {n_chunks}")
    check(tot["fused_factor_bl"] == nar["fused_factor_bl"],
          "fused_factor_bl was launched in the finish")
    check(nar["chol_bl"] == 0, f"chol_bl launched {nar['chol_bl']} times in the fused narrow stage")
    check(nar["solve_bl"] == 5 * steps + n_chunks,
          f"narrow solve_bl launches {nar['solve_bl']} != 5 x {steps} + {n_chunks}")
    say("fused-form path", f"narrow stage: fused_factor_bl {nar['fused_factor_bl']} = {steps} host "
        f"iterations + {n_chunks} Mehrotra starts; finish: chol_bl {tot['chol_bl']}, solve_bl "
        f"{tot['solve_bl'] - nar['solve_bl']}, {tot['host_steps'] - steps} host iterations")

    facsol = _scan_path(smi, bl.BatchLastKernels(fuse_facsol=True), "facsol path", ("second",),
                        ref_status)
    nar, tot = facsol["narrow"], facsol["total"]
    steps = nar["host_steps"]
    check(nar["facsol_bl"] == steps + n_chunks,
          f"facsol_bl launches {nar['facsol_bl']} in the narrow stage != host iterations "
          f"{steps} + Mehrotra starts {n_chunks}")
    check(tot["facsol_bl"] == nar["facsol_bl"], "facsol_bl was launched in the finish")
    check(nar["chol_bl"] == 0, f"chol_bl launched {nar['chol_bl']} times in the facsol narrow stage")
    # per iteration the corrector and 3 KKT sweeps; the joint k=2 solve is in facsol
    check(nar["solve_bl"] == 4 * steps,
          f"narrow solve_bl launches {nar['solve_bl']} != 4 x {steps}")
    say("facsol path", f"narrow stage: facsol_bl {nar['facsol_bl']} = {steps} host iterations + "
        f"{n_chunks} Mehrotra starts, solve_bl {nar['solve_bl']} = 4 x {steps}; finish: chol_bl "
        f"{tot['chol_bl']}, solve_bl {tot['solve_bl'] - nar['solve_bl']}")
    return form, facsol


class _Interrupt(Exception):
    """Raised from a sweep's progress callback to stop it mid-sweep."""


def phase_sweep(smi: str) -> dict:
    """bench.py's run_sweep on the fused-form set: interrupted after its
    first window, resumed from the chunk files, and compared with an
    uninterrupted sweep."""
    lp, A, b, c = _bench_problem(SWEEP_N)
    opts = SolverOptions(**BENCH_OPTIONS)
    kw = dict(SWEEP_KW, kset=bl.BATCHLAST_FUSED_KERNELS, device="cuda")
    n_chunks = SWEEP_N // kw["chunk"]
    first_window = kw["window_chunks"]

    def stop_after_first_window(done, total):
        if done < total:
            raise _Interrupt(done)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="sweep-", dir=os.path.join(ROOT, "build"))
    try:
        zero_counts()
        t0 = time.perf_counter()
        try:
            scenario_sweep(A, b, c, opts, out_dir=out_dir, progress=stop_after_first_window, **kw)
            check(False, "the sweep was not interrupted")
        except _Interrupt as stop:
            check(stop.args[0] == first_window, f"interrupted after {stop.args[0]} chunks")
        cut_s = time.perf_counter() - t0
        files = sorted(os.listdir(out_dir))
        chunk_files = [f for f in files if f.startswith("chunk_") and f.endswith(".npz")]
        check("manifest.json" in files and len(chunk_files) == first_window,
              f"after the interruption the sweep directory holds {files}")
        check(not any(f.endswith(".tmp.npz") for f in files), "a half-written chunk was left")
        say("sweep", f"interrupted after its first window ({first_window} of {n_chunks} chunks) "
            f"in {cut_s:.3f}s; on disk: manifest.json + {len(chunk_files)} chunk files; "
            f"launches {read_counts()}")

        zero_counts()
        t0 = time.perf_counter()
        resumed = scenario_sweep(A, b, c, opts, out_dir=out_dir, **kw)
        resume_s = time.perf_counter() - t0
        counts = read_counts()
        check(resumed.n_resumed == first_window,
              f"the resumed sweep skipped {resumed.n_resumed} chunks, not {first_window}")
        check(counts["fused_factor_bl"] > 0, "fused_factor_bl was never launched in the sweep")
        say("sweep", f"resumed: {resumed.n_resumed} chunks loaded, {n_chunks - resumed.n_resumed} "
            f"solved in {resume_s:.3f}s; the whole sweep's {SWEEP_N} scenarios answered = "
            f"{SWEEP_N / resume_s:.1f} scenarios/s, "
            f"{(n_chunks - resumed.n_resumed) * kw['chunk'] / resume_s:.1f} solved/s; "
            f"launches {counts} on {smi}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = scenario_sweep(A, b, c, opts, **kw)
    whole_s = time.perf_counter() - t0
    same_status = bool(np.array_equal(resumed.status, whole.status))
    rel = np.abs(resumed.objective - whole.objective) / np.maximum(1.0, np.abs(whole.objective))
    bitwise = bool(np.array_equal(resumed.objective, whole.objective))
    say("sweep", f"uninterrupted, no out_dir: {whole_s:.3f}s = {SWEEP_N / whole_s:.1f} "
        f"scenarios/s on {smi}; resumed vs uninterrupted: statuses identical {same_status}, "
        f"objective max rel {rel.max():.3e}, bitwise equal {bitwise}")
    check(same_status, "resumed and uninterrupted sweeps disagree on a status")
    check(rel.max() <= SWEEP_OBJ_RTOL, f"resumed vs uninterrupted objective rel {rel.max():.3e}")

    obj = -resumed.objective  # the equality form minimises −cᵀx
    say("sweep", f"status mix {status_mix(resumed.status)}")
    _audit_main("sweep", lp, obj, resumed.status)
    return counts


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
    check(len(records) == steps, f"{len(records)} metric records for {steps} host iterations")
    check(records[0]["active"] == B and records[0]["iter"] == 0 and records[0]["phase"] == "float32",
          f"first record {records[0]}")
    say("metrics", f"{len(records)} records = host iterations; first {records[0]}; "
        f"last {records[-1]}")


def main() -> None:
    kind, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    measured = phase_kernels(dev)
    measured.update(phase_wide_kernels(dev))
    measured.update(phase_fused_kernels(dev))
    narrow = phase_narrow_path(smi)
    probe = phase_probes()
    main_run = phase_main_path(smi)
    form, facsol = phase_fused_paths(smi, main_run["status"])
    sweep_counts = phase_sweep(smi)
    phase_metrics()
    # launches: each kernel's count on the full main path that runs it (the
    # default set's, or the fused set's for the fused kernels); the narrow
    # path's, the df64 probe's (which must run the FP64 factor/solve) and
    # the sweep's beside it
    path_of = {"fused_factor_bl": ("fused-form path", form), "facsol_bl": ("facsol path", facsol)}
    report = []
    for name, (err, ms, plain_ms) in measured.items():
        path, run = path_of.get(name, ("main path", main_run))
        report.append({"name": name, "route": "cuda", "source": SOURCES[name],
                       "replaces": REPLACES[name], "launches": run["total"][name], "path": path,
                       "narrow_path_launches": narrow[name], "df64_probe_launches": probe[name],
                       "sweep_launches": sweep_counts[name],
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
