"""Batch-last kernel set: hand-written CUDA Cholesky and solve kernels.

Counterpart of :mod:`pycllp_tpu.ops.batchlast`.  Instances live on the
LAST axis, as in the reference:

* With shared structure, ``M = A·diag(d)·Aᵀ`` collapses to ONE matmul:
  ``M[(i,j), b] = Σ_n (A[i,n]·A[j,n]) · d[n,b] = (W @ dᵀ)[(i,j), b]``
  where ``W[(i,j), n] = A[i,n]·A[j,n]`` is precomputed once per
  structure.  The product lands in batch-last layout, so it stays a
  plain ``torch.matmul`` (the reference leaves it to XLA too).
* The Cholesky and the triangular solves are hand-written CUDA kernels
  (:func:`chol_bl`, :func:`solve_bl`) with two designs.  The lane-group
  kernels (``csrc/batchlast_smem.cuh``) copy each lane's triangle into
  shared memory once and run there, one warp a lane, G lanes a block; they
  are the route at every m whose one-lane triangle fits (m ≤ 340 in f32,
  240 in f64).  The streaming kernels (``csrc/batchlast.cuh``), which keep
  the triangle in device memory, take the larger m.  :func:`lane_plan`
  makes the choice, by shape alone, and picks G from (shape, B, SM count)
  so that every width puts a block on every SM.
* The reference's fused variants are hand-written CUDA kernels with the
  same two designs: :func:`fused_factor_bl` forms M = W @ dᵀ inside the
  factor kernel, so M never goes through device memory (``fuse_form=True``,
  :data:`BATCHLAST_FUSED_KERNELS`), and :func:`facsol_bl` factors and
  solves the first right-hand sides in one launch (``fuse_facsol=True``).
  Their lane-group kernels run the factor's own device routine.
  facsol_bl's is the route wherever chol_bl's is; fused_factor_bl's up to
  m = 128, past which the streaming kernel, which shares each W tile among
  32 lanes, takes over.

Each kernel has a plain PyTorch version beside it (:func:`_chol_bl_plain`,
:func:`_solve_bl_plain`, :func:`_fused_factor_bl_plain`,
:func:`_facsol_bl_plain`) that runs the same loop order on tensors.  The
wrappers take the plain version only for tensors on the CPU; for a CUDA
tensor they launch the kernel or raise.  Each launch adds one to its
kernel's key of :data:`~pycllp_tpu_torch.ops._launch.LAUNCHES` (and, on the
lane-group design, to the key with ``_smem``); one on the streaming design
adds one to its shape in ``STREAM_LAUNCHES`` (the FP64 pair's too).

Per-instance (3-D) A takes the hand-written lane matvec of
:mod:`pycllp_tpu_torch.ops.lanemv` for ``mv``, ``rmv``, the factor's
``diag(M) = A²·d`` and ``matvec_M``, in this set and the wide sets
(:func:`_amv`, :func:`_armv`, :func:`_matvec_M`); a shared 2-D A keeps its
own products.

f64 inputs to :meth:`BatchLastKernels.factor` route to the reference set
(dtype dispatch: this set's kernels are float32).  The wide finish phase
runs on a sibling set chosen by :meth:`BatchLastKernels.finish_kernels`
(the FP64 kernels of :mod:`pycllp_tpu_torch.ops.df64`, or the f32-factor
mixed engine of :mod:`pycllp_tpu_torch.ops.mixed`).
"""

from __future__ import annotations

import collections
import math
import typing

import torch

from pycllp_tpu_torch.ops import _build, lanemv
from pycllp_tpu_torch.ops._launch import (
    H100_SMS,
    LAUNCHES,
    _SMEM_LIMIT,
    _check_cuda,
    _raise_on_error,
    _require,
    _sm_count,
    replayed,
)
# NormalFactor and ReferenceKernels are re-exported, as the reference's module does
from pycllp_tpu_torch.ops.reference import (  # noqa: F401
    KernelSet,
    NormalFactor,
    PreparedA,
    ReferenceKernels,
    REFERENCE_KERNELS,
    _mv,
    _rmv,
)

__all__ = [
    "BatchLastKernels",
    "BATCHLAST_KERNELS",
    "BATCHLAST_FUSED_KERNELS",
    "BLFactor",
    "PreparedBL",
    "chol_bl",
    "solve_bl",
    "fused_factor_bl",
    "facsol_bl",
    "pack_w",
]

# the launches on the streaming design, of this module's kernels and of
# df64's FP64 pair, by shape: (kind, dtype, m, B, k) → launches, kind
# "chol", "solve", "fused" or "facsol", dtype "f32" or "f64", k the
# right-hand sides (1 for a factor)
STREAM_LAUNCHES: collections.Counter = replayed(collections.Counter())


# ---------------------------------------------------------------------------
# launch plan of the factor and solve (csrc/batchlast_smem.cuh)
# ---------------------------------------------------------------------------

# lane-group sizes G the kernels are built for, largest first, per element
# size: 8 float or 4 double lanes of an m = 64 triangle are ~67 KB, three
# blocks to an SM
_LANE_GROUPS = {4: (8, 4, 2, 1), 8: (4, 2, 1)}
# the lane-group fused_factor_bl holds at most two row pairs a thread
_FUSED_MAX_M = 128
# the streaming kernels' blocks: 32 lanes a factor block, 128 threads
# (one per lane and right-hand side) a solve block
_STREAM_CHOL_LANES = 32
_STREAM_SOLVE_THREADS = 128


class LanePlan(typing.NamedTuple):
    """How one factor or solve launch covers its B lanes."""

    design: str  # "smem" (lane-group, triangle in shared memory) or "stream"
    lanes: int  # lanes per block (G for "smem")
    blocks: int  # blocks in the grid
    smem: int  # dynamic shared memory of one block, bytes


def smem_bytes(m: int, lanes: int, itemsize: int) -> int:
    """Shared memory of one lane-group block, factor or solve
    (tri_smem_bytes): per lane, the packed triangle rounded up to 32
    entries plus 32 / G (the panel values, right-hand sides and dinv live
    in registers)."""
    return (-(-(m * (m + 1) // 2) // 32) * 32 + 32 // lanes) * lanes * itemsize


def fused_smem_bytes(m: int, n: int, lanes: int) -> int:
    """Shared memory of one lane-group fused_factor_bl block
    (fused_smem_bytes): the G float triangles, rounded up to 4 floats, then
    dT's rows for the G lanes, n rounded up to 4 (fused_dt_rows)."""
    tri = smem_bytes(m, lanes, 4) // 4
    return (-(-tri // 4) * 4 + -(-n // 4) * 4 * lanes) * 4


def _lane_smem(kind: str, m: int, lanes: int, size: int, n: int) -> int:
    if kind == "fused":
        return fused_smem_bytes(m, n, lanes)
    return smem_bytes(m, lanes, size)


def uses_smem(m: int, dtype, kind: str = "chol", n: int = 0) -> bool:
    """The design choice, by shape alone: the lane-group kernels whenever
    one lane's triangle (and, for "fused", its n rows of dT) fits in a
    block's shared memory, and for "fused" up to m = 128."""
    if kind == "fused" and m > _FUSED_MAX_M:
        return False
    return _lane_smem(kind, m, 1, dtype.itemsize, n) <= _SMEM_LIMIT


def _fused_smem(m: int, n: int) -> int:
    """Shared memory of one streaming fused_factor_bl block
    (csrc/batchlast.cu): column k and a dT tile of up to 256 rows, 32
    lanes each, plus each warp's 32 x 4 W tile."""
    return (m + min(n, 256)) * 32 * 4 + 8 * 32 * 16


def _facsol_smem(m: int, k: int) -> int:
    """Shared memory of one streaming facsol_bl block: column k, dinv and
    the (k, m) V tile, 32 lanes each."""
    return (2 + k) * m * 32 * 4


def lane_plan(kind: str, m: int, B: int, dtype, n_sm: int = H100_SMS, k: int = 1,
              design: str | None = None, lanes: int | None = None, n: int = 0) -> LanePlan:
    """The plan of a ``kind`` ("chol", "solve", "facsol" or "fused") launch
    on B lanes (``k`` right-hand sides; ``n`` columns of W for "fused").

    The lane-group size G is the largest built one, at most B, that fits
    in shared memory and still gives at least min(n_sm, B) blocks, so
    every width the solver uses puts a block on every SM where it has the
    lanes.
    ``design`` and ``lanes`` force a design or a G (for measurements);
    a forced plan that cannot launch raises ``ValueError``.
    """
    size = dtype.itemsize
    if design is None:
        design = "smem" if uses_smem(m, dtype, kind, n) else "stream"
    if design == "stream":
        _require(lanes is None, "the streaming kernels take no lane-group size")
        if kind == "solve":
            return LanePlan("stream", 1, -(-(k * B) // _STREAM_SOLVE_THREADS), 0)
        smem = {"chol": m * _STREAM_CHOL_LANES * size, "facsol": _facsol_smem(m, k),
                "fused": _fused_smem(m, n)}[kind]
        _require(smem <= _SMEM_LIMIT,
                 f"streaming {kind} at m={m}, n={n}, k={k} needs {smem} bytes of shared "
                 f"memory (> {_SMEM_LIMIT})")
        return LanePlan("stream", _STREAM_CHOL_LANES, -(-B // _STREAM_CHOL_LANES), smem)
    _require(design == "smem", f"unknown design {design!r}")
    _require(kind != "fused" or m <= _FUSED_MAX_M,
             f"the lane-group {kind} kernel takes m <= {_FUSED_MAX_M}, got m={m}")
    groups = _LANE_GROUPS[size]
    if lanes is None:
        want = min(n_sm, B)
        fits = [g for g in groups if g <= B and _lane_smem(kind, m, g, size, n) <= _SMEM_LIMIT]
        lanes = next((g for g in fits if -(-B // g) >= want), groups[-1])
    _require(lanes in groups, f"lane-group size {lanes} is not one of {groups} for {dtype}")
    smem = _lane_smem(kind, m, lanes, size, n)
    _require(smem <= _SMEM_LIMIT,
             f"{kind} at m={m} with {lanes} lanes a block needs {smem} bytes of shared "
             f"memory (> {_SMEM_LIMIT})")
    return LanePlan("smem", lanes, -(-B // lanes), smem)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the on-card comparison)
# ---------------------------------------------------------------------------


def _chol_bl_plain(M, reg):
    """Right-looking batch-lane Cholesky of M + reg·I, as ``_chol_body``.

    M (m, m, B), reg (B,) → L (m, m, B), dinv (m, B).  Every scalar step of
    the textbook algorithm is one tensor op across the lanes; a pivot ≤ 0
    turns its lane NaN.  Works in place on a clone of M.
    """
    m = M.shape[0]
    L = M.clone()
    dinv = torch.empty(M.shape[1:], dtype=M.dtype, device=M.device)
    for k in range(m):
        akk = L[k, k] + reg
        pos = akk > 0
        sq = torch.sqrt(torch.where(pos, akk, 1.0))
        inv = torch.where(pos, 1.0 / sq, torch.nan)
        L[k, k] = torch.where(pos, sq, torch.nan)
        dinv[k] = inv
        if k + 1 < m:
            col = L[k + 1 :, k] * inv
            L[k + 1 :, k] = col
            L[k + 1 :, k + 1 :] -= col[:, None, :] * col[None, :, :]
    return L, dinv


def _solve_bl_plain(L, dinv, R):
    """Solve L Lᵀ v = r for k stacked RHS, as ``_solve_kernel``.

    L (m, m, B), dinv (m, B), R (k, m, B) → V (k, m, B).  Forward pass
    left-looking (dot with row ``L[i, :i]``), backward pass right-looking;
    divisions use the reciprocal diagonal.  Works in place on a clone of R.
    """
    m = L.shape[0]
    V = R.clone()
    for i in range(m):
        if i > 0:
            acc = (L[i, :i][None] * V[:, :i]).sum(dim=1)
            V[:, i] = (V[:, i] - acc) * dinv[i]
        else:
            V[:, i] = V[:, i] * dinv[i]
    for i in reversed(range(m)):
        vi = V[:, i] * dinv[i]
        V[:, i] = vi
        if i > 0:
            V[:, :i] -= L[i, :i][None] * vi[:, None]
    return V


def _fused_factor_bl_plain(W, dT, reg):
    """W (m², n), dT (n, B), reg (B,) → (L, dinv): :func:`_chol_bl_plain`
    of M = (W @ dT).reshape(m, m, B), as ``_fused_factor_kernel``."""
    m = math.isqrt(W.shape[0])
    return _chol_bl_plain((W @ dT).reshape(m, m, dT.shape[1]), reg)


def _facsol_bl_plain(M, reg, R):
    """Factor M + reg·I and solve L Lᵀ v = r for k stacked RHS, as
    ``_facsol_kernel``: the forward substitution rides the pivot loop,
    the backward pass is right-looking.

    M (m, m, B), reg (B,), R (k, m, B) → (L, dinv, V).  M is factored in
    place (L is M, as the reference aliases them) and V is a clone of R.
    """
    m = M.shape[0]
    L = M
    V = R.clone()
    dinv = torch.empty(M.shape[1:], dtype=M.dtype, device=M.device)
    for k in range(m):
        akk = L[k, k] + reg
        pos = akk > 0
        sq = torch.sqrt(torch.where(pos, akk, 1.0))
        inv = torch.where(pos, 1.0 / sq, torch.nan)
        L[k, k] = torch.where(pos, sq, torch.nan)
        dinv[k] = inv
        wk = V[:, k] * inv
        V[:, k] = wk
        if k + 1 < m:
            col = L[k + 1 :, k] * inv
            L[k + 1 :, k] = col
            L[k + 1 :, k + 1 :] -= col[:, None, :] * col[None, :, :]
            V[:, k + 1 :] -= col[None, :, :] * wk[:, None, :]
    for i in reversed(range(m)):
        vi = V[:, i] * dinv[i]
        V[:, i] = vi
        if i > 0:
            V[:, :i] -= L[i, :i][None] * vi[:, None]
    return L, dinv, V


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _launch_chol(M, reg, dtype, design=None, lanes=None):
    """Check the operands and launch the batch-last Cholesky instantiated
    for ``dtype``, on the design :func:`lane_plan` picks (or the one
    forced); returns ``(L, dinv, plan)``, ``plan`` None when nothing
    launched (B = 0)."""
    _require(M.dim() == 3 and M.shape[0] == M.shape[1], f"M must be (m, m, B), got {tuple(M.shape)}")
    m, B = M.shape[0], M.shape[2]
    _check_cuda("M", M, (m, m, B), dtype)
    _check_cuda("reg", reg, (B,), dtype)
    _require(reg.device == M.device, "M and reg must be on the same device")
    L = torch.empty_like(M)
    dinv = torch.empty((m, B), dtype=M.dtype, device=M.device)
    if B == 0:
        return L, dinv, None
    plan = lane_plan("chol", m, B, dtype, _sm_count(M.device), design=design, lanes=lanes)
    lib = _build.load()
    args = [M.data_ptr(), reg.data_ptr(), L.data_ptr(), dinv.data_ptr(), m, B]
    entry = f"pycllp_chol_bl_{_SUFFIX[dtype]}"
    if plan.design == "smem":
        entry = f"pycllp_chol_bl_smem_{_SUFFIX[dtype]}"
        args.append(plan.lanes)
    with torch.cuda.device(M.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(entry, err)
    return L, dinv, plan


def _launch_solve(L, dinv, R, dtype, design=None, lanes=None):
    """Check the operands and launch the batch-last k-RHS solve instantiated
    for ``dtype``, on the design :func:`lane_plan` picks (or the one
    forced); returns ``(V, plan)``, ``plan`` None when nothing launched."""
    _require(L.dim() == 3 and L.shape[0] == L.shape[1], f"L must be (m, m, B), got {tuple(L.shape)}")
    _require(R.dim() == 3, f"R must be (k, m, B), got {tuple(R.shape)}")
    m, B = L.shape[0], L.shape[2]
    k = R.shape[0]
    _check_cuda("L", L, (m, m, B), dtype)
    _check_cuda("dinv", dinv, (m, B), dtype)
    _check_cuda("R", R, (k, m, B), dtype)
    _require(L.device == dinv.device == R.device, "L, dinv and R must be on the same device")
    V = torch.empty_like(R)
    if B == 0 or k == 0:
        return V, None
    plan = lane_plan("solve", m, B, dtype, _sm_count(L.device), k=k, design=design, lanes=lanes)
    lib = _build.load()
    args = [L.data_ptr(), dinv.data_ptr(), R.data_ptr(), V.data_ptr(), m, B, k]
    entry = f"pycllp_solve_bl_{_SUFFIX[dtype]}"
    if plan.design == "smem":
        entry = f"pycllp_solve_bl_smem_{_SUFFIX[dtype]}"
        args.append(plan.lanes)
    with torch.cuda.device(L.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(entry, err)
    return V, plan


def _count(key: str, plan, kind: str, dtype, m: int, B: int, k: int = 1) -> None:
    """One launch of ``plan`` in ``LAUNCHES[key]``, and in ``key + "_smem"``
    or in ``STREAM_LAUNCHES`` by the design it ran; nothing when nothing
    launched (``plan`` None)."""
    if plan is None:
        return
    LAUNCHES[key] += 1
    if plan.design == "smem":
        LAUNCHES[key + "_smem"] += 1
    else:
        STREAM_LAUNCHES[(kind, _SUFFIX[dtype], m, B, k)] += 1


def _chol_bl_cuda(M, reg, design=None, lanes=None):
    """The f32 factor on the card; ``design="stream"`` (or ``"smem"``, and
    ``lanes``) force a design for the on-card comparisons."""
    L, dinv, plan = _launch_chol(M, reg, torch.float32, design, lanes)
    _count("chol_bl", plan, "chol", torch.float32, M.shape[0], M.shape[2])
    return L, dinv


def _solve_bl_cuda(L, dinv, R, design=None, lanes=None):
    """The f32 solve on the card; ``design``/``lanes`` as :func:`_chol_bl_cuda`."""
    V, plan = _launch_solve(L, dinv, R, torch.float32, design, lanes)
    _count("solve_bl", plan, "solve", torch.float32, L.shape[0], L.shape[2], R.shape[0])
    return V


def pack_w(W):
    """W's lower-triangle rows (i·m + j, j ≤ i, in the packed order
    i(i+1)/2 + j), transposed to (n, m(m+1)/2): the layout the lane-group
    fused_factor_bl reads, a warp's 32 entries 32 neighbouring floats of
    each column.  W is fixed for a given A, so
    :meth:`BatchLastKernels.prepare` packs it once."""
    m = math.isqrt(W.shape[0])
    i, j = torch.tril_indices(m, m, device=W.device)
    return W.index_select(0, i * m + j).T.contiguous()


def _fused_factor_bl_cuda(W, dT, reg, design=None, lanes=None, Wp=None):
    """fused_factor_bl on the card; ``design``/``lanes`` as
    :func:`_chol_bl_cuda`.  ``Wp`` is :func:`pack_w` of W, which the
    lane-group kernel reads; without it the wrapper packs W itself."""
    _require(W.dim() == 2 and dT.dim() == 2, "W must be (m², n) and dT (n, B)")
    m = math.isqrt(W.shape[0])
    n, B = dT.shape
    _require(m * m == W.shape[0], f"W must have m² rows, got {W.shape[0]}")
    _check_cuda("W", W, (m * m, n))
    _check_cuda("dT", dT, (n, B))
    _check_cuda("reg", reg, (B,))
    _require(W.device == dT.device == reg.device, "W, dT and reg must be on the same device")
    L = torch.empty((m, m, B), dtype=dT.dtype, device=dT.device)
    dinv = torch.empty((m, B), dtype=dT.dtype, device=dT.device)
    if B == 0:
        return L, dinv
    plan = lane_plan("fused", m, B, torch.float32, _sm_count(dT.device), n=n, design=design,
                     lanes=lanes)
    lib = _build.load()
    entry = "pycllp_fused_factor_bl_f32"
    if plan.design == "smem":
        entry = "pycllp_fused_factor_bl_smem_f32"
        if Wp is None:
            Wp = pack_w(W)
        _check_cuda("Wp", Wp, (n, m * (m + 1) // 2))
        W = Wp
    args = [W.data_ptr(), dT.data_ptr(), reg.data_ptr(), L.data_ptr(), dinv.data_ptr(), m, n, B]
    if plan.design == "smem":
        args.append(plan.lanes)
    with torch.cuda.device(dT.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(entry, err)
    _count("fused_factor_bl", plan, "fused", torch.float32, m, B)
    return L, dinv


def _facsol_bl_cuda(M, reg, R, design=None, lanes=None):
    """facsol_bl on the card; ``design``/``lanes`` as :func:`_chol_bl_cuda`."""
    _require(M.dim() == 3 and M.shape[0] == M.shape[1], f"M must be (m, m, B), got {tuple(M.shape)}")
    _require(R.dim() == 3, f"R must be (k, m, B), got {tuple(R.shape)}")
    m, B = M.shape[0], M.shape[2]
    k = R.shape[0]
    _check_cuda("M", M, (m, m, B))
    _check_cuda("reg", reg, (B,))
    _check_cuda("R", R, (k, m, B))
    _require(M.device == reg.device == R.device, "M, reg and R must be on the same device")
    dinv = torch.empty((m, B), dtype=M.dtype, device=M.device)
    V = torch.empty_like(R)
    if B == 0 or k == 0:
        return M, dinv, V
    plan = lane_plan("facsol", m, B, torch.float32, _sm_count(M.device), k=k, design=design,
                     lanes=lanes)
    lib = _build.load()
    args = [M.data_ptr(), reg.data_ptr(), R.data_ptr(), dinv.data_ptr(), V.data_ptr(), m, B, k]
    entry = "pycllp_facsol_bl_f32"
    if plan.design == "smem":
        entry = "pycllp_facsol_bl_smem_f32"
        args.append(plan.lanes)
    with torch.cuda.device(M.device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(entry, err)
    _count("facsol_bl", plan, "facsol", torch.float32, m, B, k)
    return M, dinv, V


def chol_bl(M, reg):
    """M (m, m, B), reg (B,) → (L, dinv): factor M + reg·I per lane.

    CUDA tensors launch the hand-written kernel (float32, contiguous, or
    raise); CPU tensors run :func:`_chol_bl_plain`.
    """
    if M.device.type == "cpu":
        return _chol_bl_plain(M, reg)
    return _chol_bl_cuda(M, reg)


def solve_bl(L, dinv, R):
    """L (m, m, B), dinv (m, B), R (k, m, B) → V (k, m, B): L Lᵀ v = r.

    CUDA tensors launch the hand-written kernel (float32, contiguous, or
    raise); CPU tensors run :func:`_solve_bl_plain`.
    """
    if L.device.type == "cpu":
        return _solve_bl_plain(L, dinv, R)
    return _solve_bl_cuda(L, dinv, R)


def fused_factor_bl(W, dT, reg, Wp=None):
    """W (m², n), dT (n, B), reg (B,) → (L, dinv): factor
    (W @ dT).reshape(m, m, B) + reg·I per lane, the product formed inside
    the kernel.  ``Wp``, :func:`pack_w` of W, saves packing W on each call.

    CUDA tensors launch the hand-written kernel (float32, contiguous, or
    raise); CPU tensors run :func:`_fused_factor_bl_plain`.
    """
    if dT.device.type == "cpu":
        return _fused_factor_bl_plain(W, dT, reg)
    return _fused_factor_bl_cuda(W, dT, reg, Wp=Wp)


def facsol_bl(M, reg, R):
    """M (m, m, B), reg (B,), R (k, m, B) → (L, dinv, V): factor M + reg·I
    and solve L Lᵀ v = r in one launch.  M is consumed: it is factored in
    place and returned as L.

    CUDA tensors launch the hand-written kernel (float32, contiguous, or
    raise); CPU tensors run :func:`_facsol_bl_plain`.
    """
    if M.device.type == "cpu":
        return _facsol_bl_plain(M, reg, R)
    return _facsol_bl_cuda(M, reg, R)


# ---------------------------------------------------------------------------
# per-instance matvecs: 3-D A to the lane matvec kernel (ops/lanemv.py)
# ---------------------------------------------------------------------------


def _amv(A, x):
    """``A @ x``: :func:`~pycllp_tpu_torch.ops.lanemv.lane_mv` for a
    per-instance (B, m, n) A, ``x @ A.T`` (``_mv``) for a shared one."""
    return lanemv.lane_mv(A, x) if A.dim() == 3 else _mv(A, x)


def _armv(A, y):
    """``Aᵀ @ y``: :func:`~pycllp_tpu_torch.ops.lanemv.lane_rmv` for a
    per-instance A, ``y @ A`` (``_rmv``) for a shared one."""
    return lanemv.lane_rmv(A, y) if A.dim() == 3 else _rmv(A, y)


def _matvec_M(kset, fac, v):
    """``kset``'s ``matvec_M``: for a per-instance A the one-read normal
    product :func:`~pycllp_tpu_torch.ops.lanemv.lane_normal`, else the
    base class's ``mv(d ∘ rmv(v)) + δv`` on ``kset``'s own products."""
    A = fac.ctx.A
    if A.dim() == 3:
        return lanemv.lane_normal(A, fac.d, v, fac.reg)
    return KernelSet.matvec_M(kset, fac, v)


# ---------------------------------------------------------------------------
# KernelSet implementation
# ---------------------------------------------------------------------------


class PreparedBL(typing.NamedTuple):
    """Prepared shared-A context + the (m², n) self-outer-product W, and
    for the fused-form set W packed for the lane-group fused_factor_bl
    (:func:`pack_w`; None otherwise)."""

    A: typing.Any
    Asq: typing.Any
    W: typing.Any
    Wp: typing.Any = None


class BLFactor(typing.NamedTuple):
    """Batch-last factorization: L (m, m, B), dinv (m, B), no lane padding."""

    ctx: typing.Any
    L: typing.Any
    dinv_diag: typing.Any  # reciprocal diagonal of L, (m, B)
    d: typing.Any
    reg: typing.Any


class BatchLastKernels(KernelSet):
    """Batch-last kernel set on the hand-written CUDA kernels.

    Shared 2-D A forms ``M = (W @ dᵀ).reshape(m, m, B)`` with one matmul;
    per-instance (3-D) A forms M per instance, emitted batch-last.  Both
    factor with :func:`chol_bl` and solve with :func:`solve_bl`.  f64
    routes to the reference set.

    ``fuse_form=True`` factors shared-A f32 systems with
    :func:`fused_factor_bl` (M formed inside the kernel, never in device
    memory).  ``fuse_facsol=True`` makes :meth:`factor_and_solve` one
    :func:`facsol_bl` launch (M still formed by a matmul, as the
    reference forms it with XLA).  With both, ``factor_and_solve`` takes
    facsol and ``factor`` alone the fused form, as in the reference.

    ``ozaki_bits`` / ``ozaki_mv_bits`` are the Ozaki widths of the wide
    sets that :meth:`finish_kernels` hands the finish and the crossover
    (the reference's ``PYCLLP_OZAKI_BITS`` / ``PYCLLP_OZAKI_MV_BITS``);
    None is the default width, 66 / 48 bits.  A width that no contraction
    length lets the Ozaki kernel run raises ``ValueError`` here.
    """

    name = "cuda_batchlast"

    def __init__(self, fuse_form: bool = False, fuse_facsol: bool = False, *,
                 ozaki_bits: int | None = None, ozaki_mv_bits: int | None = None):
        self.fuse_form = fuse_form
        self.fuse_facsol = fuse_facsol
        if fuse_form or fuse_facsol:
            self.name = f"cuda_batchlast{'_form' if fuse_form else ''}{'_facsol' if fuse_facsol else ''}"
        if ozaki_bits is not None or ozaki_mv_bits is not None:
            from pycllp_tpu_torch.ops.df64 import check_ozaki_width

            ozaki_bits = None if ozaki_bits is None else check_ozaki_width(ozaki_bits, "ozaki_bits")
            ozaki_mv_bits = (None if ozaki_mv_bits is None
                             else check_ozaki_width(ozaki_mv_bits, "ozaki_mv_bits"))
        self.ozaki_bits = ozaki_bits
        self.ozaki_mv_bits = ozaki_mv_bits

    def prepare(self, A):
        if A.dim() != 2:
            return REFERENCE_KERNELS.prepare(A)
        m, n = A.shape
        W = (A[:, None, :] * A[None, :, :]).reshape(m * m, n)
        Wp = pack_w(W) if self.fuse_form and m <= _FUSED_MAX_M else None
        return PreparedBL(A=A, Asq=A * A, W=W, Wp=Wp)

    def mv(self, ctx, x):
        return _amv(ctx.A, x)

    def rmv(self, ctx, y):
        return _armv(ctx.A, y)

    def matvec_M(self, fac, v):
        return _matvec_M(self, fac, v)

    def factor(self, ctx, d, reg_eps):
        # route on the RESULT dtype: an f64 A with f32 d still makes an
        # f64 M, and the kernels are float32 only
        if torch.float64 in (d.dtype, ctx.A.dtype):
            base = ctx if isinstance(ctx, PreparedA) else PreparedA(ctx.A, ctx.Asq)
            return REFERENCE_KERNELS.factor(base, d, reg_eps)
        diag = _amv(ctx.Asq, d)
        reg = (reg_eps * diag.amax(dim=-1)).to(d.dtype)
        if not isinstance(ctx, PreparedBL):
            # per-instance A: no shared-W trick; form M per instance and
            # lay it out batch-last for the same kernel
            A = ctx.A
            M_bl = ((A * d[:, None, :]) @ A.mT).permute(1, 2, 0).contiguous()
            L, dinv = chol_bl(M_bl, reg)
        elif self.fuse_form:
            L, dinv = fused_factor_bl(ctx.W, d.T.contiguous(), reg, ctx.Wp)
        else:
            m = ctx.A.shape[0]
            L, dinv = chol_bl((ctx.W @ d.T).reshape(m, m, d.shape[0]), reg)
        return BLFactor(ctx=ctx, L=L, dinv_diag=dinv, d=d, reg=reg)

    def factor_and_solve(self, ctx, d, reg_eps, rs):
        """With ``fuse_facsol``, shared 2-D A and float32: the factor and
        the first solve in one :func:`facsol_bl` launch; otherwise
        :meth:`factor`, then :meth:`solve`."""
        if not self.fuse_facsol or not isinstance(ctx, PreparedBL) or d.dtype == torch.float64:
            fac = self.factor(ctx, d, reg_eps)
            return fac, self.solve(fac, rs)
        m = ctx.A.shape[0]
        reg = (reg_eps * _mv(ctx.Asq, d).amax(dim=-1)).to(d.dtype)
        M = (ctx.W @ d.T).reshape(m, m, d.shape[0])
        R = torch.stack([r.T for r in rs], dim=0)  # (k, m, B), contiguous
        L, dinv, V = facsol_bl(M, reg, R)
        fac = BLFactor(ctx=ctx, L=L, dinv_diag=dinv, d=d, reg=reg)
        return fac, tuple(V[i].T for i in range(len(rs)))

    def solve(self, fac, rs):
        if not isinstance(fac, BLFactor):
            return REFERENCE_KERNELS.solve(fac, rs)
        R = torch.stack([r.T for r in rs], dim=0)  # (k, m, B), contiguous
        V = solve_bl(fac.L, fac.dinv_diag, R)
        return tuple(V[i].T for i in range(len(rs)))

    def finish_kernels(self, which: str = "df64") -> KernelSet:
        """Wide-phase sibling selected by ``SolverOptions.finish_kset``,
        cached per name.

        ``"df64"`` (default): native-FP64 CUDA factor/solve with Ozaki
        matvecs and formation (:mod:`pycllp_tpu_torch.ops.df64`);
        ``"df64_f64form"``: the same with an f64 GEMM formation;
        ``"mixed"`` / ``"mixed1"``: f32 CUDA factor + f64 refinement
        (:mod:`pycllp_tpu_torch.ops.mixed`), the crossover engine;
        ``"df64_fastform"``: the same with the fast formation, the
        reference's recorded negative result; ``"reference"``: the plain set.
        At the default widths these are the modules' own sets; at other
        widths, sets built at this set's ``ozaki_bits`` / ``ozaki_mv_bits``.
        """
        cache = self.__dict__.setdefault("_finish_kernels", {})
        fk = cache.get(which)
        if fk is None:
            fk = REFERENCE_KERNELS if which == "reference" else self._wide_set(which)
            cache[which] = fk
        return fk

    def _wide_set(self, which: str) -> KernelSet:
        """The wide set named ``which``: the module's own at the default
        widths, else one like it built at this set's widths."""
        from pycllp_tpu_torch.ops import df64, mixed

        own = {"df64": df64.DF64_FINISH_KERNELS, "df64_f64form": df64.DF64_F64FORM_KERNELS,
               "df64_fastform": df64.DF64_FASTFORM_KERNELS, "mixed": mixed.MIXED_FINISH_KERNELS,
               "mixed1": mixed.MIXED_IR1_KERNELS}
        if which not in own:
            raise ValueError(f"unknown finish kernel set {which!r}")
        fk = own[which]
        bits = df64.OZAKI_BITS if self.ozaki_bits is None else self.ozaki_bits
        mv_bits = df64.OZAKI_MV_BITS if self.ozaki_mv_bits is None else self.ozaki_mv_bits
        if (bits, mv_bits) == (df64.OZAKI_BITS, df64.OZAKI_MV_BITS):
            return fk
        if isinstance(fk, df64.DoubleSingleKernels):
            return df64.DoubleSingleKernels(fk.form, bits=bits, mv_bits=mv_bits)
        return mixed.MixedPrecisionKernels(fk.base, ir_steps=fk.ir_steps, mv_bits=mv_bits)


BATCHLAST_KERNELS = BatchLastKernels()
BATCHLAST_FUSED_KERNELS = BatchLastKernels(fuse_form=True)
