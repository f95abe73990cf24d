"""Lane matvec: per-instance (B, m, n) A·x, Aᵀ·y and the normal product.

The kernel sets route a 3-D (per-instance) A here and keep a shared 2-D A
on their own products (``x @ A.T``, ``y @ A``, the Ozaki matvecs):

* :func:`lane_mv` — ``A @ x`` per lane (also ``diag(M) = A²·d``);
* :func:`lane_rmv` — ``Aᵀ @ y`` per lane;
* :func:`lane_normal` — ``M v = A(d ∘ Aᵀv) + δ·v`` per lane, the
  :meth:`~pycllp_tpu_torch.ops.reference.KernelSet.matvec_M` of
  iterative refinement, from one read of A.

On the card each is the hand-written ``lane_matvec_kernel``
(``csrc/lanemv.cu``): each lane's A staged in shared memory once per
product and reduced in A's own width (f32 or f64).  It replaces no TPU
kernel: the reference leaves these products to XLA's einsum.  Each
function has a plain version beside it (:func:`_lane_mv_plain`,
:func:`_lane_rmv_plain`, :func:`_lane_normal_plain`): today's einsum
expressions.  The wrappers take it only for CPU tensors; for CUDA tensors
they launch the kernel or raise.  Each launch adds one to ``lane_mv``,
``lane_rmv`` or ``lane_normal`` of
:data:`~pycllp_tpu_torch.ops._launch.LAUNCHES`; a lane too large for one shared-memory stage runs its normal product as an
rmv launch and an mv launch, and counts them as such.
"""

from __future__ import annotations

import typing

import torch

from pycllp_tpu_torch.ops import _build
from pycllp_tpu_torch.ops._launch import (
    H100_SMS,
    LAUNCHES,
    _SMEM_LIMIT,
    _raise_on_error,
    _require,
    _sm_count,
)

__all__ = ["KERNEL_NAMES", "LaneMvPlan", "lane_mv", "lane_mv_plan", "lane_normal", "lane_rmv"]

# the device kernels this module launches, by the name a profiler shows
KERNEL_NAMES = ("lane_matvec_kernel",)

# the kernel's modes (csrc/lanemv.cu: LaneMvMode), and their keys in LAUNCHES
_MV, _RMV, _NORMAL = 0, 1, 2
_KEYS = ("lane_mv", "lane_rmv", "lane_normal")
# shared memory of one H100 SM, and what the card reserves for each block
_SM_SMEM = 233472
_BLOCK_RESERVED = 1024
_MAX_BLOCKS_PER_SM = 4
_STAGES = 3  # the ring's stages (kLaneMvStages)


class LaneMvPlan(typing.NamedTuple):
    """How one launch covers its B lanes of (m, n) A."""

    rows: int  # P: rows of a tile
    cols: int  # Q: columns of a tile
    whole: bool  # one tile holds a lane (P = m, Q = n)
    bulk: bool  # each tile one bulk copy (16-byte aligned), else element copies
    smem: int  # dynamic shared memory of one block, bytes
    grid: int  # blocks: each walks every grid-th lane


def _round4(k: int) -> int:
    return -(-k // 4) * 4


def stage_len(P: int, Q: int) -> int:
    """Elements of one ring stage (lanemv_stage_len): the P x Q tile, then
    x and s (Q each), y (P) and reg, each rounded up to 4."""
    return _round4(P * Q) + 2 * _round4(Q) + _round4(P) + 4


def _tile(m: int, n: int, budget: int) -> tuple:
    """The largest tile whose stage fits ``budget`` elements: the whole
    lane, else P whole rows, else one row in Q-column pieces (Q a
    multiple of 4, so a piece of an aligned row stays 16-byte aligned)."""
    if stage_len(m, n) <= budget:
        return m, n
    if stage_len(1, n) <= budget:
        P = (budget - 2 * _round4(n) - 8) // (n + 1)
        while stage_len(P, n) > budget:
            P -= 1
        return P, n
    return 1, (budget - 8) // 12 * 4


def lane_mv_plan(m: int, n: int, B: int, dtype, n_sm: int = H100_SMS,
                 aligned: bool = True) -> LaneMvPlan:
    """The plan of a launch on B lanes of (m, n) A in ``dtype``.

    The tile is the largest whose ring of three stages (and their 8-byte
    barriers) fits a block's shared memory.  Tiles are bulk copies when
    ``aligned`` (A's address) and the shape keep each 16-byte aligned
    (m·n for a whole lane, n for rows or pieces of rows), else element
    copies.  As many blocks a SM as shared memory allows, at most 4, and
    never more blocks than lanes.
    """
    size = dtype.itemsize
    _require(m > 0 and n > 0 and B > 0, f"nothing to run: m={m}, n={n}, B={B}")
    P, Q = _tile(m, n, (_SMEM_LIMIT // _STAGES - 8) // size)
    whole = (P, Q) == (m, n)
    bulk = aligned and (m * n if whole else n) * size % 16 == 0
    smem = _STAGES * (stage_len(P, Q) * size + 8)
    per_sm = max(1, min(_MAX_BLOCKS_PER_SM, _SM_SMEM // (smem + _BLOCK_RESERVED)))
    return LaneMvPlan(P, Q, whole, bulk, smem, min(B, per_sm * n_sm))


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the on-card comparison)
# ---------------------------------------------------------------------------


def _lane_mv_plain(A, x):
    return torch.einsum("...mn,...n->...m", A, x)


def _lane_rmv_plain(A, y):
    return torch.einsum("...mn,...m->...n", A, y)


def _lane_normal_plain(A, d, v, reg):
    return _lane_mv_plain(A, d * _lane_rmv_plain(A, v)) + reg[..., None] * v


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


def _operands(A, **vecs):
    """Check A (B, m, n), contiguous, and each vector against it (x and s
    of length n, y of m, reg one a lane, in A's dtype and broadcast to
    its lanes); return the vectors expanded to (B, len).  Raises
    ``ValueError`` on what the kernel does not take, on any device."""
    _require(A.dim() == 3, f"A must be (B, m, n), got {tuple(A.shape)}")
    _require(A.is_contiguous(), "A must be contiguous")
    _require(A.dtype in (torch.float32, torch.float64),
             f"A must be float32 or float64, got {A.dtype}")
    B, m, n = A.shape
    length = {"x": n, "s": n, "y": m, "reg": None}
    out = {}
    for name, v in vecs.items():
        _require(v.dtype == A.dtype, f"{name} must be {A.dtype} as A, got {v.dtype}")
        _require(v.device == A.device, f"{name} must be on A's device {A.device}, got {v.device}")
        want = (B,) if length[name] is None else (B, length[name])
        try:
            out[name] = v.expand(want)
        except RuntimeError:
            raise ValueError(
                f"{name} of shape {tuple(v.shape)} does not broadcast to {want}") from None
    return out


def _lane_cuda(mode: int, A, x=None, s=None, y=None, reg=None, out_len: int = 0):
    """One launch of ``lane_matvec_kernel`` in ``mode`` on 3-D CUDA A; the
    absent vectors are null pointers.  Returns the (B, out_len) output."""
    _require(A.is_cuda, f"A must be a CUDA tensor, got device {A.device}")
    given = {k: v for k, v in (("x", x), ("s", s), ("y", y), ("reg", reg)) if v is not None}
    vecs = _operands(A, **given)
    B, m, n = A.shape
    out = torch.empty((B, out_len), dtype=A.dtype, device=A.device)
    if B == 0:
        return out
    plan = lane_mv_plan(m, n, B, A.dtype, _sm_count(A.device), A.data_ptr() % 16 == 0)
    _require(mode != _NORMAL or plan.whole,
             "the one-launch normal product needs a whole lane in a tile")
    args = []
    for name in ("x", "s", "y"):
        v = vecs.get(name)
        args += [0, 0, 0] if v is None else [v.data_ptr(), v.stride(0), v.stride(1)]
    r = vecs.get("reg")
    args += [0, 0] if r is None else [r.data_ptr(), r.stride(0)]
    entry = "pycllp_lane_matvec_f32" if A.dtype == torch.float32 else "pycllp_lane_matvec_f64"
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = getattr(lib, entry)(
            mode, A.data_ptr(), *args, out.data_ptr(), m, n, B, plan.rows, plan.cols,
            int(plan.bulk), plan.grid, plan.smem, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(entry, err)
    LAUNCHES[_KEYS[mode]] += 1
    return out


def _lane_mv_cuda(A, x):
    return _lane_cuda(_MV, A, x=x, out_len=A.shape[1])


def _lane_rmv_cuda(A, y):
    return _lane_cuda(_RMV, A, y=y, out_len=A.shape[2])


def _lane_normal_cuda(A, d, v, reg):
    _require(A.dim() == 3, f"A must be (B, m, n), got {tuple(A.shape)}")
    _, m, n = A.shape
    if lane_mv_plan(m, n, 1, A.dtype).whole:
        return _lane_cuda(_NORMAL, A, s=d, y=v, reg=reg, out_len=m)
    t = _lane_cuda(_RMV, A, y=v, out_len=n)
    return _lane_cuda(_MV, A, x=t, s=d, y=v, reg=reg, out_len=m)


def lane_mv(A, x):
    """A (B, m, n), x (B, n) → A @ x per lane, (B, m).

    CUDA tensors launch the hand-written kernel (float32 or float64, A
    contiguous, x in A's dtype, or raise); CPU tensors run
    :func:`_lane_mv_plain`.
    """
    if A.device.type == "cpu":
        return _lane_mv_plain(A, x)
    return _lane_mv_cuda(A, x)


def lane_rmv(A, y):
    """A (B, m, n), y (B, m) → Aᵀ @ y per lane, (B, n); devices as
    :func:`lane_mv`, CPU tensors through :func:`_lane_rmv_plain`."""
    if A.device.type == "cpu":
        return _lane_rmv_plain(A, y)
    return _lane_rmv_cuda(A, y)


def lane_normal(A, d, v, reg):
    """A (B, m, n), d (B, n), v (B, m), reg (B,) → A(d ∘ Aᵀv) + reg·v per
    lane, (B, m), reading A once where a lane fits one stage; devices as
    :func:`lane_mv`, CPU tensors through :func:`_lane_normal_plain`."""
    if A.device.type == "cpu":
        return _lane_normal_plain(A, d, v, reg)
    return _lane_normal_cuda(A, d, v, reg)
