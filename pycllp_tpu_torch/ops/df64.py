"""Wide-phase kernel set: native-FP64 CUDA factor/solve and Ozaki products.

Counterpart of :mod:`pycllp_tpu.ops.df64`, with the same names so a
reader finds each piece.  The reference carries every wide number as a
double-single (hi, lo) f32 pair, because the TPU has no hardware f64:
its ``_df_chol_bl`` / ``_df_solve_bl`` Pallas kernels run the batch-lane
Cholesky and triangular solves in that pair arithmetic.  The H100 has
native FP64, so here the card computes in FP64:

* :func:`df_chol_bl` / :func:`df_solve_bl` are the hand-written CUDA
  kernels in ``csrc/df64.cu`` — the double instantiations of the
  batch-last templates behind :func:`~pycllp_tpu_torch.ops.batchlast.chol_bl`
  and :func:`~pycllp_tpu_torch.ops.batchlast.solve_bl`, on the same two
  designs and the same launch plan.  They compute the
  same function as the reference's kernels, more accurately (the pair
  carries ~49 bits), and :class:`DoubleSingleKernels` hands them f64
  tensors without a hi/lo split.
* Per-instance (3-D) A's matvecs and ``matvec_M`` run in the lane matvec
  of :mod:`pycllp_tpu_torch.ops.lanemv`, in FP64.
* The Ozaki scheme stays: shared-A matvecs and the normal-matrix
  formation are exact group products of integer slices.  On the card each
  product is ONE launch of the hand-written ``ozaki_product_bl``
  (``csrc/ozaki.cuh``): the per-lane normalisation, the slicing and the
  group products on bf16 tensor cores with f32 accumulators, and the f64
  combination, bitwise equal to the split route it replaces
  (:func:`_ozaki_matmul_split`: :func:`slice_rounds_bl`, then f32
  ``torch.matmul`` products of the slices and the f64 sum).  The hi/lo
  split survives there and in the reference's fast formation
  (``form="fast"``: three f32 GEMMs, no kernel of its own).  The f32
  products of the plain and split routes are exact only if every integer
  partial sum stays ≤ 2²⁴ in a full f32 accumulator, so they refuse to
  run with TF32 on.  A prepared operand holds its slices once, packed as
  the kernel reads them; those routes unpack one slice at a time.

Each kernel has a plain PyTorch version beside it (:func:`_df_chol_bl_plain`,
:func:`_df_solve_bl_plain`, :func:`_slice_rounds_bl_plain`,
:func:`_ozaki_matmul_plain`).  The wrappers take the plain version only
for CPU tensors; for a CUDA tensor they launch the kernel or raise.  Each
launch adds one to ``DF_CHOL_LAUNCHES``, ``DF_SOLVE_LAUNCHES``,
``SLICE_LAUNCHES`` or ``OZAKI_LAUNCHES``, each Ozaki product with lanes
sent to the card one to ``OZAKI_MATMUL_LAUNCHES`` (whatever route runs
it: one ``ozaki_product_bl`` launch), a factor or solve on the
lane-group design one to ``DF_CHOL_SMEM_LAUNCHES`` or
``DF_SOLVE_SMEM_LAUNCHES``, and one on the streaming design one to its
shape in :data:`~pycllp_tpu_torch.ops.batchlast.STREAM_LAUNCHES`.

The reference's environment knobs ``PYCLLP_OZAKI_BITS`` and
``PYCLLP_OZAKI_MV_BITS`` are arguments here: ``bits=`` / ``mv_bits=`` of
:class:`DoubleSingleKernels`, ``mv_bits=`` of
:class:`~pycllp_tpu_torch.ops.mixed.MixedPrecisionKernels`, and
``ozaki_bits=`` / ``ozaki_mv_bits=`` of
:class:`~pycllp_tpu_torch.ops.batchlast.BatchLastKernels` and the registry
solvers, which build their wide sets at those widths.  The library reads
no environment variable; the CLI maps the two to those arguments.  The
kernel takes at most ``OZAKI_MAX_LEVELS`` levels: a set whose widths give
more for its A raises ``ValueError`` (on every device) before any
iteration, where the reference has no cap.
"""

from __future__ import annotations

import typing

import torch

from pycllp_tpu_torch.ops import _build
from pycllp_tpu_torch.ops.batchlast import (
    _amv,
    _armv,
    _check_cuda,
    _chol_bl_plain,
    _count_stream,
    _launch_chol,
    _launch_solve,
    _matvec_M,
    _raise_on_error,
    _require,
    _solve_bl_plain,
)
from pycllp_tpu_torch.ops.reference import KernelSet

__all__ = [
    "DoubleSingleKernels",
    "DF64_FINISH_KERNELS",
    "DF64_F64FORM_KERNELS",
    "DF64_FASTFORM_KERNELS",
    "df_chol_bl",
    "df_solve_bl",
    "slice_rounds_bl",
    "ozaki_params",
    "ozaki_mv_params",
    "check_ozaki_width",
    "check_ozaki_levels",
]

# launch counters: one per kernel launch, nowhere else; the _SMEM counters
# count the factor and solve launches that ran the lane-group design
DF_CHOL_LAUNCHES = 0
DF_SOLVE_LAUNCHES = 0
DF_CHOL_SMEM_LAUNCHES = 0
DF_SOLVE_SMEM_LAUNCHES = 0
SLICE_LAUNCHES = 0
OZAKI_LAUNCHES = 0
OZAKI_MATMUL_LAUNCHES = 0

# ---------------------------------------------------------------------------
# double-single arithmetic on f32 tensors (the Ozaki slicing's remainder)
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):
    """Requires |a| >= |b| (guaranteed at every call site)."""
    s = a + b
    return s, b - (s - a)


def df_add(x, y):
    s, e = _two_sum(x[0], y[0])
    return _fast_two_sum(s, e + (x[1] + y[1]))


def df_sub(x, y):
    return df_add(x, (-y[0], -y[1]))


def _split_hi_lo(x64):
    """f64 tensor → (hi, lo) f32 pair with hi + lo == x64 to ~2⁻⁴⁸."""
    hi = x64.to(torch.float32)
    lo = (x64 - hi.to(x64.dtype)).to(torch.float32)
    return hi, lo


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the on-card comparison)
# ---------------------------------------------------------------------------

# The FP64 factor and solve run the loops of the f32 kernels, whose plain
# versions are dtype-generic: right-looking Cholesky with the shift added
# at each pivot read and NaN for a pivot that is not > 0; forward
# left-looking, backward right-looking solve.
_df_chol_bl_plain = _chol_bl_plain
_df_solve_bl_plain = _solve_bl_plain


def _slice_rounds_bl_plain(Rh, Rl, s: int, n_slices: int):
    """(r, B) normalised f32 hi/lo pair → (n_slices, r, B) integer f32 bands.

    As ``_slice_rounds_kernel``: slice k is round-half-even of
    ``h·2^(s·k)``; the remainder ``(h, l) −= slice_k·2^(−s·k)`` is carried
    in double-single.  Every step is an exact power-of-two scaling, a
    rounding, or an f32 add, so the kernel reproduces it bit for bit.
    """
    out = torch.empty((n_slices,) + tuple(Rh.shape), dtype=torch.float32, device=Rh.device)
    h, l = Rh, Rl
    for k in range(1, n_slices + 1):
        ik = torch.round(h * 2.0 ** (s * k))
        out[k - 1] = ik
        xk = ik * 2.0 ** (-s * k)
        h, l = df_sub((h, l), (xk, torch.zeros_like(xk)))
    return out


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _df_chol_bl_cuda(M, reg, design=None, lanes=None):
    """The FP64 factor on the card; ``design="stream"`` (or ``"smem"``, and
    ``lanes``) force a design for the on-card comparisons."""
    global DF_CHOL_LAUNCHES, DF_CHOL_SMEM_LAUNCHES
    L, dinv, plan = _launch_chol(M, reg, torch.float64, design, lanes)
    if plan is not None:
        DF_CHOL_LAUNCHES += 1
        DF_CHOL_SMEM_LAUNCHES += plan.design == "smem"
        _count_stream(plan, "chol", torch.float64, M.shape[0], M.shape[2])
    return L, dinv


def _df_solve_bl_cuda(L, dinv, R, design=None, lanes=None):
    """The FP64 solve on the card; ``design``/``lanes`` as :func:`_df_chol_bl_cuda`."""
    global DF_SOLVE_LAUNCHES, DF_SOLVE_SMEM_LAUNCHES
    V, plan = _launch_solve(L, dinv, R, torch.float64, design, lanes)
    if plan is not None:
        DF_SOLVE_LAUNCHES += 1
        DF_SOLVE_SMEM_LAUNCHES += plan.design == "smem"
        _count_stream(plan, "solve", torch.float64, L.shape[0], L.shape[2], R.shape[0])
    return V


def _slice_rounds_bl_cuda(Rh, Rl, s: int, n_slices: int):
    global SLICE_LAUNCHES
    _require(Rh.dim() == 2, f"Rh must be (r, B), got {tuple(Rh.shape)}")
    r, B = Rh.shape
    _check_cuda("Rh", Rh, (r, B))
    _check_cuda("Rl", Rl, (r, B))
    _require(Rh.device == Rl.device, "Rh and Rl must be on the same device")
    _require(1 <= s and 1 <= n_slices and s * (n_slices + 1) < 126,
             f"s={s}, n_slices={n_slices}: the slice scales must be normal f32 powers of two")
    S = torch.empty((n_slices, r, B), dtype=torch.float32, device=Rh.device)
    if r * B == 0:
        return S
    lib = _build.load()
    with torch.cuda.device(Rh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pycllp_slice_rounds_bl(
            Rh.data_ptr(), Rl.data_ptr(), S.data_ptr(), r, B, s, n_slices, stream
        )
    _raise_on_error("slice_rounds_bl", err)
    SLICE_LAUNCHES += 1
    return S


def df_chol_bl(M, reg):
    """M (m, m, B), reg (B,) f64 → (L, dinv): factor M + reg·I per lane.

    CUDA tensors launch the hand-written FP64 kernel (float64, contiguous,
    or raise); CPU tensors run :func:`_df_chol_bl_plain`.
    """
    if M.device.type == "cpu":
        return _df_chol_bl_plain(M, reg)
    return _df_chol_bl_cuda(M, reg)


def df_solve_bl(L, dinv, R):
    """L (m, m, B), dinv (m, B), R (k, m, B) f64 → V (k, m, B): L Lᵀ v = r.

    CUDA tensors launch the hand-written FP64 kernel (float64, contiguous,
    or raise); CPU tensors run :func:`_df_solve_bl_plain`.
    """
    if L.device.type == "cpu":
        return _df_solve_bl_plain(L, dinv, R)
    return _df_solve_bl_cuda(L, dinv, R)


def slice_rounds_bl(Rh, Rl, s: int, n_slices: int):
    """(r, B) f32 hi/lo pair → (n_slices, r, B) integer-valued f32 bands.

    CUDA tensors launch the hand-written kernel (float32, contiguous, or
    raise); CPU tensors run :func:`_slice_rounds_bl_plain`.
    """
    if Rh.device.type == "cpu":
        return _slice_rounds_bl_plain(Rh, Rl, s, n_slices)
    return _slice_rounds_bl_cuda(Rh, Rl, s, n_slices)


# ---------------------------------------------------------------------------
# Ozaki-scheme exact GEMM: ~2⁻⁴⁹-accurate W @ dᵀ from exact f32 GEMMs
# ---------------------------------------------------------------------------
#
# Each operand is normalised IN F64 by its per-row (W) / per-column (dᵀ)
# maximum, rounded up to a power of two (late-IPM d reaches 5e47, beyond
# f32 range, so an f32-first split would make those columns inf), split
# into an f32 (hi, lo) pair and cut into ``n_slices`` integer-valued
# s-bit bands.  Slice pairs (k, l) are grouped by level t = k + l: within
# a group every product shares the exact quantum 2^(−s·t), so the group's
# pairs concatenate along the contraction axis into ONE f32 GEMM whose
# integer partial sums stay ≤ 2²⁴ — exact in the f32 accumulator.  The
# cut − 1 group results are combined in f64 with the outer scales.

OZAKI_S = 7  # max bits per slice
OZAKI_BITS = 66  # captured width per operand for the normal-matrix
# formation: its error is absolute (≈ n·2^(−bits)·row scale·column scale)
# and the solve amplifies it by cond(M+δI) ≈ 1e12 (reference sizing note)
OZAKI_MV_BITS = 48  # captured width for the matvecs: their consumers (IR
# residuals, the crossover's 1e-9 verification) need far less


def ozaki_mv_params(n: int, bits: int | None = None):
    """(s, n_slices, cut) for the matvec paths (``OZAKI_MV_BITS`` wide
    unless ``bits`` says otherwise)."""
    return ozaki_params(n, OZAKI_MV_BITS if bits is None else bits)


def ozaki_params(n: int, bits: int | None = None):
    """(s, n_slices, cut) for contraction length ``n``, ``bits`` wide
    (default ``OZAKI_BITS``).

    A group GEMM accumulates ≤ n·n_slices integer products of magnitude
    ≤ 2^(2s); every partial sum must stay ≤ 2²⁴.  Pick the largest s that
    satisfies it (fewer slices → fewer GEMMs), with n_slices = ceil(bits/s).
    """
    if bits is None:
        bits = OZAKI_BITS
    for s in range(OZAKI_S, 2, -1):
        n_slices = -(-bits // s)
        if n * n_slices * (1 << (2 * s)) <= (1 << 24):
            return s, n_slices, n_slices + 1
    raise ValueError(f"contraction length {n} too large for exact Ozaki slicing")


def _df_slice_int(X64, axis, *, s, n_slices, slicer=slice_rounds_bl):
    """Slice f64 ``X64`` into integer-valued s-bit f32 bands along ``axis``.

    Returns ``(slices, mx)``: a per-``axis`` scale ``mx`` (f64, an exact
    power of two) and ``n_slices`` f32 bands (indexable by band; a
    ``(n_slices, r, B)`` tensor on the 2-D axis-0 path) with integer
    entries in [−2^s, 2^s] such that X64 ≈ mx · Σ_k slices[k]·2^(−s·(k+1)).
    The normalisation is in f64, before any f32 cast.  On the 2-D axis-0
    path all rounds run in one pass of ``slicer``.
    """
    mx = X64.abs().amax(dim=axis, keepdim=True)
    mx = mx.clamp(min=torch.finfo(torch.float32).tiny)
    # E = ceil(log2(mx)); an off-by-one at exact powers of two only
    # halves/doubles the normalised magnitude
    E = torch.ceil(torch.log2(mx))
    mx = torch.exp2(E)  # exact power of two
    Rh, Rl = _split_hi_lo(X64 * torch.exp2(-E))  # exact scaling; |R| ≤ 1
    if X64.dim() == 2 and axis == 0:
        return slicer(Rh.contiguous(), Rl.contiguous(), s, n_slices), mx
    slices = []
    for k in range(1, n_slices + 1):
        ik = torch.round(Rh * 2.0 ** (s * k))  # integer-valued
        slices.append(ik)
        xk = ik * 2.0 ** (-s * k)
        Rh, Rl = df_sub((Rh, Rl), (xk, torch.zeros_like(xk)))
    return slices, mx


def _group_levels(n_slices, cut):
    """For each level t = 2 … cut, the slice indices k of its pairs."""
    return [
        (t, range(max(1, t - n_slices), min(n_slices, t - 1) + 1))
        for t in range(2, cut + 1)
    ]


class OzakiOperand(typing.NamedTuple):
    """``W`` (rows, n) prepared once for Ozaki products against many ``d``:
    its slices held once, as the kernel reads them (the plain and split
    routes unpack one slice at a time, :func:`_ozaki_slice`)."""

    e: typing.Any  # (rows, 1) f64 per-row scale, an exact power of two
    packed: typing.Any  # every slice as bf16, in the fragment order of ozaki_product_bl


OZAKI_ROW_PAD = 32  # packed rows: a multiple of the kernel's 32-row tile (csrc/ozaki.cuh)
OZAKI_MAX_LEVELS = 24  # cut − 1 of the kernel's largest instantiation
# the f32 slices of one row block of a prepare, so that its transient memory
# stays near this whatever rows is (in one piece, SCAGR25's W, 221,856 × 971
# at 14 slices, would hold 12 GB of them)
OZAKI_PREPARE_BLOCK_BYTES = 1 << 30


def _kernel_takes(s: int, n_slices: int) -> bool:
    """Whether ``ozaki_product_bl`` runs ``n_slices`` s-bit slices: at most
    ``OZAKI_MAX_LEVELS`` levels (cut − 1 = n_slices), and every slice scale
    2^(s·k) a normal f32 power of two, as its wrapper requires."""
    return 1 <= n_slices <= OZAKI_MAX_LEVELS and s * (n_slices + 1) < 126


def check_ozaki_width(bits, what: str = "bits") -> int:
    """``bits`` as an int, or ``ValueError`` when no contraction length
    gives the kernel a product it runs (the width alone decides)."""
    if isinstance(bits, bool) or int(bits) != bits or bits < 1:
        raise ValueError(f"Ozaki width {what}={bits!r} must be a positive integer")
    if not any(_kernel_takes(s, -(-int(bits) // s)) for s in range(OZAKI_S, 2, -1)):
        raise ValueError(
            f"Ozaki width {what}={bits} gives more levels than ozaki_product_bl takes at "
            f"every contraction length: at most {OZAKI_MAX_LEVELS} levels, each slice scale "
            f"below 2^126"
        )
    return int(bits)


def check_ozaki_levels(n: int, bits: int, what: str = "bits") -> None:
    """``ValueError`` when ``bits`` at contraction length ``n`` gives more
    levels than ``ozaki_product_bl`` takes."""
    s, n_slices, _ = ozaki_params(n, bits)
    if not _kernel_takes(s, n_slices):
        raise ValueError(
            f"Ozaki width {what}={bits} at contraction length {n} gives {n_slices} levels of "
            f"{s} bits: ozaki_product_bl takes at most {OZAKI_MAX_LEVELS} levels, each slice "
            f"scale below 2^126"
        )


def _pack_slices(slices):
    """W's ``n_slices`` (rows, n) integer slices → bf16 ``(rows_pad/16,
    n_slices, n_pad/16, 32, 8)``: for each 16-row tile, slice and 16-column
    step, the 32 lanes' A fragments of ``mma.m16n8k16`` in register order
    (csrc/ozaki.cuh).  Lane 4g + q holds rows (g, g + 8) and columns (2q,
    2q + 1, 2q + 8, 2q + 9) as a0 … a7; rows pad to 32, columns to 16, with
    zeros.  The slices are integers ≤ 2^s ≤ 2⁷, so bf16 holds them exactly.
    """
    S = torch.stack(list(slices)).to(torch.bfloat16)
    ns, rows, n = S.shape
    Rp = -(-rows // OZAKI_ROW_PAD) * OZAKI_ROW_PAD
    Np = -(-n // 16) * 16
    S = torch.nn.functional.pad(S, (0, Np - n, 0, Rp - rows))
    # (k, row tile, h, g, column step, c8, q, e): row = 16·tile + 8h + g,
    # column = 16·step + 8·c8 + 2q + e
    S = S.reshape(ns, Rp // 16, 2, 8, Np // 16, 2, 4, 2)
    return S.permute(1, 0, 4, 3, 6, 5, 2, 7).reshape(Rp // 16, ns, Np // 16, 32, 8).contiguous()


def _ozaki_prepare(W64, *, s, n_slices, cut):
    """Slice ``W`` (rows, n) once: an :class:`OzakiOperand`.

    The rows are sliced and packed in blocks of whole 32-row tiles whose
    f32 slices take about ``OZAKI_PREPARE_BLOCK_BYTES``: the slicing is per
    row, so the blocks give the one-shot operand bit for bit.
    """
    rows, n = W64.shape
    tile_bytes = 4 * n_slices * max(n, 1) * OZAKI_ROW_PAD
    per = max(1, OZAKI_PREPARE_BLOCK_BYTES // tile_bytes) * OZAKI_ROW_PAD
    packed = torch.empty((-(-rows // OZAKI_ROW_PAD) * OZAKI_ROW_PAD // 16, n_slices,
                          -(-n // 16), 32, 8), dtype=torch.bfloat16, device=W64.device)
    e = torch.empty((rows, 1), dtype=torch.float64, device=W64.device)
    for r0 in range(0, rows, per):
        r1 = min(r0 + per, rows)
        sl, e[r0:r1] = _df_slice_int(W64[r0:r1].to(torch.float64), axis=1, s=s,
                                     n_slices=n_slices)
        block = _pack_slices(sl)
        packed[r0 // 16:r0 // 16 + block.shape[0]] = block
    return OzakiOperand(e=e, packed=packed)


def _ozaki_slice(W, k: int, n: int):
    """Slice ``k`` (1 … n_slices) of the operand ``W``, (rows, n) f32,
    unpacked from ``W.packed`` (the inverse of :func:`_pack_slices`)."""
    P = W.packed[:, k - 1]
    RT, JS = P.shape[:2]
    # (tile, step, g, q, c8, h, e) → (tile, h, g, step, c8, q, e)
    P = P.reshape(RT, JS, 8, 4, 2, 2, 2).permute(0, 5, 2, 1, 4, 3, 6)
    return P.reshape(RT * 16, JS * 16)[: W.e.shape[0], :n].float()


def _ozaki_group_gemms(W, d, *, s, n_slices, cut, slicer=slice_rounds_bl):
    """The group-GEMM route of the product: ``d`` sliced by ``slicer``, each
    level's integer sum Σ_k W_k·d_(t−k) in f32, combined in f64 in level
    order.  Every partial sum of a level stays ≤ 2²⁴, so the per-slice
    products add up exactly, to the bits of one GEMM of the level's slices
    side by side; W's slices are unpacked one at a time."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the Ozaki group GEMMs need full f32 accumulation: switch TF32 off "
            "(torch.backends.cuda.matmul.allow_tf32 = False)"
        )
    n = d.shape[-1]
    dsl, de = _df_slice_int(d.to(torch.float64).T, axis=0, s=s, n_slices=n_slices,
                            slicer=slicer)
    levels = _group_levels(n_slices, cut)
    sums = [None] * len(levels)
    for k in range(1, n_slices + 1):
        Wk = _ozaki_slice(W, k, n)
        for i, (t, ks) in enumerate(levels):
            if k in ks:
                p = Wk @ dsl[t - k - 1]
                sums[i] = p if sums[i] is None else sums[i] + p
    acc = None
    for (t, _), G in zip(levels, sums):
        term = G.to(torch.float64) * 2.0 ** (-s * t)
        acc = term if acc is None else acc + term
    return acc * (W.e * de)


def _ozaki_matmul_plain(W, d, *, s, n_slices, cut):
    """Plain version of ``ozaki_product_bl``: every step a PyTorch op
    (the slicing by :func:`_slice_rounds_bl_plain`).  Raises with TF32 on."""
    return _ozaki_group_gemms(W, d, s=s, n_slices=n_slices, cut=cut,
                              slicer=_slice_rounds_bl_plain)


def _ozaki_matmul_split(W, d, *, s, n_slices, cut):
    """The card's route before ``ozaki_product_bl``: the ``slice_rounds_bl``
    kernel, then f32 ``torch.matmul`` products of W's slices and the f64
    sum.  On no solver path; ``chip_smoke.py`` holds the kernel to it
    bitwise."""
    return _ozaki_group_gemms(W, d, s=s, n_slices=n_slices, cut=cut)


def _ozaki_product_bl_cuda(W, d, s: int, n_slices: int, cut: int):
    """``W @ dᵀ`` as one launch of the hand-written ``ozaki_product_bl``."""
    global OZAKI_LAUNCHES
    _require(d.dim() == 2, f"d must be (B, n), got {tuple(d.shape)}")
    B, n = d.shape
    _require(d.is_cuda, f"d must be a CUDA tensor, got device {d.device}")
    _require(d.dtype == torch.float64, f"d must be torch.float64, got {d.dtype}")
    rows = W.e.shape[0]
    _check_cuda("We", W.e, (rows, 1), torch.float64)
    shape = (-(-rows // OZAKI_ROW_PAD) * OZAKI_ROW_PAD // 16, n_slices, -(-n // 16), 32, 8)
    _check_cuda("W.packed", W.packed, shape, torch.bfloat16)
    _require(W.e.device == W.packed.device == d.device, "W and d must be on the same device")
    _require(1 <= s and 2 <= cut <= OZAKI_MAX_LEVELS + 1 and s * (n_slices + 1) < 126,
             f"s={s}, n_slices={n_slices}, cut={cut}: the kernel takes 1 to "
             f"{OZAKI_MAX_LEVELS} levels and normal f32 slice scales")
    _require(max(d.stride()) < 2**31, "d's strides must fit in 32 bits")
    out = torch.empty((rows, B), dtype=torch.float64, device=d.device)
    if rows * B == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pycllp_ozaki_product_bl(
            W.packed.data_ptr(), W.e.data_ptr(), d.data_ptr(), out.data_ptr(), rows, n, B,
            d.stride(0), d.stride(1), s, n_slices, cut, stream,
        )
    _raise_on_error("ozaki_product_bl", err)
    OZAKI_LAUNCHES += 1
    return out


def _ozaki_matmul(W, d, *, s, n_slices, cut):
    """~2^(−s·(cut−1))-accurate ``W @ dᵀ`` in f64, as (rows, B).

    ``W``: an :class:`OzakiOperand` from :func:`_ozaki_prepare`; ``d``:
    (B, n), any strides, sliced per lane along n.  A CUDA ``d`` launches
    ``ozaki_product_bl`` (or raises); a CPU ``d`` runs
    :func:`_ozaki_matmul_plain`.
    """
    global OZAKI_MATMUL_LAUNCHES
    if d.device.type == "cpu":
        return _ozaki_matmul_plain(W, d, s=s, n_slices=n_slices, cut=cut)
    OZAKI_MATMUL_LAUNCHES += bool(d.shape[0] and W.e.shape[0])
    return _ozaki_product_bl_cuda(W, d.to(torch.float64), s, n_slices, cut)


# ---------------------------------------------------------------------------
# KernelSet implementation (f64 public interface)
# ---------------------------------------------------------------------------


class PreparedDF(typing.NamedTuple):
    A: typing.Any  # (m, n) or (B, m, n) f64
    Asq: typing.Any
    W: typing.Any  # (m², n) f64 self-outer-product, or None for 3-D A
    Wh: typing.Any  # f32 hi/lo split of W (the fast formation's GEMM inputs)
    Wl: typing.Any
    Woz: typing.Any  # OzakiOperand of W, or None
    Amv: typing.Any  # OzakiOperand of A — exact f64 matvecs
    Armv: typing.Any  # ... and of Aᵀ (different contraction length)


class DFFactor(typing.NamedTuple):
    """FP64 batch-last factor: L (m, m, B), dinv (m, B)."""

    ctx: PreparedDF
    L: typing.Any
    dinv: typing.Any
    d: typing.Any
    reg: typing.Any  # the f64 shift; the factor saw it rounded to f32


class DoubleSingleKernels(KernelSet):
    """f64-interface kernel set whose O(m³) work runs in FP64 CUDA kernels.

    The reference's name is kept (there the factor and solve run in
    double-single Pallas); on the card they compute in native FP64.
    Shared-A matvecs run as Ozaki products; the normal matrix is formed
    by the Ozaki product (``form="ozaki"``, default), an f64 GEMM
    (``form="f64"``) or three f32 GEMMs on hi/lo splits (``form="fast"``),
    and handed to :func:`df_chol_bl` in f64.

    ``bits`` is the Ozaki formation's width and ``mv_bits`` the matvecs'
    (the reference's ``PYCLLP_OZAKI_BITS`` / ``PYCLLP_OZAKI_MV_BITS``).  A
    width that gives more levels than the kernel takes raises
    ``ValueError``: here when the width alone decides it, else in
    :meth:`prepare` (:meth:`check_ozaki_levels`).

    ``form="fast"`` is the reference's recorded negative result, kept
    because a user can select it: its f32 accumulation gives M to ~1e-7
    relative, too coarse for the 1e-12 shift (the reference measured 15.8K
    of 16.4K lanes NUMERICAL), and a late-IPM ``d`` beyond f32's range
    makes its hi part ``inf``, so that lane's factor is NaN.  Both are
    reproduced, not repaired.
    """

    name = "cuda_df64"

    def __init__(self, form: str = "ozaki", *, bits: int = OZAKI_BITS,
                 mv_bits: int = OZAKI_MV_BITS):
        if form not in ("ozaki", "f64", "fast"):
            raise ValueError(f"unknown formation {form!r}")
        self.form = form
        self.bits = check_ozaki_width(bits, "bits")
        self.mv_bits = check_ozaki_width(mv_bits, "mv_bits")
        if form != "ozaki":
            self.name = f"cuda_df64_{form}form"
        if (self.bits, self.mv_bits) != (OZAKI_BITS, OZAKI_MV_BITS):
            self.name = f"{self.name}(bits={self.bits}, mv_bits={self.mv_bits})"

    def check_ozaki_levels(self, m: int, n: int) -> None:
        if self.form == "ozaki":
            check_ozaki_levels(n, self.bits, "bits")
        check_ozaki_levels(n, self.mv_bits, "mv_bits")
        check_ozaki_levels(m, self.mv_bits, "mv_bits")

    def prepare(self, A):
        A = A.to(torch.float64)
        if A.dim() != 2:
            return PreparedDF(A=A, Asq=A * A, W=None, Wh=None, Wl=None, Woz=None, Amv=None,
                              Armv=None)
        m, n = A.shape
        self.check_ozaki_levels(m, n)
        W = (A[:, None, :] * A[None, :, :]).reshape(m * m, n)
        Wh, Wl = _split_hi_lo(W) if self.form == "fast" else (None, None)
        Woz = None
        if self.form == "ozaki":
            s, n_slices, cut = ozaki_params(n, self.bits)
            Woz = _ozaki_prepare(W, s=s, n_slices=n_slices, cut=cut)
        sm, nm, cm = ozaki_mv_params(n, self.mv_bits)
        sr, nr, cr = ozaki_mv_params(m, self.mv_bits)
        Amv = _ozaki_prepare(A, s=sm, n_slices=nm, cut=cm)
        Armv = _ozaki_prepare(A.T, s=sr, n_slices=nr, cut=cr)
        return PreparedDF(A=A, Asq=A * A, W=W, Wh=Wh, Wl=Wl, Woz=Woz, Amv=Amv, Armv=Armv)

    def mv(self, ctx, x):
        if getattr(ctx, "Amv", None) is None or x.dim() != 2:
            return _amv(ctx.A, x)
        s, n_slices, cut = ozaki_mv_params(ctx.A.shape[-1], self.mv_bits)
        return _ozaki_matmul(ctx.Amv, x, s=s, n_slices=n_slices, cut=cut).T

    def rmv(self, ctx, y):
        if getattr(ctx, "Armv", None) is None or y.dim() != 2:
            return _armv(ctx.A, y)
        s, n_slices, cut = ozaki_mv_params(ctx.A.shape[-2], self.mv_bits)
        return _ozaki_matmul(ctx.Armv, y, s=s, n_slices=n_slices, cut=cut).T

    def matvec_M(self, fac, v):
        return _matvec_M(self, fac, v)

    def factor(self, ctx, d, reg_eps):
        if not isinstance(ctx, PreparedDF):
            ctx = self.prepare(ctx.A)
        d = d.to(torch.float64)
        m = ctx.A.shape[-2]
        B = d.shape[0]
        # reg needs only max(diag(ADAᵀ)) to ~%: d spans beyond f32 range,
        # so normalise per lane in f64 first, run one f32 product, rescale
        dmax_s = d.amax(dim=-1).clamp(min=torch.finfo(torch.float64).tiny)
        ds = (d / dmax_s[..., None]).to(torch.float32)
        diag32 = _amv(ctx.Asq.to(torch.float32), ds)
        reg = reg_eps * diag32.amax(dim=-1).to(torch.float64) * dmax_s
        if ctx.W is None:
            M = torch.einsum("bmn,bn,bkn->mkb", ctx.A, d, ctx.A).contiguous()
        elif self.form == "ozaki":
            s, n_slices, cut = ozaki_params(ctx.A.shape[-1], self.bits)
            M = _ozaki_matmul(ctx.Woz, d, s=s, n_slices=n_slices, cut=cut).reshape(m, m, B)
        elif self.form == "fast":
            # three f32 GEMMs (full f32: the solver switches TF32 off); a d
            # beyond f32's range makes dh inf and NaNs the lane, as in the
            # reference
            dh, dl = _split_hi_lo(d.T)
            P = ctx.Wh @ dh
            Q = ctx.Wh @ dl + ctx.Wl @ dh
            M = (P.to(torch.float64) + Q.to(torch.float64)).reshape(m, m, B)
        else:
            M = (ctx.W @ d.T).reshape(m, m, B)  # batch-last directly
        # the factor sees δ rounded to f32, as the reference's kernel adds
        # (reg_f32, 0): keeping that rounding keeps the factor the reference's
        reg_k = reg.to(torch.float32).to(torch.float64)
        L, dinv = df_chol_bl(M, reg_k)
        return DFFactor(ctx=ctx, L=L, dinv=dinv, d=d, reg=reg)

    def solve(self, fac, rs):
        R = torch.stack([r.T for r in rs], dim=0).to(torch.float64)  # (k, m, B)
        V = df_solve_bl(fac.L, fac.dinv, R)
        return tuple(V[i].T for i in range(len(rs)))


DF64_FINISH_KERNELS = DoubleSingleKernels()  # Ozaki formation (default)
DF64_F64FORM_KERNELS = DoubleSingleKernels(form="f64")
DF64_FASTFORM_KERNELS = DoubleSingleKernels(form="fast")
