"""Scenario-axis sharding of the batched HSD solve over a process group.

Counterpart of :mod:`pycllp_tpu.parallel.shard`.  The scenario batch
partitions over the ranks of a 1-D mesh (one rank per device): each rank
solves its contiguous ``B/P`` rows, and every rank returns the whole
batch, all-gathered in rank order.  Per-iteration termination is gated
either

* ``collective`` — every loop predicate all-reduces the rank's
  any-running flag with MAX (:class:`CollectiveAny`): all ranks step in
  lockstep and leave each loop on the same iteration (BASELINE.md's
  "collective convergence gating"), or
* ``local`` — each rank runs its own loops and finishes independently
  (no per-iteration collective; best throughput for independent
  instances).

Shared-structure A is replicated; per-instance A shards with the batch.
With no process group the mesh has one device and every collective is
the identity.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pycllp_tpu_torch.ops.reference import KernelSet, REFERENCE_KERNELS
from pycllp_tpu_torch.parallel.collectives import all_gather, make_mesh, pmax
from pycllp_tpu_torch.solvers.hsd import (
    _check_finish_levels,
    _finish_dtype,
    _finish_opts_view,
    _full_precision_matmuls,
    _hsd_scan_finish_core,
    _hsd_scan_narrow_core,
    _narrow_opts_view,
    _resolve_dtype,
    hsd_solve_batched,
)
from pycllp_tpu_torch.solvers.options import SolverOptions
from pycllp_tpu_torch.utils.device import resolve_device

__all__ = [
    "scenario_mesh",
    "CollectiveAny",
    "sharded_hsd_solve",
    "sharded_hsd_solve_scan",
]


def scenario_mesh(n_devices: int | None = None, axis: str = "scenario"):
    """1-D mesh over the ranks of the default process group (default all;
    ``n_devices=1``, or no group, gives a size-1 mesh)."""
    return make_mesh(n_devices, axis)


@dataclass(frozen=True)
class CollectiveAny:
    """any(mask) OR-reduced across the mesh: a Python bool, the same on
    every rank.  The flag goes through ``all_reduce(MAX)`` as an int32
    (``ReduceOp.MAX`` does not take ``bool``)."""

    mesh: object

    def __call__(self, mask) -> bool:
        local = mask.any().to(torch.int32).reshape(1)
        return bool(pmax(local, self.mesh)[0] > 0)


def _local_rows(B: int, mesh) -> slice:
    """This rank's contiguous share of a batch of ``B`` (``B % P == 0``)."""
    per = B // mesh.size()
    r = mesh.get_local_rank()
    return slice(r * per, (r + 1) * per)


def sharded_hsd_solve(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    mesh=None,
    kset: KernelSet = REFERENCE_KERNELS,
    termination: str = "collective",
    *,
    device="cuda",
):
    """Solve an equality-form LP batch with the scenario axis sharded.

    ``b``/``c`` are the global (B, m)/(B, n) batch on every rank, B
    divisible by the mesh size; ``A`` is (m, n) shared (replicated) or
    (B, m, n) (sharded with the batch).  Every rank solves its contiguous
    ``B/P`` rows with :func:`hsd_solve_batched` on ``device`` and returns
    the same dict as that function for the WHOLE batch (all-gathered in
    rank order).  Every rank of the mesh calls this together.
    """
    if mesh is None:
        mesh = scenario_mesh()
    n_dev = mesh.size()
    B = b.shape[0]
    if B % n_dev:
        raise ValueError(f"batch {B} not divisible by mesh size {n_dev}")
    if termination not in ("collective", "local"):
        raise ValueError(f"unknown termination {termination!r}")
    dev = resolve_device(device)
    rows = _local_rows(B, mesh)
    A_l = A[rows] if getattr(A, "ndim", 2) == 3 else A
    reduce_any = CollectiveAny(mesh) if termination == "collective" else None
    out = hsd_solve_batched(A_l, b[rows], c[rows], opts, kset, reduce_any, device=dev)
    return {k: all_gather(v, mesh) for k, v in out.items()}


def sharded_hsd_solve_scan(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    mesh=None,
    kset: KernelSet = REFERENCE_KERNELS,
    *,
    chunk: int = 16384,
    keys: tuple = ("objective", "status", "iterations"),
    compact_cap: int | None = None,
    compact_bucket: int = 8192,
    finish_cap: int = 6,
    finish_bucket: int | None = None,
    warm_chain: bool = False,
    device="cuda",
):
    """Scenario-sharded twin of :func:`pycllp_tpu_torch.solvers.hsd.hsd_solve_scan`.

    Each rank runs the whole chunked sweep — capped chunks, compaction and
    warm resume, and (with ``opts.finish_dtype``) the wide crossover/drain
    finish — on its own slice of the scenario stream.  Termination is
    rank-LOCAL: compaction repacks lanes within a rank, so there is no
    lockstep to keep, and no collective runs until the results are
    gathered.

    ``b``/``c`` are the global (N, m)/(N, n) on every rank, with shared 2-D
    ``A``.  N is padded up to a ``chunk × mesh-size`` multiple (repeating
    the last row) and trimmed on return; buckets apply PER RANK.  Every
    rank returns the whole ``keys`` dict, gathered in rank order.
    """
    if getattr(A, "ndim", 2) != 2:
        raise ValueError("sharded_hsd_solve_scan requires shared 2-D A")
    if mesh is None:
        mesh = scenario_mesh()
    n_dev = mesh.size()
    dev = resolve_device(device)
    b = torch.as_tensor(b, device=dev)
    c = torch.as_tensor(c, device=dev)
    N = b.shape[0]
    chunk = max(1, min(chunk, -(-N // n_dev)))
    quantum = chunk * n_dev
    pad = (-N) % quantum
    if pad:
        b = torch.cat([b, b[-1:].expand(pad, -1)])
        c = torch.cat([c, c[-1:].expand(pad, -1)])
    K = b.shape[0] // chunk  # divisible by n_dev by construction
    rows = _local_rows(K, mesh)
    b3 = b.reshape(K, chunk, -1)[rows]
    c3 = c.reshape(K, chunk, -1)[rows]
    local_n = (K // n_dev) * chunk
    cap = int(compact_cap) if compact_cap is not None else 12
    bucket = min(int(compact_bucket), local_n)
    fbucket = min(int(finish_bucket or compact_bucket), local_n)

    dtype = _resolve_dtype(opts, A, b, c)
    keys = tuple(keys)
    with _full_precision_matmuls():
        if _finish_dtype(opts, dtype) is None:
            res = _hsd_scan_narrow_core(A, b3, c3, opts, kset, keys, cap, bucket, dev,
                                        bool(warm_chain))
        else:
            _check_finish_levels(kset, opts, A)
            phase1_tol = max(opts.tol, opts.switch_tol)
            sflat = _hsd_scan_narrow_core(
                A, b3, c3, _narrow_opts_view(opts, phase1_tol), kset, None, cap, bucket, dev,
                bool(warm_chain),
            )
            res = _hsd_scan_finish_core(
                A, b3, c3, sflat, _finish_opts_view(opts), kset, keys, int(finish_cap), fbucket,
                dev, rounds=max(4, -(-local_n // fbucket)),
            )
    return {k: all_gather(res[k], mesh)[:N] for k in keys}
