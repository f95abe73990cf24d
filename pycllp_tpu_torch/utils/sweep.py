"""Chunked scenario sweeps with checkpoint/resume.

Counterpart of :mod:`pycllp_tpu.utils.sweep`.  A stochastic-LP sweep
(shared A, per-scenario b/c — the pywr-style init-once/re-solve pattern
at scale) streamed through the batched solver in chunks, each chunk's
results persisted so an interrupted sweep resumes by skipping completed
chunks.  There is no in-iteration checkpointing: an IPM solve is cheap
to redo, so the chunk is the unit.

The on-disk format is the reference's: the same ``manifest.json`` (with
``dtype`` as a numpy dtype name) and the same ``chunk_*.npz`` keys, so a
sweep directory started by either package is resumed by the other.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from pycllp_tpu_torch.ops.reference import KernelSet, REFERENCE_KERNELS
from pycllp_tpu_torch.parallel.collectives import psum
from pycllp_tpu_torch.solvers import _loop
from pycllp_tpu_torch.solvers.hsd import hsd_solve_batched, hsd_solve_scan
from pycllp_tpu_torch.solvers.options import SolverOptions
from pycllp_tpu_torch.utils.device import resolve_device

__all__ = ["SweepResult", "scenario_sweep"]

_MANIFEST = "manifest.json"


@dataclass
class SweepResult:
    objective: np.ndarray  # (N,)
    status: np.ndarray  # (N,)
    iterations: np.ndarray  # (N,)
    n_chunks: int
    n_resumed: int  # chunks skipped because already on disk


def _chunk_path(out_dir: str, k: int) -> str:
    return os.path.join(out_dir, f"chunk_{k:06d}.npz")


def _dtype_name(opts: SolverOptions, b) -> str:
    """The manifest's dtype: a numpy dtype name, whatever ``b`` is."""
    if opts.dtype:
        return str(np.dtype(opts.dtype))
    return str(b.dtype).removeprefix("torch.")


def _check_manifest(out_dir: str, manifest: dict) -> bool:
    """Create the sweep directory and its manifest, or check the one there:
    False when it holds a different configuration."""
    os.makedirs(out_dir, exist_ok=True)
    mpath = os.path.join(out_dir, _MANIFEST)
    if not os.path.exists(mpath):
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        return True
    with open(mpath) as f:
        return json.load(f) == manifest


def _repeat_last(v, pad: int):
    """Append ``pad`` copies of the last row (numpy array or tensor)."""
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v[-1:].expand(pad, -1)])
    return np.concatenate([v, np.repeat(v[-1:], pad, 0)], 0)


@_loop._spanned("scenario_sweep")
def scenario_sweep(
    A,
    b,
    c,
    opts: SolverOptions = SolverOptions(),
    *,
    chunk: int = 16384,
    out_dir: str | None = None,
    save_x: bool = False,
    mesh=None,
    solve_fn: Callable | None = None,
    progress: Callable[[int, int], None] | None = None,
    kset: KernelSet = REFERENCE_KERNELS,
    window_chunks: int = 8,
    compact_cap: int | None = None,
    compact_bucket: int = 8192,
    finish_cap: int = 6,
    finish_bucket: int | None = None,
    warm_chain: bool = False,
    device="cuda",
) -> SweepResult:
    """Solve N scenarios (shared A, batched b/c) in chunks.

    ``A``/``b``/``c`` are numpy arrays or tensors; ``device`` is where the
    solves run (``"cuda"`` by default, as every solver of the port).

    With ``out_dir`` set, per-chunk results persist as ``chunk_*.npz``
    (written to ``*.tmp.npz``, then renamed: a crash never leaves half a
    chunk) and a manifest pins (shapes, chunk, tol, dtype, save_x) so a
    restarted sweep with the same configuration skips completed chunks; a
    mismatched configuration raises rather than silently mixing results.

    Dispatch: on the default path (shared 2-D A, no custom ``solve_fn``)
    up to ``window_chunks`` chunks run through ONE :func:`hsd_solve_scan`
    (optionally with the cap/compact/warm-resume sweep and the wide
    finish).  The chunk stays the persist/resume unit; a window holding
    any missing chunk is re-solved whole and only its missing chunks are
    written (an LP re-solve is deterministic and cheap).  Whole, because
    a lane's answer can depend on the rest of its window: the compaction
    and drain buckets gather lanes across the window's chunks, and lanes
    beyond a full bucket keep their capped answer.  So a resumed sweep
    equals an uninterrupted one, however it was cut.  (The JAX package
    re-solves only the span from the window's first to its last missing
    chunk.)  A ``chunk_*.npz.tmp.npz`` left by a killed writer is never
    read, and is overwritten when its chunk is written.

    ``warm_chain``: chunk-to-chunk warm starts within each window (see
    :func:`hsd_solve_scan`); the chain restarts at window boundaries, and
    therefore on resume.

    ``mesh``: a scenario mesh (:func:`pycllp_tpu_torch.parallel.scenario_mesh`);
    every rank calls the sweep with the same arguments, and each chunk is
    solved by :func:`pycllp_tpu_torch.parallel.sharded_hsd_solve` (one
    chunk a call; the scan path is off).  Only the mesh's rank 0 writes
    the manifest and the chunk files.  Rank 0 alone checks the manifest
    and decides which chunks are missing, and broadcasts that (the
    collective is every other rank's barrier before it reads a chunk
    file), so every rank solves the same chunks and calls the same
    collectives, and a mismatched directory raises on every rank.

    Profiler marks (``torch.profiler.record_function`` ranges): the whole
    call as ``scenario_sweep``; in each window, the pull of its outputs
    to numpy as ``sweep pull`` and each chunk file's write as ``sweep
    write``.
    """
    N = b.shape[0]
    if c.shape[0] != N:
        raise ValueError("b and c must agree on the scenario count")
    n_chunks = -(-N // chunk)
    writer = mesh is None or mesh.get_local_rank() == 0

    done = np.zeros(n_chunks, bool)  # chunks found on disk
    if out_dir is not None:
        manifest = {
            "N": int(N),
            "chunk": int(chunk),
            "m": int(A.shape[-2]),
            "n": int(A.shape[-1]),
            "tol": opts.tol,
            "dtype": _dtype_name(opts, b),
            "save_x": bool(save_x),
        }
        manifest_ok = True
        if writer:
            manifest_ok = _check_manifest(out_dir, manifest)
            done = np.array([os.path.exists(_chunk_path(out_dir, k)) for k in range(n_chunks)])
        if mesh is not None:
            # rank 0's verdict and chunk list, to every rank (the others
            # contribute zeros to the sum)
            flags = torch.zeros(n_chunks + 1, dtype=torch.int32, device=resolve_device(device))
            if writer:
                flags[0] = int(manifest_ok)
                flags[1:] = torch.from_numpy(done)
            flags = psum(flags, mesh).cpu()
            manifest_ok, done = bool(flags[0]), flags[1:].numpy().astype(bool)
        if not manifest_ok:
            raise ValueError(f"sweep dir {out_dir} holds a different configuration than {manifest}")

    scan_ok = solve_fn is None and mesh is None and getattr(A, "ndim", 2) == 2
    if solve_fn is None:
        if mesh is not None:
            from pycllp_tpu_torch.parallel import sharded_hsd_solve

            def solve_fn(Ab, bb, cb):
                return sharded_hsd_solve(Ab, bb, cb, opts, mesh=mesh, kset=kset, device=device)

        else:

            def solve_fn(Ab, bb, cb):
                return hsd_solve_batched(Ab, bb, cb, opts, kset, device=device)

    objective = np.zeros(N)
    status = np.zeros(N, np.int32)
    iterations = np.zeros(N, np.int32)
    n_resumed = 0
    keys = ("objective", "status", "iterations") + (("x",) if save_x else ())

    @_loop._spanned("sweep write")
    def persist(path, sl, out, lo, hi):
        payload = {k_: out[k_][sl][: hi - lo] for k_ in keys}
        tmp = path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)  # atomic: a crash never leaves half-chunks

    window = max(1, window_chunks if scan_ok else 1)
    k = 0
    while k < n_chunks:
        kw = min(window, n_chunks - k)
        paths = [_chunk_path(out_dir, k + j) if out_dir else None for j in range(kw)]
        missing = [j for j in range(kw) if not done[k + j]]
        for j in range(kw):
            if j in missing:
                continue
            lo, hi = (k + j) * chunk, min((k + j + 1) * chunk, N)
            with np.load(paths[j]) as data:
                objective[lo:hi] = data["objective"]
                status[lo:hi] = data["status"]
                iterations[lo:hi] = data["iterations"]
            n_resumed += 1
        if missing:
            lo_w = k * chunk
            hi_w = min((k + kw) * chunk, N)
            bb, cb = b[lo_w:hi_w], c[lo_w:hi_w]
            if scan_ok:
                out = hsd_solve_scan(
                    A, bb, cb, opts, kset, chunk=chunk, keys=keys,
                    compact_cap=compact_cap, compact_bucket=compact_bucket,
                    finish_cap=finish_cap, finish_bucket=finish_bucket,
                    warm_chain=warm_chain, device=device,
                )
            else:
                pad = chunk - (hi_w - lo_w)
                if pad > 0:  # the tail chunk is solved at the full chunk width
                    bb, cb = _repeat_last(bb, pad), _repeat_last(cb, pad)
                out = solve_fn(A, bb, cb)
            # ONE pull per key
            with torch.profiler.record_function("sweep pull"):
                out = {k_: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                       for k_, v in out.items()}
            for j in missing:
                lo, hi = (k + j) * chunk, min((k + j + 1) * chunk, N)
                sl = slice(lo - lo_w, lo - lo_w + chunk)
                objective[lo:hi] = out["objective"][sl][: hi - lo]
                status[lo:hi] = out["status"][sl][: hi - lo]
                iterations[lo:hi] = out["iterations"][sl][: hi - lo]
                if paths[j] and writer:
                    persist(paths[j], sl, out, lo, hi)
        if progress is not None:
            progress(min(k + kw, n_chunks), n_chunks)
        k += kw

    return SweepResult(
        objective=objective,
        status=status,
        iterations=iterations,
        n_chunks=n_chunks,
        n_resumed=n_resumed,
    )
