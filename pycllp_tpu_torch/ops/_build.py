"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` (one process per ``.cu``, started
together, then one link) into a shared library with a plain
``extern "C"`` interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds.  The library goes to ``build/kernels/`` beside
the package (git-ignored), named by a hash of the sources and flags: it
is rebuilt only when a source changes, and only from the sources shipped
with the package.

Nothing here runs at import time.  :func:`load` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

__all__ = ["BuildInfo", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "kernels"

# per-source compile flags; no fast-math flag: the slicing kernel must
# keep denormals and IEEE rounding to match its plain version bit for bit
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in BuildInfo.log
)

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_int64
_LANE_MATVEC = (_INT, _VP) + (_VP, _I64, _I64) * 3 + (_VP, _I64, _VP) + (_INT,) * 8 + (_VP,)
# C entry points: name -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "pycllp_chol_bl_f32": (_VP, _VP, _VP, _VP, _INT, _INT, _VP),
    "pycllp_solve_bl_f32": (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP),
    "pycllp_fused_factor_bl_f32": (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP),
    "pycllp_facsol_bl_f32": (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP),
    "pycllp_chol_bl_f64": (_VP, _VP, _VP, _VP, _INT, _INT, _VP),
    "pycllp_solve_bl_f64": (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP),
    # the lane-group designs: ... m, B, [k_rhs,] G (lanes per block), stream
    "pycllp_chol_bl_smem_f32": (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP),
    "pycllp_solve_bl_smem_f32": (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
    "pycllp_chol_bl_smem_f64": (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP),
    "pycllp_solve_bl_smem_f64": (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
    "pycllp_fused_factor_bl_smem_f32": (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
    "pycllp_facsol_bl_smem_f32": (_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
    "pycllp_slice_rounds_bl": (_VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP),
    # Wp, We, d, out, rows, n, B, d's strides (lane, contraction), s, n_slices, cut, stream
    "pycllp_ozaki_product_bl": (_VP, _VP, _VP, _VP) + (_INT,) * 8 + (_VP,),
    # mode, A, then x, s, y each with its (lane, element) strides, reg and its lane
    # stride, out, m, n, B, P, Q, bulk, grid, smem, stream
    "pycllp_lane_matvec_f32": _LANE_MATVEC,
    "pycllp_lane_matvec_f64": _LANE_MATVEC,
}


class BuildInfo(NamedTuple):
    path: Path  # the shared library
    seconds: float  # wall time of this call's compile (0.0 when cached)
    cached: bool  # True when a library for these sources already existed
    log: str  # nvcc's output (ptxas register/spill report)


_LIB: ctypes.CDLL | None = None
_INFO: BuildInfo | None = None


def _sources() -> list[Path]:
    return sorted(p for p in _SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    # torch's own lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, the
    # default toolkit location
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def build() -> BuildInfo:
    """Compile the sources unless a library for them exists; return where."""
    global _INFO
    if _INFO is not None:
        return _INFO
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = _BUILD_DIR / f"libpycllp_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        _INFO = BuildInfo(out, 0.0, True, "")
        return _INFO
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # compile into a private directory, then rename the library into
    # place: a concurrent build never sees (or loads) a half-written one
    work = Path(tempfile.mkdtemp(dir=_BUILD_DIR))
    try:
        # one nvcc per source, all started together, then one link
        objs, procs = [], []
        for src in (p for p in srcs if p.suffix == ".cu"):
            obj = work / f"{src.stem}.o"
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        lib = work / "lib.so"
        proc = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *objs],
            capture_output=True, text=True, check=False,
        )
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n{log}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _INFO = BuildInfo(out, time.perf_counter() - t0, False, log)
    return _INFO


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
