"""Native C++ HSD backend via ctypes.

Counterpart of :mod:`pycllp_tpu.solvers.cpp`.  The port keeps its own
copy of the reference's C++ source, ``pycllp_tpu_torch/native/hsd_native.cpp``
(plain C++, OpenMP over instances; byte-identical to the reference's, which
a test pins), and compiles it with g++ on first use into the git-ignored
``build/native/`` beside the packages, named by a hash of the source and
the flags.  Nothing is written next to the source.  The library is
compiled under a temporary name and renamed into place, so processes that
build at the same time never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from pycllp_tpu_torch.solvers.base import BaseSolver, register_solver
from pycllp_tpu_torch.solvers.options import Solution

__all__ = ["CppHSDSolver", "load_native", "native_path"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "hsd_native.cpp"
_BUILD_DIR = _PKG.parent / "build" / "native"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")
_lock = threading.Lock()
_lib = None


def native_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libpycllp_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_native():
    """Build (if missing) and load the native library; returns the ctypes lib."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = native_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.hsd_solve_batch.restype = ctypes.c_int
        lib.hsd_solve_batch.argtypes = [
            dp, dp, dp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            dp, dp, dp, ip, ip,
        ]
        lib.hsd_native_num_threads.restype = ctypes.c_int
        lib.hsd_native_num_threads.argtypes = []
        _lib = lib
        return _lib


@register_solver
class CppHSDSolver(BaseSolver):
    """Batched HSD on the native C++ backend (f64, OpenMP over instances).

    ``device=`` is accepted so that one ``get_solver(name, device=...)``
    call fits every registry name; this backend always runs on the host.
    """

    name = "cpp_hsd"
    aliases = ("cyhsd", "cpp")

    def __init__(self, options=None, *, device=None, **opt_kwargs):
        super().__init__(options, **opt_kwargs)

    @classmethod
    def is_available(cls) -> bool:
        try:
            load_native()
            return True
        except (OSError, subprocess.CalledProcessError):
            return False

    def _solve_impl(self, A, b, c) -> Solution:
        lib = load_native()
        if A.ndim == 3:
            raise ValueError("cpp_hsd requires shared (2-D) A")
        m, n = A.shape
        B = b.shape[0]
        A = np.ascontiguousarray(A, np.float64)
        b = np.ascontiguousarray(b, np.float64)
        c = np.ascontiguousarray(c, np.float64)
        x = np.zeros((B, n))
        y = np.zeros((B, m))
        obj = np.zeros(B)
        status = np.zeros(B, np.int32)
        iters = np.zeros(B, np.int32)
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)
        o = self.options
        ret = lib.hsd_solve_batch(
            A.ctypes.data_as(dp),
            b.ctypes.data_as(dp),
            c.ctypes.data_as(dp),
            m, n, B,
            o.tol, o.maxiter, o.alpha0, o.resolved_reg_eps(np.float64),
            x.ctypes.data_as(dp),
            y.ctypes.data_as(dp),
            obj.ctypes.data_as(dp),
            status.ctypes.data_as(ip),
            iters.ctypes.data_as(ip),
        )
        if ret != 0:  # pragma: no cover
            raise RuntimeError(f"native solver returned {ret}")
        z = c - y @ A  # reduced costs at the recovered point
        return Solution(x=x, y=y, z=z, objective=obj, status=status, iterations=iters)
