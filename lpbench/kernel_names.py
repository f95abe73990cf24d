"""Which device kernels are the libraries' and which are the program's own.

A kernel whose name matches one of :data:`LIBRARY` is PyTorch's (ATen's
elementwise, reduction, indexing, sorting and copy kernels, and CUB's), or
cuBLAS's, cuBLASLt's, CUTLASS's or cuSOLVER's.  Every other kernel is the
program's own: a hand-written kernel added later counts as the program's
without an edit here.
"""

from __future__ import annotations

__all__ = ["LIBRARY", "is_library"]

LIBRARY = (
    "at::", "at_cuda_detail", "cub::", "c10::",  # PyTorch and CUB
    "cublas", "cutlass", "cusolver", "magma", "nvjet", "xmma", "gemm", "gemv",  # BLAS, CUTLASS
    "splitKreduce", "dot_kernel", "reduce_1Block", "scal_kernel", "axpy_kernel", "nrm2",
    "trsm", "trsv", "potrf", "getrf", "syrk", "herk",
)


def is_library(name: str) -> bool:
    low = name.lower()
    return any(p.lower() in low for p in LIBRARY)
