"""Numerical hot-path kernels: the plain reference set + hand-written CUDA kernels."""

from pycllp_tpu_torch.ops.reference import (
    REFERENCE_KERNELS,
    KernelSet,
    NormalFactor,
    PreparedA,
    ReferenceKernels,
)

__all__ = [
    "REFERENCE_KERNELS",
    "KernelSet",
    "NormalFactor",
    "PreparedA",
    "ReferenceKernels",
]
