"""Problem-definition layer (counterpart of :mod:`pycllp_tpu.models`)."""

from pycllp_tpu_torch.models.sparse import SparseMatrixBuilder
from pycllp_tpu_torch.models.lp import (
    BaseLP,
    EqualityLP,
    GeneralLP,
    StandardFormMap,
    StandardLP,
)

__all__ = [
    "BaseLP",
    "EqualityLP",
    "GeneralLP",
    "SparseMatrixBuilder",
    "StandardFormMap",
    "StandardLP",
]
