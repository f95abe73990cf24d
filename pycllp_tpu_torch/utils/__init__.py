"""Utilities: scaling and device selection here; the checkpointed
scenario sweep (:mod:`pycllp_tpu_torch.utils.sweep`) and per-iteration
metrics (:mod:`pycllp_tpu_torch.utils.logging`) in their modules."""

from pycllp_tpu_torch.utils.device import resolve_device
from pycllp_tpu_torch.utils.scaling import (
    RuizScaling,
    ruiz_equilibrate,
    scale_problem,
    unscale_solution,
)

__all__ = [
    "RuizScaling",
    "resolve_device",
    "ruiz_equilibrate",
    "scale_problem",
    "unscale_solution",
]
