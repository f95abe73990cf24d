"""State carried across from the JAX reference package.

The two packages share no model weights; what crosses between them is:

* the options — :func:`options_from_reference` takes
  ``dataclasses.asdict(reference_options)``;
* the problem data — plain numpy ``A``, ``b``, ``c``;
* the interior state — :func:`state_from_numpy` fills an
  :class:`~pycllp_tpu_torch.solvers.hsd.HSDState` from the reference
  ``HSDState``'s fields pulled to numpy, and :func:`state_to_numpy` goes
  back.

Everything here takes dicts and numpy arrays, so this module (like the
rest of the package) imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pycllp_tpu_torch.solvers.hsd import HSDState
from pycllp_tpu_torch.solvers.options import SolverOptions
from pycllp_tpu_torch.utils.device import resolve_device

__all__ = ["options_from_reference", "state_from_numpy", "state_to_numpy"]


def options_from_reference(fields: dict) -> SolverOptions:
    """``SolverOptions`` from the reference options' ``asdict``; unknown
    fields raise, so a field added on one side cannot be dropped silently."""
    known = {f.name for f in dataclasses.fields(SolverOptions)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"reference options carry fields the port lacks: {sorted(unknown)}")
    return SolverOptions(**fields)


def state_from_numpy(fields: dict, device="cuda") -> HSDState:
    """An ``HSDState`` on ``device`` from ``{field: ndarray}`` (dtypes kept;
    the scalar loop counter ``k`` becomes a 0-d int32 tensor, as the
    reference carries it)."""
    dev = resolve_device(device)
    missing = set(HSDState._fields) - set(fields)
    if missing:
        raise ValueError(f"state is missing fields {sorted(missing)}")
    return HSDState(**{
        f: torch.from_numpy(np.array(fields[f], dtype=np.int32 if f == "k" else None)).to(dev)
        for f in HSDState._fields
    })


def state_to_numpy(state: HSDState) -> dict:
    """``{field: ndarray}`` from an ``HSDState`` (``k`` as an int32 scalar)."""
    return {
        f: np.int32(int(v)) if f == "k" else v.detach().cpu().numpy()
        for f, v in state._asdict().items()
    }
