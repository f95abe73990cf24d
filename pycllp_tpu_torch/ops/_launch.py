"""What every kernel wrapper of :mod:`pycllp_tpu_torch.ops` shares, below
all of them: the launch checks, the card's limits, and the counts.

``LAUNCHES`` counts each hand-written kernel's launches, one a launch,
nowhere else, keyed by kernel: ``chol_bl``, ``solve_bl``, ``df_chol_bl``,
``df_solve_bl``, ``fused_factor_bl`` and ``facsol_bl`` (either design, and
the same key with ``_smem`` for the lane-group design), ``slice_rounds_bl``,
``ozaki_product_bl`` (whatever called it), ``ozaki_products`` (an Ozaki
product with lanes sent to the card) and ``ozaki_sym`` (of them, a
formation on M's triangle), ``lane_mv``, ``lane_rmv`` and ``lane_normal``.

Python adds to a count at the call that issues the launch, so a captured
CUDA graph adds nothing when it replays.  The graph layer
(:mod:`pycllp_tpu_torch.solvers._loop`) therefore takes a capture's
increments back from every Counter of ``REPLAYED`` and adds them again at
each replay.  ``LAUNCHES`` is there; a module with a count of its own that
a replay must repeat registers it at import with :func:`replayed`
(``batchlast.STREAM_LAUNCHES``, ``hsd.PREPARED_BYTES``).
"""

from __future__ import annotations

import collections

import torch

# shared memory a block may use on the H100 (sm_90), in bytes
_SMEM_LIMIT = 232448
# the H100 SXM's SM count, for plans made without a card (the CPU tests)
H100_SMS = 132

LAUNCHES: collections.Counter = collections.Counter()
# the Counters whose increments a graph replay repeats
REPLAYED: list = [LAUNCHES]


def replayed(counter: collections.Counter) -> collections.Counter:
    """``counter``, registered in ``REPLAYED``."""
    REPLAYED.append(counter)
    return counter


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_cuda(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32) -> None:
    _require(t.is_cuda, f"{name} must be a CUDA tensor, got device {t.device}")
    _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _require(tuple(t.shape) == shape, f"{name} must have shape {shape}, got {tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _raise_on_error(fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError_t {err}")


_SM_COUNT: dict = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]
