"""Multi-process bring-up and global meshes.

Counterpart of :mod:`pycllp_tpu.parallel.distributed`.  The reference
wires hosts together with ``jax.distributed`` and then addresses every
chip from one process per host; the port runs one process per device on
a ``torch.distributed`` process group.  :func:`initialize` starts that
group from explicit arguments or from torchrun's environment
(``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), which take
the place of ``JAX_COORDINATOR_ADDRESS`` and the TPU worker variables.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from pycllp_tpu_torch.parallel.collectives import make_mesh

__all__ = ["initialize", "is_distributed", "global_scenario_mesh", "host_local_batch"]

# A rank that leaves a loop out of step with the others waits in its next
# collective; the group's timeout turns that wait into an error.
DEFAULT_TIMEOUT_S = 300.0


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str = "nccl",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Start the default process group when explicit arguments or
    torchrun's environment ask for one; return True when distributed.

    ``init_method`` (``"tcp://host:port"``, ``"file:///path"``) with
    ``world_size`` and ``rank`` starts the group explicitly; otherwise
    ``MASTER_ADDR`` and ``WORLD_SIZE`` in the environment start it from
    ``env://``.  With neither, nothing starts and False comes back: the
    package keeps working on one device.  ``backend`` is used as given
    (``"nccl"`` by default; ``"gloo"`` only when asked).  On NCCL the
    rank's card is ``LOCAL_RANK`` (else ``rank``), set before the group
    starts.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None:
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE")):
            return False
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if world_size is None or rank is None:
        raise ValueError("an explicit init_method needs world_size and rank")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_scenario_mesh(axis: str = "scenario"):
    """1-D mesh over every rank of the job (a size-1 mesh with no group)."""
    return make_mesh(None, axis)


def host_local_batch(total: int) -> tuple[int, int]:
    """Split a global scenario count across ranks: returns (this rank's
    start, count).  Contiguous per rank, so rank-local data loading needs
    no shuffle."""
    if dist.is_initialized():
        p, pc = dist.get_rank(), dist.get_world_size()
    else:
        p, pc = 0, 1
    per = -(-total // pc)
    lo = min(p * per, total)
    hi = min(lo + per, total)
    return lo, hi - lo
