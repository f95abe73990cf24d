"""The benchmark's one door into the program under test, the PyTorch and
CUDA package ``pycllp_tpu_torch``: its entries and kernel sets by the
dotted names the configuration files give, its options class, its status
code for an optimal lane, and its counters.  Nothing else of the harness
imports the program, and the reference imports none of it.
"""

from __future__ import annotations

import importlib

__all__ = ["resolve", "options", "optimal", "counters", "COUNTERS"]

# the program's counters the harness reads, by the module that holds each:
# the device loop's predicate reads, the stages' reads, the gated-off
# iterations, the graph captures, and the IPM iterations that ran
COUNTERS = {
    "host_syncs": ("pycllp_tpu_torch.solvers._loop", "HOST_SYNCS"),
    "stage_reads": ("pycllp_tpu_torch.solvers._loop", "STAGE_READS"),
    "gated_off": ("pycllp_tpu_torch.solvers._loop", "GATED_OFF_STEPS"),
    "captures": ("pycllp_tpu_torch.solvers._loop", "GRAPH_CAPTURES"),
    "steps": ("pycllp_tpu_torch.solvers.hsd", "HOST_STEPS"),
}


def resolve(dotted: str):
    """The object at ``package.module.attribute``."""
    module, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def options(kwargs: dict):
    return resolve("pycllp_tpu_torch.SolverOptions")(**kwargs)


def optimal() -> int:
    return int(resolve("pycllp_tpu_torch.Status").OPTIMAL)


def counters() -> dict:
    return {k: int(getattr(importlib.import_module(mod), name))
            for k, (mod, name) in COUNTERS.items()}
