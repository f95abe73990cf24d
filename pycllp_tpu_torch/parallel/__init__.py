"""Multi-device layer: scenario sharding and the column-sharded big LP.

Counterpart of :mod:`pycllp_tpu.parallel`, on a ``torch.distributed``
process group with one rank per device (see
:mod:`pycllp_tpu_torch.parallel.collectives` for the mapping of the
reference's collectives).
"""

from pycllp_tpu_torch.parallel.shard import (
    CollectiveAny,
    scenario_mesh,
    sharded_hsd_solve,
    sharded_hsd_solve_scan,
)
from pycllp_tpu_torch.parallel.schur import column_sharded_hsd_solve, model_mesh
from pycllp_tpu_torch.parallel.distributed import (
    global_scenario_mesh,
    host_local_batch,
    initialize,
    is_distributed,
)

__all__ = [
    "CollectiveAny",
    "column_sharded_hsd_solve",
    "global_scenario_mesh",
    "host_local_batch",
    "initialize",
    "is_distributed",
    "model_mesh",
    "scenario_mesh",
    "sharded_hsd_solve",
    "sharded_hsd_solve_scan",
]
