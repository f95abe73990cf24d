"""pycllp_tpu_torch — the PyTorch/CUDA port of :mod:`pycllp_tpu`.

Batched interior-point LP solving where thousands of independent LP
instances (scenarios) are solved together on one NVIDIA GPU.  The JAX
package ``pycllp_tpu`` is the reference; this package mirrors its layout
and names module for module (``models/``, ``io/``, ``ops/``, ``solvers/``,
``utils/``, ``parallel/``), imports ``torch`` and numpy, and never JAX.

Ported so far: the batched HSD solve of the default bench configuration —
the narrow f32 phase (Ruiz scaling, the Mehrotra start, the KKT-refined
predictor-corrector, the chunked cap/compact/warm-resume scan) on
hand-written CUDA Cholesky and solve kernels (``csrc/batchlast.cu``, with
the fused-form and fused factor-solve kernels behind
``BATCHLAST_FUSED_KERNELS`` / ``BatchLastKernels(fuse_facsol=True)``), and
the wide f64 finish (vertex crossover on the mixed engine, the drain
tiers, a wide IPM finish) on hand-written FP64 factor/solve kernels and
the Ozaki slicing kernel (``csrc/df64.cu``); the checkpointed scenario
sweep (``utils/sweep.py``) and per-iteration metrics
(``utils/logging.py``); the MPS reader/writer and the netlib fixtures
(``io/mps.py``, ``io/netlib.py``); the other single-device solvers —
``dense_path`` (on the same kernel sets), ``scipy`` (the oracle),
``cpp_hsd`` (the reference's native C++ solver through ctypes) and the
two-pass ladder (``solvers/twopass.py``); ``utils/profiling.py``,
``utils/debug.py`` and the CLI (``python -m pycllp_tpu_torch``); and the
multi-device layer (``parallel/``: scenario sharding with collective or
local termination, the column-sharded big LP with its row-sharded
Cholesky) on a ``torch.distributed`` process group, with the registry's
``schur`` solver.

The device is explicit: solvers take ``device=`` (default ``"cuda"``),
and a CUDA request without a card raises.  Pass ``device="cpu"`` to run
on the host, where the kernels' plain PyTorch versions run.
"""

__version__ = "0.1.0"

from pycllp_tpu_torch.models import GeneralLP, StandardLP, EqualityLP, SparseMatrixBuilder
from pycllp_tpu_torch.solvers import (
    BaseSolver,
    Solution,
    SolverOptions,
    Status,
    available_solvers,
    get_solver,
    register_solver,
    solver_registry,
)

__all__ = [
    "GeneralLP",
    "StandardLP",
    "EqualityLP",
    "SparseMatrixBuilder",
    "BaseSolver",
    "Solution",
    "SolverOptions",
    "Status",
    "available_solvers",
    "get_solver",
    "register_solver",
    "solver_registry",
    "__version__",
]
