"""stream_ms (ms): device time per entry call, in the traced stretch, of the
program's streaming-design factor and solve kernels, float and double: the
``chol_bl_kernel`` and ``solve_bl_kernel`` instantiations of
``pycllp_tpu_torch/csrc/batchlast.cuh``, picked by name.  No lane-group
(``*_smem_*``) kernel matches.  Nothing to read where the stretch ran none
(every m up to 340 in float and 240 in double takes the lane-group kernels)."""

import re

# the two templates' names as the profiler shows an instantiation, e.g.
# "void (anonymous namespace)::chol_bl_kernel<float>(float const*, ...)"
STREAM = re.compile(r"(?<![A-Za-z0-9_])(chol|solve)_bl_kernel<(float|double)\b")


def stream_kind(name: str):
    """(kind, dtype) of a streaming factor or solve kernel, "chol" or
    "solve" and "float" or "double"; None for any other kernel."""
    if "_smem_" in name:
        return None
    hit = STREAM.search(name)
    return (hit.group(1), hit.group(2)) if hit else None


def read(run):
    tr = run.trace
    if tr is None or not tr.batches:
        return None
    us = [e.end - e.start for e in tr.kernels if stream_kind(e.name)]
    return sum(us) / 1e3 / tr.batches if us else None
