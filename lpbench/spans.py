"""The program's own ``record_function`` ranges in a traced stretch, as
the per-layer readers of ``lpbench/metrics/`` take them.

A range's *device wall* runs from its start to the later of its end and
the end of the last device operation whose correlation id is that of a
runtime call (``cudaLaunchKernel``, ``cudaGraphLaunch``,
``cudaMemcpyAsync``, ``cuLaunchKernel``, ...) that started inside the
range: work the range queued and the device had not yet run counts, with
no sync.  The ranges of one name are taken as the union of their walls,
so the tail of one that overlaps the next counts once.
"""

from __future__ import annotations

import bisect

from lpbench.trace import Event, union

__all__ = ["device_walls", "wall_ms", "host_ms"]

# CUDA's API calls (`cuda...`, `cu...`) start so; the program's ranges and
# PyTorch's operators (``aten::...``) do not, and an operator's correlation
# id is PyTorch's own, not the runtime's
RUNTIME_PREFIX = "cu"


def _ranges(tr, names) -> list:
    # a range still open when the profiler stopped has no end: left out
    return sorted((e for e in tr.host if e.name in names and e.end >= e.start),
                  key=lambda e: e.start)


def device_walls(tr, name: str) -> list:
    """(start, end) of each range ``name`` in the trace, ``end`` its
    device wall's end (us)."""
    last: dict = {}
    for op in tr.device_ops:
        last[op.corr] = max(last.get(op.corr, op.end), op.end)
    calls = sorted((e.start, last[e.corr]) for e in tr.host
                   if e.name.startswith(RUNTIME_PREFIX) and e.corr in last)
    starts = [s for s, _ in calls]
    out = []
    for r in _ranges(tr, (name,)):
        lo, hi = bisect.bisect_left(starts, r.start), bisect.bisect_right(starts, r.end)
        out.append((r.start, max([r.end] + [end for _, end in calls[lo:hi]])))
    return out


def _per_batch_ms(tr, intervals: list):
    if not intervals:
        return None
    return union(Event("", a, b) for a, b in intervals) / 1e3 / tr.batches


def wall_ms(run, name: str):
    """The union of the device walls of the ranges ``name``, in ms per
    entry call of the traced stretch; None without a trace or such a
    range."""
    tr = run.trace
    if tr is None or not tr.batches:
        return None
    return _per_batch_ms(tr, device_walls(tr, name))


def host_ms(run, names: tuple):
    """The union of the host intervals of the ranges ``names``, in ms per
    entry call of the traced stretch; None without a trace or such a
    range."""
    tr = run.trace
    if tr is None or not tr.batches:
        return None
    return _per_batch_ms(tr, [(e.start, e.end) for e in _ranges(tr, names)])
