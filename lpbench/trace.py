"""The device trace of a traced stretch, as plain lists, and the arithmetic
the per-layer readers share.

:func:`from_profiler` turns a ``torch.profiler`` session into a
:class:`Trace`: the device's kernels and its copies and fills, each with
its correlation id, and the host's ranges (the runtime calls and the
``record_function`` marks of the program and of the harness), all in
microseconds on one clock.  The readers take nothing else, so a test
feeds them synthetic events.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

__all__ = ["Event", "Trace", "from_profiler", "union", "gaps", "GRAPH_LAUNCH",
           "HOST_MARKS", "HostIndex"]

# the runtime call that replays a CUDA graph
GRAPH_LAUNCH = "cudaGraphLaunch"
# what the host is doing during a device gap, by the ``record_function``
# range that encloses the gap's start, innermost first: the program's
# predicate reads and graph replays, the harness's pull of a call's answers
# and its call of the entry
HOST_MARKS = ("predicate read", "segment replay", "loop replay", "lpbench pull",
              "lpbench call")
# the name of each: inside a call but in no finer mark, the program is
# dispatching (its Python, eager launches, copies in)
ACTIVITY = {"predicate read": "predicate read", "segment replay": "segment replay",
            "loop replay": "loop replay", "lpbench pull": "pull", "lpbench call": "dispatch"}


@dataclass(frozen=True)
class Event:
    name: str
    start: float  # us
    end: float  # us
    corr: int = 0  # correlation id (device events and runtime calls)


@dataclass
class Trace:
    kernels: list = field(default_factory=list)  # device kernels
    copies: list = field(default_factory=list)  # device copies and fills
    host: list = field(default_factory=list)  # host ranges: runtime calls and marks
    window_s: float = 0.0  # the traced stretch's wall, by the host clock
    batches: int = 0  # entry calls (one hsd_solve_* call each) in the stretch
    # the stretch lies inside one call still running when it stops (a
    # sweep's first windows): its range is not in the trace
    in_call: bool = False

    @property
    def device_ops(self) -> list:
        return sorted(self.kernels + self.copies, key=lambda e: e.start)


def union(events) -> float:
    """The length (us) of the union of the events' intervals."""
    total, reach = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.start):
        start = max(e.start, reach)
        total += max(0.0, e.end - start)
        reach = max(reach, e.end)
    return total


def gaps(events) -> list:
    """The idle intervals (start, end) between the events' union, in order."""
    out, reach = [], None
    for e in sorted(events, key=lambda e: e.start):
        if reach is not None and e.start > reach:
            out.append((reach, e.start))
        reach = e.end if reach is None else max(reach, e.end)
    return out


class HostIndex:
    """What the host is doing at a time: the innermost of
    :data:`HOST_MARKS` whose range holds it, by the name in
    :data:`ACTIVITY`, else ``harness`` (between the harness's calls), or
    ``dispatch`` where the whole stretch is inside one call."""

    def __init__(self, host: list, in_call: bool = False):
        self._outside = "dispatch" if in_call else "harness"
        self._marks = []
        for mark in HOST_MARKS:
            ranges = sorted((e.start, e.end) for e in host if e.name == mark)
            self._marks.append((ACTIVITY[mark], [a for a, _ in ranges], [b for _, b in ranges]))

    def activity(self, t: float) -> str:
        for name, starts, ends in self._marks:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t:
                return name
        return self._outside


def _raw(prof) -> list:
    """(name, device?, start_us, end_us, corr, annotation?) of every event."""
    try:
        events = prof.profiler.kineto_results.events()
        t0 = min(e.start_ns() for e in events) if events else 0
        return [(e.name(), e.device_type().name != "CPU", (e.start_ns() - t0) / 1e3,
                 (e.end_ns() - t0) / 1e3, e.correlation_id(),
                 bool(getattr(e, "is_user_annotation", lambda: False)()))
                for e in events]
    except AttributeError:
        return [(e.name, e.device_type.name != "CPU", e.time_range.start, e.time_range.end,
                 e.id, bool(getattr(e, "is_user_annotation", False)))
                for e in prof.events()]


def from_profiler(prof, window_s: float, batches: int, in_call: bool = False) -> Trace:
    raw = _raw(prof)
    host_names = {name for name, dev, *_ in raw if not dev}
    tr = Trace(window_s=window_s, batches=batches, in_call=in_call)
    for name, dev, start, end, corr, annotation in raw:
        ev = Event(name, start, end, corr)
        if not dev:
            tr.host.append(ev)
        elif name.startswith(("Memcpy", "Memset")):
            tr.copies.append(ev)
        elif not annotation and name not in host_names:
            # the host's marks are mirrored on the device timeline: not kernels
            tr.kernels.append(ev)
    tr.kernels.sort(key=lambda e: e.start)
    tr.copies.sort(key=lambda e: e.start)
    tr.host.sort(key=lambda e: e.start)
    return tr
