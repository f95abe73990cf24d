"""launch_gap_ms (ms): per entry call in the traced stretch, the device's
idle time between each ``cudaGraphLaunch`` and the first operation of that
replay (matched by correlation id): from the later of the call and the
end of the device's earlier work to that operation's start."""

from lpbench.trace import GRAPH_LAUNCH


def read(run):
    tr = run.trace
    if tr is None or not tr.batches:
        return None
    launches = {e.corr: e.start for e in tr.host if e.name == GRAPH_LAUNCH}
    if not launches:
        return None
    idle, reach, seen = 0.0, float("-inf"), set()
    for e in tr.device_ops:
        if e.corr in launches and e.corr not in seen:
            seen.add(e.corr)
            idle += max(0.0, e.start - max(launches[e.corr], reach))
        reach = max(reach, e.end)
    return idle / 1e3 / tr.batches
