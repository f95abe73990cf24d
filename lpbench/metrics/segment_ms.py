"""segment_ms (ms): per entry call in the traced stretch, the device wall
(``lpbench/spans.py``) of the program's ``segment`` ranges, each the whole
of one straight-line segment (``_loop._segment``: key, lookup, loads,
replay, copy out), to the end of the device work it launched."""

from lpbench.spans import wall_ms


def read(run):
    return wall_ms(run, "segment")
