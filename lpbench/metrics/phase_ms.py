"""phase_ms (ms): per entry call in the traced stretch, the device wall
(``lpbench/spans.py``) of the program's ``ipm phase`` ranges, each the
whole of one IPM loop (``hsd._run_phase``: static loads, blocks, predicate
reads, the copy of its state out), to the end of the device work it
launched."""

from lpbench.spans import wall_ms


def read(run):
    return wall_ms(run, "ipm phase")
