"""stage_ms.finish (ms): per entry call in the traced stretch, the device
wall (``lpbench/spans.py``) of the program's ``finish stage`` ranges: from
the start of ``hsd_solve_scan``'s finish stage to the later of its end and
the end of the device work it launched.  Read with no sync added.
Nothing to read where the entry has no such stage."""

from lpbench.spans import wall_ms


def read(run):
    return wall_ms(run, "finish stage")
