"""sweep_io_ms (ms): per sweep window in the traced stretch, the host time
inside the program's ``sweep pull`` (a window's outputs copied to numpy,
which waits for the device to finish them) and ``sweep write`` (one chunk
file written) ranges of ``scenario_sweep``."""

from lpbench.spans import host_ms


def read(run):
    return host_ms(run, ("sweep pull", "sweep write"))
