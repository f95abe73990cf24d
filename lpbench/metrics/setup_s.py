"""setup_s (s): from the start of the process to the first call of the
window, by the host clock: imports, the kernel build (or its cache), the
inputs made from the seed and staged on the card, and one call of every
batch, which captures the program's graphs."""


def read(run):
    return run.setup_s
