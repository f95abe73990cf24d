"""capture_s (s): the program's ``_loop.CAPTURE_SECONDS`` when read, after
the traced run: the host seconds of every CUDA graph the process captured,
each from the start of its eager warm-up to the end of its capture, less
the kernel library's compile where a warm-up ran it.  The window captures
none (``captures_in_window``), so they are set-up's.
Nothing to read where the program has no such counter."""

from lpbench import program


def read(run):
    try:
        return float(program.resolve("pycllp_tpu_torch.solvers._loop.CAPTURE_SECONDS"))
    except AttributeError:
        return None
