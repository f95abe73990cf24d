"""peak_mem_gib (GiB): ``torch.cuda.max_memory_reserved()`` when the
window closes: the most the caching allocator held on the card over the
set-up (inputs, kernel build, warm-up with the graph captures) and the
window."""


def read(run):
    return run.peak_reserved / 2**30 if run.peak_reserved > 0 else None
