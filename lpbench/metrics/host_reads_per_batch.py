"""host_reads_per_batch (reads): the program's predicate reads by the host
(``_loop.HOST_SYNCS``: one a block of the device loop) and its stages' own
reads (``_loop.STAGE_READS``), counted over the window, per entry call
(a sweep makes one a window of chunks)."""


def read(run):
    batches = sum(c.batches for c in run.calls)
    reads = sum(c.counters["host_syncs"] + c.counters["stage_reads"] for c in run.calls)
    return reads / batches if batches else None
