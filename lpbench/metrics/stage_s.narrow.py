"""stage_s.narrow (s): the narrow stage's seconds of a scan, as the program
prints them with ``stage_sync=True`` (one device sync after each stage),
averaged over the traced run's stage-split calls.  Nothing to read where
the entry has no such stages."""

NEEDS = ("stage_sync",)


def read(run):
    secs = run.stage_s.get("narrow")
    return sum(secs) / len(secs) if secs else None
