"""gated_off_share (%): the device loop's gated-off iterations
(``_loop.GATED_OFF_STEPS``) over all the iterations its blocks stepped,
the gated-off ones and those that ran (``hsd.HOST_STEPS``), over the
window."""


def read(run):
    off = sum(c.counters["gated_off"] for c in run.calls)
    ran = sum(c.counters["steps"] for c in run.calls)
    return 100.0 * off / (off + ran) if off + ran else None
