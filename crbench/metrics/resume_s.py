"""A restart's time back to work: from ``init_or_restore`` to the end of
the first resumed step, a restart."""
import statistics


def read(rec):
    v = [r["resume_s"] for r in rec.restores]
    return statistics.fmean(v) if v else None
