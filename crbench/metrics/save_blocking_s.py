"""The time a save blocks training (its report's ``blocking_s``), a
save."""
import statistics


def read(rec):
    v = [s["blocking_s"] for s in rec.saves if "blocking_s" in s]
    return statistics.fmean(v) if v else None
