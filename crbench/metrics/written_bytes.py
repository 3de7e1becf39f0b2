"""Bytes a round of the window writes (its report's ``written_bytes``)."""
import statistics


def read(rec):
    steps = {s["step"] for s in rec.saves}
    v = [r["written_bytes"] for r in rec.rounds if r["step"] in steps]
    return statistics.fmean(v) if v else None
