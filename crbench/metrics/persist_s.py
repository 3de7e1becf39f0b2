"""A round's time from its save call until it has landed (its report's
``seconds``), a round of the window."""
import statistics


def read(rec):
    steps = {s["step"] for s in rec.saves}
    v = [r["seconds"] for r in rec.rounds if r["step"] in steps]
    return statistics.fmean(v) if v else None
