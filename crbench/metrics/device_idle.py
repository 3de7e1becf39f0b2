"""The traced window's share, in %, in which no operation ran on the
card."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
