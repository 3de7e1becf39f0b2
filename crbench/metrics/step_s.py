"""A training step's mean time: the window's time outside save calls,
waits for rounds and restarts, over its steps."""


def read(rec):
    return rec.step_s() if rec.steps else None
