"""Training goodput: the tokens (frames) of every step completed in the
window over the window's whole wall time, checkpoint stalls, the wait for
the last round and restarts included."""


def read(rec):
    return rec.tokens / rec.window_s
