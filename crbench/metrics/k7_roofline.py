"""K7 (RMSNorm) in the training steps as a share of its roofline, in %."""
from crbench import yardstick as Y


def read(rec):
    per = Y.k7_step(rec.cfg, rec.batch, rec.seq)
    return Y.roofline_share(rec, ("K7",), rec.steps * len(per),
                            rec.steps * sum(per), "k7_roofline")
