"""K8 (flash attention) in the training steps as a share of its roofline,
in %: each launch bounded by the larger of its bytes and its operations."""
from crbench import yardstick as Y


def read(rec):
    per = Y.k8_step(rec.cfg, rec.batch, rec.seq)
    return Y.roofline_share(rec, ("K8",), rec.steps * len(per),
                            rec.steps * sum(per), "k8_roofline")
