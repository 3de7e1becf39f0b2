"""K1–K3 (the save's device encode) as a share of their roofline, in %."""
from crbench import yardstick as Y


def read(rec):
    per = Y.encode_save(rec.leaves)
    n = len(rec.saves)
    return Y.roofline_share(rec, ("K1", "K2", "K3"),
                            n * sum(v[0] for v in per.values()),
                            n * sum(v[1] for v in per.values()),
                            "encode_roofline")
