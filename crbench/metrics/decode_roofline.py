"""K4 (the restore's byte-plane decode) as a share of its roofline, in %."""
from crbench import yardstick as Y


def read(rec):
    launches, bound = Y.decode_restore(rec.leaves)
    n = len(rec.restores)
    return Y.roofline_share(rec, ("K4",), n * launches, n * bound,
                            "decode_roofline")
