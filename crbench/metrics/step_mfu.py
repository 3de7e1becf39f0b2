"""The whole step's share of the card's bf16 peak, in %: the benchmark's
model FLOPs of a step (``yardstick.step_flops``) over ``step_s``."""
from crbench import yardstick as Y


def read(rec):
    if not rec.steps:
        return None
    return 100.0 * Y.step_flops(rec.cfg, rec.batch, rec.seq) \
        / rec.step_s() / Y.PEAK_FLOPS
