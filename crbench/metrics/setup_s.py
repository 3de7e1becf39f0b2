"""Process start to the first timed step: imports, kernel libraries,
weights on the card, the first steps and the cell's warm-up."""


def read(rec):
    return rec.setup_s
