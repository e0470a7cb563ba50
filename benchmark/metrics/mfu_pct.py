"""The whole step's model FLOPs (the cell's ``flops_per_step``: forward and
backward of the plain reference, nothing recomputed) times the window's
steps, over the window's seconds, over the card's dense peak for the
configuration's compute type (``harness/peaks.py``)."""

from harness.peaks import OPS_PER_S


def read(record):
    win = record["window"]
    if win["seconds"] <= 0:
        return None
    rate = record["traffic"]["flops_per_step"] * win["steps"] / win["seconds"]
    return 100.0 * rate / OPS_PER_S[record["spec"]["peak"]]
