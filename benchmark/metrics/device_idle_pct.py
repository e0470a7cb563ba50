"""The share of the traced steps' wall time in which no kernel, copy or set
ran on the card (the union of their intervals)."""

from harness.trace import busy_and_gaps


def read(record):
    if not record["device"] or record["wall_s"] <= 0:
        return None
    busy, _ = busy_and_gaps(record["device"])
    return 100.0 * (1.0 - busy / record["wall_s"])
