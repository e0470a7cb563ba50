"""The share of the profiled steps' device time spent in the operations
launched inside the program's ``attn.relpos`` spans (the attention cores
with relative position biases: forward, recomputation and backward), the
spans' device seconds from the traced host operators' stretch over the
device-only stretch's total, both of the same number of steps. ``None``
where the program opens no such span."""

HOST_OPS = ("attn.relpos",)


def read(record):
    spans = [c["device_s"] for c in record["ops"] if c["name"] in HOST_OPS]
    total = sum(dur for _, _, dur in record["device"]) / 1e9
    if not spans or total <= 0:
        return None
    return 100.0 * sum(spans) / total
