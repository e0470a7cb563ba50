"""The attention cores with relative position biases against their
roofline: a step's least time of every block's core, forward and backward
once (``roofline/relpos_attention.py`` at the cell's geometry from the
reference, on the configuration's peak), times the profiled steps, over
the device time of the operations launched inside the program's
``attn.relpos`` spans (recomputation included). ``None`` where the program
opens no such span."""

from harness import manifest
from roofline.relpos_attention import step_bound_s

HOST_OPS = ("attn.relpos",)


def read(record):
    spent = sum(c["device_s"] for c in record["ops"] if c["name"] in HOST_OPS)
    if spent <= 0:
        return None
    spec, traffic = record["spec"], record["traffic"]
    ref = manifest.reference(spec["reference"])
    clips = traffic["videos_per_step"] * traffic["clips_per_video"]
    bound = step_bound_s(ref.attention_shapes(spec["reference_spec"], clips), spec["peak"])
    return 100.0 * bound * record["steps"] / spent
