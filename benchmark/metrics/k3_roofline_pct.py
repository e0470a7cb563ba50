"""K3 against its roofline: its calls' least time (``roofline/k3.py``, at
the cell's clips, frames and crop) over the device time of the kernels of
``csrc/fused_aug.cu``. A call is one kernel launch a step; its output is
float32, as the configurations run it (TPU.AUG_COMPUTE_OUT off)."""

from roofline.k3 import call_bound_s

KERNEL = "fused_aug_kernel"


def read(record):
    times = [dur / 1e9 for name, _, dur in record["device"] if KERNEL in name]
    if not times:
        return None
    traffic, rspec = record["traffic"], record["spec"]["reference_spec"]
    n = traffic["videos_per_step"] * traffic["clips_per_video"]
    bound = call_bound_s(n, traffic["frames"], rspec["aug"]["crop"], 4)
    return 100.0 * bound * len(times) / sum(times)
