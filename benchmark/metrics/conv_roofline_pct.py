"""cuDNN's convolutions against their roofline: the sum of each profiled
call's least time (``roofline/conv.py``) over the device time of the
operations those calls launched. Calls whose record lacks the arguments
the count needs are left out of both sums."""

from roofline.conv import call_bound_s

HOST_OPS = ("aten::convolution", "aten::convolution_backward")


def read(record):
    bound = spent = 0.0
    for call in record["ops"]:
        if call["name"] not in HOST_OPS:
            continue
        b = call_bound_s(call)
        if b is None or call["device_s"] <= 0:
            continue
        bound += b
        spent += call["device_s"]
    return 100.0 * bound / spent if spent > 0 else None
