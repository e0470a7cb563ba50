"""cuDNN's 3D convolutions: operations and bytes of one call from its
shapes, as the profiler records them on ``aten::convolution`` (x, w, bias,
stride, padding, dilation, transposed, output_padding, groups) and
``aten::convolution_backward`` (grad_output, x, w, bias_sizes, stride,
padding, dilation, transposed, output_padding, groups, output_mask).

Operations: 2 x N x C_out x (output positions) x (C_in / groups) x (kernel
volume) for the forward and again for each gradient the backward computes.
Bytes: each input read once and each output written once (the forward's x,
w and y; the backward's dy, x and w, and dx and dw where it computes them).
bf16 and fp16 are held against the tensor cores' bf16 peak, float32
against TF32's, which cuDNN uses for float32 by default.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from harness.peaks import bound_s

ELEMENT_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8}
PEAK = {"c10::BFloat16": "bf16", "c10::Half": "bf16", "float": "tf32"}


def out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def forward_counts(x, w, y, groups: int, elem: int) -> Tuple[float, float]:
    """(operations, bytes) of one forward: x [N, C, *S], w [C_out, C / g,
    *K], y [N, C_out, *S']."""
    ops = 2.0 * y[0] * w[0] * math.prod(y[2:]) * w[1] * math.prod(w[2:])
    return ops, float(elem * (math.prod(x) + math.prod(w) + math.prod(y)))


def call_counts(call: dict) -> Optional[Tuple[float, float, str]]:
    """(operations, bytes, peak kind) of one profiled call, or None where its
    record lacks what the count needs."""
    shapes, dtype, conc = call["shapes"], call["dtypes"][0], call["concrete"]
    if dtype not in ELEMENT_BYTES or len(conc) < 9:
        return None
    elem = ELEMENT_BYTES[dtype]
    if call["name"] == "aten::convolution":
        x, w = shapes[0], shapes[1]
        stride, pad, dil, transposed, groups = conc[3], conc[4], conc[5], conc[6], conc[8]
        if transposed or not all(isinstance(v, list) for v in (stride, pad, dil)):
            return None
        y = [x[0], w[0]] + [out_size(x[2 + i], w[2 + i], stride[i], pad[i], dil[i]) for i in range(len(x) - 2)]
        ops, nbytes = forward_counts(x, w, y, groups, elem)
        return ops, nbytes, PEAK[dtype]
    if len(conc) < 11 or not isinstance(conc[10], list) or conc[7]:
        return None
    gy, x, w = shapes[0], shapes[1], shapes[2]
    mask = conc[10]
    ops_one, _ = forward_counts(x, w, gy, conc[9], elem)
    ops = ops_one * (int(bool(mask[0])) + int(bool(mask[1])))
    nbytes = elem * (math.prod(gy) + math.prod(x) + math.prod(w) + (math.prod(x) if mask[0] else 0)
                     + (math.prod(w) if mask[1] else 0))
    return ops, float(nbytes), PEAK[dtype]


def call_bound_s(call: dict) -> Optional[float]:
    counts = call_counts(call)
    return None if counts is None else bound_s(counts[1], counts[0], counts[2])
