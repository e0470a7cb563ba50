"""The benchmark's own counts of work: each cell's FLOPs a step recounted,
and the convolution and K3 counts against counts by hand."""

import pytest

from harness import manifest
from roofline import conv, k3

ROOT = manifest.ROOT
M = manifest.load_manifest(ROOT)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_flops_per_step_is_the_references_count(cell):
    ctx = manifest.resolve(M, cell, ROOT)
    ref = manifest.reference(ctx.spec["reference"])
    assert ref.flops_per_step(ctx.spec["reference_spec"], ctx.traffic) == ctx.traffic["flops_per_step"]


def _fwd(x, w, stride, pad, dtype="c10::BFloat16", groups=1):
    return {"name": "aten::convolution", "shapes": [x, w, [], [], [], [], [], [], []],
            "dtypes": [dtype, dtype, "", "ScalarList", "ScalarList", "ScalarList", "Scalar", "ScalarList", "Scalar"],
            "concrete": [None, None, None, stride, pad, [1, 1, 1], False, [0, 0, 0], groups], "device_s": 1.0}


def test_conv_forward_counts_by_hand():
    # 2 clips, 3 -> 64 channels, 1x7x7 stride (1, 2, 2) pad (0, 3, 3) on 8x32x32: out 8x16x16
    ops, nbytes, kind = conv.call_counts(_fwd([2, 3, 8, 32, 32], [64, 3, 1, 7, 7], [1, 2, 2], [0, 3, 3]))
    out = 2 * 64 * 8 * 16 * 16
    assert ops == 2 * out * 3 * 49
    assert nbytes == 2 * (2 * 3 * 8 * 32 * 32 + 64 * 3 * 49 + out)
    assert kind == "bf16"


def test_conv_backward_counts_by_hand():
    gy, x, w = [2, 64, 8, 16, 16], [2, 3, 8, 32, 32], [64, 3, 1, 7, 7]
    call = {"name": "aten::convolution_backward", "shapes": [gy, x, w] + [[]] * 8,
            "dtypes": ["float"] * 3 + [""] * 8,
            "concrete": [None, None, None, [64], [1, 2, 2], [0, 3, 3], [1, 1, 1], False, [0, 0, 0], 1,
                         [False, True, False]], "device_s": 1.0}
    ops, nbytes, kind = conv.call_counts(call)
    per = 2 * (2 * 64 * 8 * 16 * 16) * 3 * 49
    assert ops == per  # the weight's gradient only
    n = lambda s: s[0] * s[1] * s[2] * s[3] * s[4] if len(s) == 5 else 0  # noqa: E731
    assert nbytes == 4 * (n(gy) + n(x) + n(w) + n(w))
    assert kind == "tf32"


def test_conv_without_its_arguments_is_not_counted():
    call = _fwd([2, 3, 8, 32, 32], [64, 3, 1, 7, 7], [1, 2, 2], [0, 3, 3])
    call["concrete"] = []
    assert conv.call_bound_s(call) is None


def test_k3_counts_by_hand():
    ops, nbytes = k3.counts(32, 8, 224, 4)
    elements = 32 * 8 * 224 * 224 * 3
    assert ops == 27 * elements
    assert nbytes == elements + 28 * 32 + 4 * elements
    # the bytes bound K3 at every share of clips that run the chain
    assert nbytes / 3.35e12 > ops / 67e12
