"""K3, the fused 'simple' augmentation (``ops/fused_aug.py``,
``csrc/fused_aug.cu``): operations and bytes of one call, by the rule of
the port's kernel table. For n clips of t frames cropped to s x s: the
crop windows' uint8 bytes read once, 7 four-byte parameters a clip, the
output written once; 25 float operations an output element for the colour
chain (counted as if every clip ran it) and 2 for the normalisation, on the
CUDA cores' float32 peak. The bytes bound it at any share of clips that
run the chain."""

from __future__ import annotations

from typing import Tuple

from harness.peaks import bound_s

OPS_PER_ELEMENT = 25 + 2


def counts(n: int, t: int, s: int, out_bytes: int) -> Tuple[float, float]:
    elements = n * t * s * s * 3
    return float(OPS_PER_ELEMENT * elements), float(elements + 7 * 4 * n + elements * out_bytes)


def call_bound_s(n: int, t: int, s: int, out_bytes: int) -> float:
    ops, nbytes = counts(n, t, s, out_bytes)
    return bound_s(nbytes, ops, "f32")
