"""The attention core with decomposed relative position biases (MViTv2):
operations and bytes of one core, forward and backward, from its geometry,
whatever computes it (the dense chain of ``models/layers/attention.py``
or a fused kernel).

Operations (two a multiply-add): the scores ``q k^T``, the three bias
products (each query's row of ``q`` with the temporal, height and width
tables at its offsets to the keys' coordinates, the cls token's row left
out), ``P v``; the backward twice each (the gradients of both operands).
Bytes, in bf16: the forward reads q, k, v and the gathered tables and
writes the output; the backward reads q, k, v, the tables, the output and
its gradient and writes the gradients of q, k, v and the tables; each
once. The scores, the probabilities and the softmax's statistics stay on
chip. A step counts each block's core forward and backward once (a
recomputation counts only in the device time)."""

from __future__ import annotations

import math
from typing import Iterable, Tuple

from harness.peaks import bound_s

ELEM = 2  # bf16


def counts(b: int, heads: int, d: int, q_thw, k_thw, cls: bool) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """((forward ops, bytes), (backward ops, bytes)) of one core."""
    sp = 1 if cls else 0
    nq, nk = math.prod(q_thw) + sp, math.prod(k_thw) + sp
    rows = b * heads
    products = 2.0 * rows * nq * nk * d * 2  # q k^T and P v
    bias = 2.0 * rows * (nq - sp) * sum(k_thw) * d
    tables = sum(q * k for q, k in zip(q_thw, k_thw)) * d
    fwd_bytes = ELEM * (rows * (2 * nq * d + 2 * nk * d) + tables)
    bwd_bytes = ELEM * (rows * (4 * nq * d + 4 * nk * d) + 2 * tables)
    return (products + bias, fwd_bytes), (2.0 * (products + bias), bwd_bytes)


def step_bound_s(cores: Iterable[dict], kind: str = "bf16") -> float:
    """The least time of a step's cores (``reference/mvitv2_maskfeat.py
    attention_shapes``), each forward and backward at its own bound."""
    total = 0.0
    for c in cores:
        for ops, nbytes in counts(c["b"], c["heads"], c["d"], c["q_thw"], c["k_thw"], c["cls"]):
            total += bound_s(nbytes, ops, kind)
    return total
