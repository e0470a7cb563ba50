"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
without sparsity, at the full 700 W power limit). Every roofline share and
``mfu`` of the benchmark is held against these numbers."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "bf16": 989e12,   # tensor cores, bf16 and fp16
    "fp8": 1979e12,   # tensor cores
    "tf32": 495e12,   # tensor cores
    "f32": 67e12,     # CUDA cores, outside the tensor cores
}


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least time the card could take for ``nbytes`` moved and ``ops``
    done at the peak of ``kind``: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[kind])
