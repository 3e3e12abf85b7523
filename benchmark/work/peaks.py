"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit)."""

#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, operations/s (also bounds i32
#: compares and f32 adds)
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the f32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
