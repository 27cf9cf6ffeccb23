"""Published peaks of one NVIDIA H100 (SXM, NVIDIA's data sheet, dense
rates without sparsity, at its 700 W power limit)."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, ops: float, peak_ops: float):
    """(least time in seconds, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
