"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; a run prints the card's limit)."""

BYTES_PER_S = 3.35e12  # HBM3
BF16_FLOPS = 989e12  # tensor cores, dense
FP32_FLOPS = 67e12  # outside the tensor cores


def bound_s(n_bytes: float, n_ops: float, peak_ops: float):
    """The least time the chip could take → (seconds, "bytes" or
    "operations")."""
    t_bytes, t_ops = n_bytes / BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
