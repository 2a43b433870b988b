"""K4, `hash_encode_backward` with its zeroing of the gradient table: the
scatter of each corner's weight times the cotangent row.

Bytes: the coordinates and the cotangent read once (compute type), the
whole float32 gradient table written once, and the distinct rows the
coordinates touch (their sums read and written by the reductions, counted
once). Operations: 8 corners of F products and sums a lane.
"""
from benchmark.peaks import FP32_FLOPS, bound_s


def bound(batch: int, n_levels: int, n_features: int, n_entries: int,
          distinct_rows: int, g_bytes: int = 2):
    """→ (seconds, what bounds it)."""
    n_bytes = (batch * 3 * 4 + batch * n_levels * n_features * g_bytes
               + n_entries * n_features * 4
               + distinct_rows * n_features * 4)
    ops = batch * n_levels * 8 * (5 + 2 * n_features)
    return bound_s(n_bytes, ops, FP32_FLOPS)
