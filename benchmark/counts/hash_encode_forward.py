"""K3, `hash_encode_forward`: the hash grid's gather.

Bytes: each distinct table row the coordinates touch, read once (F
values of the table's type), the coordinates, and the features written
once in the compute type. Operations: each (sample, level) lane's cell and
hash, and 8 corners of F products and sums; far below the bytes' time.
"""
from benchmark.peaks import FP32_FLOPS, bound_s


def bound(batch: int, n_levels: int, n_features: int, distinct_rows: int,
          table_bytes: int = 4, out_bytes: int = 2):
    """→ (seconds, what bounds it)."""
    n_bytes = (distinct_rows * n_features * table_bytes + batch * 3 * 4
               + batch * n_levels * n_features * out_bytes)
    lanes = batch * n_levels
    ops = lanes * (12 + 8 * (5 + 3 * n_features))
    return bound_s(n_bytes, ops, FP32_FLOPS)
