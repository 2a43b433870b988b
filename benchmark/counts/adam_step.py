"""`adam_step` (csrc/adam.cu): one Adam step over every float32 leaf of
the tree, in one pass.

Bytes: each parameter's p, g, m and v read once and p', m' and v' written
once, 4 B each: 28 B a parameter. Operations: about 14 a parameter on the
float32 pipes (the l2 term, the two moments, the bias corrections, the
square root, ε, the division and the update), far below the bytes' time.
"""
from benchmark.peaks import FP32_FLOPS, bound_s

BYTES_PER_PARAM = 7 * 4
OPS_PER_PARAM = 14


def bound(n_params: int):
    """→ (seconds, what bounds it)."""
    return bound_s(n_params * BYTES_PER_PARAM, n_params * OPS_PER_PARAM,
                   FP32_FLOPS)
