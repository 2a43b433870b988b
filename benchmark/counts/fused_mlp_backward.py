"""K2, `fused_mlp_backward` (with its partial sums' pass): the MLP's
backward from the forward's residuals.

Bytes: the bf16 input and weights, the float32 pre-activations and
output, the float32 output cotangent, the bf16 input cotangent and the
float32 weight gradients, each once. Operations: g·Wᵀ and hᵀ·g, 4 a
multiply-add of the forward, with each float32 cotangent split into three
bf16 terms on the tensor cores: 3 × 4 × MACs.
"""
from benchmark.peaks import BF16_FLOPS, bound_s


def bound(batch: int, widths: list):
    """widths: [n_in, W, ..., W, n_out] → (seconds, what bounds it)."""
    pairs = list(zip(widths[:-1], widths[1:]))
    per_row = sum(a * c for a, c in pairs)
    n_hidden = len(widths) - 2
    n_bytes = (batch * widths[0] * 2 + n_hidden * batch * widths[1] * 4
               + batch * widths[-1] * 4 + batch * widths[-1] * 4
               + batch * widths[0] * 2 + per_row * 4 + per_row * 2)
    return bound_s(n_bytes, 3 * 4 * batch * per_row, BF16_FLOPS)
