"""K1's training form, `fused_mlp_train_forward`: the bias-free MLP
forward that also writes each hidden layer's float32 pre-activation.

Bytes: the bf16 input, the bf16 weights, the float32 output and the
float32 pre-activations [n_hidden, B, W] written once. Operations: 2 per
multiply-add on the bf16 tensor cores.
"""
from benchmark.peaks import BF16_FLOPS, bound_s


def bound(batch: int, widths: list):
    """widths: [n_in, W, ..., W, n_out] → (seconds, what bounds it)."""
    pairs = list(zip(widths[:-1], widths[1:]))
    macs = batch * sum(a * c for a, c in pairs)
    w_bytes = sum(2 * a * c for a, c in pairs)
    n_hidden = len(widths) - 2
    n_bytes = (batch * widths[0] * 2 + batch * widths[-1] * 4
               + n_hidden * batch * widths[1] * 4 + w_bytes)
    return bound_s(n_bytes, 2 * macs, BF16_FLOPS)
