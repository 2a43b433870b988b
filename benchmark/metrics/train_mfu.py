"""The whole step's share of the card's bf16 peak: the model's FLOPs a
sample (the MLP's multiply-adds, 2 FLOPs each, forward once and backward
twice, counted by the reference from the configuration's widths) times
the samples of the window, over the window, over 989 TFLOP/s."""

from benchmark.peaks import BF16_FLOPS


def read(m):
    flops = m.reference.get("flops_per_sample")
    if not flops or not m.window_s:
        return None
    samples = m.units * int(m.traffic["batch"])
    return 100.0 * samples * flops / m.window_s / BF16_FLOPS
