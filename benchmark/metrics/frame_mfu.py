"""The whole frame's share of the card's bf16 peak: the network FLOPs of
the samples a pass takes (the MLP's multiply-adds, 2 FLOPs each; the
samples counted by the reference's march of the first pass, never by the
program) times the frames of the window, over the window, over 989
TFLOP/s."""

from benchmark.peaks import BF16_FLOPS


def read(m):
    flops, samples = (m.reference.get("flops_per_sample"),
                      m.reference.get("samples_per_frame"))
    if not flops or not samples or not m.window_s:
        return None
    return 100.0 * samples * flops * m.units / m.window_s / BF16_FLOPS
