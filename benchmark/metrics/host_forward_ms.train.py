"""Host ms a training step spends enqueuing its forward pass: the
`train.forward` spans' total over the profiled window (the encode, the
MLP's training form and the loss, `models/trainer.py::value_and_grad`),
per `train.step` span."""

SPAN = "train.forward"


def read(m):
    if m.trace is None:
        return None
    try:
        from instantvnr_torch.utils.profiling import span_summary
    except ImportError:  # a program that records no spans
        return None
    spans = span_summary()
    steps = spans.get("train.step", {}).get("count", 0)
    if not steps or SPAN not in spans:
        return None
    return spans[SPAN]["total_ms"] / steps
