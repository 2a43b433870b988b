"""Host ms a training step spends blocked on the card: the `train.wait`
spans' total over the profiled window (the closing `float(loss)` of each
`NeuralVolume.train` call, `api.py`), per `train.step` span."""

SPAN = "train.wait"


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
