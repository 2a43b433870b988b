"""Host ms a training step takes to enqueue: the `train.step` spans'
total over the profiled window (`models/trainer.py`: sampling, forward,
backward and Adam, issued without waiting for the card), per step."""

SPAN = "train.step"


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
