"""Host ms a training step spends enqueuing its backward pass: the
`train.backward` spans' total over the profiled window
(`torch.autograd.grad`: K2, K4 and the autograd functions' Python), per
`train.step` span."""

SPAN = "train.backward"


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
