"""Host ms a training step spends enqueuing Adam's update: the
`train.adam` spans' total over the profiled window
(`models/optimizer.py::adam_update`: the host's scalars and the
`torch._foreach_*` launches), per `train.step` span."""

SPAN = "train.adam"


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
