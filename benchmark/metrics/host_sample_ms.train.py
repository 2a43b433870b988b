"""Host ms a training step spends enqueuing its batch: the `train.sample`
spans' total over the profiled window (`data/sampler.py::sample_static`),
per `train.step` span."""

SPAN = "train.sample"


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
