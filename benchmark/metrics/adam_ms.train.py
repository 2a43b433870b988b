"""Device time a step of Adam's update (`models/optimizer.py::
adam_update`, whose `torch._foreach_*` operations run as
`multi_tensor_apply_kernel`s) takes, from the profiled window."""

PATTERNS = ("multi_tensor_apply_kernel",)


def read(m):
    t = m.trace
    if t is None or not t.units:
        return None
    s = t.device_s(*PATTERNS)
    return s / t.units * 1e3 if s > 0 else None
