"""Device time a step of Adam's update takes, from the profiled window:
`csrc/adam.cu`'s `adam_step_kernel`, which `models/optimizer.py::
adam_update` launches once a step for the whole tree."""

PATTERNS = ("adam_step_kernel",)


def read(m):
    t = m.trace
    if t is None or not t.units:
        return None
    s = t.device_s(*PATTERNS)
    return s / t.units * 1e3 if s > 0 else None
