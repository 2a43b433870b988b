"""`adam_step` against its bound: the least time the chip could take to
read and write a step's parameters and moments (benchmark/counts/
adam_step.py, the parameters counted by the reference from the
configuration's leaves), over the device time a step of
`adam_step_kernel`."""

KERNEL = "adam_step_kernel"


def read(m):
    t, ref = m.trace, m.reference
    if t is None or not t.units or "n_params" not in ref:
        return None
    dev = t.device_s(KERNEL) / t.units
    if dev <= 0:
        return None
    bound, _ = m.count("adam_step").bound(ref["n_params"])
    return 100.0 * bound / dev
