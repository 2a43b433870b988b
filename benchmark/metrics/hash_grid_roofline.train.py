"""K3 and K4 against their bounds: the least time the chip could take for
a step's forward gather and backward scatter (benchmark/counts/,
distinct rows counted by the reference on the step's coordinates), over
the device time of `hash_encode_forward_kernel`, `hash_encode_backward_
kernel` and the step's fill kernels (the gradient table's zeroing, which
the scatter's bound counts as written)."""

KERNELS = ("hash_encode_forward_kernel", "hash_encode_backward_kernel")


def read(m):
    t, ref = m.trace, m.reference
    if t is None or not t.units or "distinct_rows" not in ref:
        return None
    enc = m.config["encoding"]
    b, nl, nf = (int(m.traffic["batch"]), int(enc["n_levels"]),
                 int(enc["n_features_per_level"]))
    fwd, _ = m.count("hash_encode_forward").bound(
        b, nl, nf, ref["distinct_rows"])
    bwd, _ = m.count("hash_encode_backward").bound(
        b, nl, nf, ref["n_entries"], ref["distinct_rows"])
    dev = t.device_s(*KERNELS, "FillFunctor") / t.units
    if dev <= 0:
        return None
    return 100.0 * (fwd + bwd) / dev
