"""K1's training form and K2 against their bounds (benchmark/counts/),
over the device time of `fused_mlp_forward_kernel`,
`fused_mlp_backward_kernel` and its `sum_partials_kernel`, per step."""

KERNELS = ("fused_mlp_forward_kernel", "fused_mlp_backward_kernel")


def read(m):
    t, ref = m.trace, m.reference
    if t is None or not t.units or "mlp_widths" not in ref:
        return None
    b = int(m.traffic["batch"])
    fwd, _ = m.count("fused_mlp_train_forward").bound(b, ref["mlp_widths"])
    bwd, _ = m.count("fused_mlp_backward").bound(b, ref["mlp_widths"])
    dev = t.device_s(*KERNELS, "sum_partials_kernel") / t.units
    if dev <= 0:
        return None
    return 100.0 * (fwd + bwd) / dev
