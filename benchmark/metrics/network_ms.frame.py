"""Device time a frame spends sampling the network: K3
(`hash_encode_forward_kernel`) and K1's inference form
(`fused_mlp_forward_kernel`), from the profiled window."""

KERNELS = ("hash_encode_forward_kernel", "fused_mlp_forward_kernel")


def read(m):
    t = m.trace
    if t is None or not t.units:
        return None
    s = t.device_s(*KERNELS)
    return s / t.units * 1e3 if s > 0 else None
