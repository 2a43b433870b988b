"""Device time a frame spends outside the port's kernels: the plain
PyTorch operations of the selection, the blend, the accumulation and the
readback, from the profiled window."""

OWN = ("raymarch_emit_kernel", "compact_count_kernel",
       "compact_partition_kernel", "compact_copy_back_kernel",
       "scatter_invert_kernel", "scatter_gather_kernel",
       "hash_encode_forward_kernel", "fused_mlp_forward_kernel")


def read(m):
    t = m.trace
    if t is None or not t.units:
        return None
    s = t.total_kernel_s() - t.device_s(*OWN)
    return s / t.units * 1e3 if s > 0 else None
