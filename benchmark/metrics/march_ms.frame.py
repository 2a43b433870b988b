"""Device time a frame spends in the emission (`raymarch_emit_kernel`)
and the compaction kernels (`compact_rows`: count, partition, copy back;
`scatter_rows`: invert, gather), from the profiled window."""

PATTERNS = ("raymarch_emit_kernel", "compact_count_kernel",
            "compact_partition_kernel", "compact_copy_back_kernel",
            "scatter_invert_kernel", "scatter_gather_kernel")


def read(m):
    t = m.trace
    if t is None or not t.units:
        return None
    s = t.device_s(*PATTERNS)
    return s / t.units * 1e3 if s > 0 else None
