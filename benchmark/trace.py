"""The traced window: device time by kernel name from `torch.profiler`, the
device's busy time, the breakdown, and the check of the profiler's kernel
counts against the port's own launch counters.

`torch.profiler` drops a reading's events now and then. Each port kernel
below has a `LaunchCounter` in the wrapper that launches it (a replayed
CUDA graph adds the launches its capture recorded), so a reading whose
profiled launches of a kernel differ from the counters' is taken again,
and while any still differs, every metric read from the device trace is
left out (a dropped event shortens every device time, the busy time too).
"""
from __future__ import annotations

import importlib
import re
import time
from dataclasses import dataclass, field

# kernel name (a substring of the profiled name) → the LaunchCounters of
# the wrappers that launch it, once a call: (module, attribute)
PORT_KERNELS = {
    "hash_encode_forward_kernel": (
        ("instantvnr_torch.ops.hash_encoding", "counter"),
        ("instantvnr_torch.ops.hash_encoding", "paired_counter")),
    "hash_encode_backward_kernel": (
        ("instantvnr_torch.ops.hash_encoding", "backward_counter"),
        ("instantvnr_torch.ops.hash_encoding", "paired_backward_counter")),
    "fused_mlp_forward_kernel": (
        ("instantvnr_torch.ops.fused_mlp", "counter"),
        ("instantvnr_torch.ops.fused_mlp", "train_forward_counter")),
    "fused_mlp_backward_kernel": (
        ("instantvnr_torch.ops.fused_mlp", "backward_counter"),),
    "raymarch_emit_kernel": (
        ("instantvnr_torch.render.raymarch", "emit_counter"),),
    "compact_partition_kernel": (
        ("instantvnr_torch.ops.compaction", "compact_counter"),),
    "scatter_gather_kernel": (
        ("instantvnr_torch.ops.compaction", "scatter_counter"),),
    "brick_sample_kernel": (
        ("instantvnr_torch.ops.brick_sample", "counter"),),
    "adam_step_kernel": (
        ("instantvnr_torch.ops.adam", "counter"),),
}

TRACE_ATTEMPTS = 3
WINDOW_LABEL = "bench.window"


def counter_totals() -> dict:
    """Each port kernel's launches so far, by the program's counters."""
    out = {}
    for kernel, owners in PORT_KERNELS.items():
        n = 0
        for mod, attr in owners:
            n += getattr(importlib.import_module(mod), attr).launches
        out[kernel] = n
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


@dataclass
class Reading:
    """One profiled window."""

    window_s: float  # host clock, from its first call to its synchronize
    units: int  # steps or frames in it
    busy_s: float  # union of the device's operations
    kernels: dict  # full name → [launches, seconds]
    launches: dict  # port kernel → profiled launches
    counted: dict  # port kernel → the counters' launches
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def mismatched(self) -> list:
        return [k for k in PORT_KERNELS
                if self.launches.get(k, 0) != self.counted.get(k, 0)]

    def device_s(self, *patterns) -> float:
        """Seconds of the kernels whose names hold any of the patterns."""
        return sum(s for name, (_, s) in self.kernels.items()
                   if any(p in name for p in patterns))

    def total_kernel_s(self) -> float:
        return sum(s for _, s in self.kernels.values())


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _read(prof, window_s: float, units: int, counted: dict) -> Reading:
    from torch.autograd import DeviceType

    events = prof.events()
    win = [e for e in events if e.name == WINDOW_LABEL]
    lo, hi = ((win[0].time_range.start, win[0].time_range.end) if win
              else (float("-inf"), float("inf")))
    dev, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if e.name != WINDOW_LABEL:  # the window's own annotation
                dev.append(e)
        elif e.device_type == DeviceType.CPU and e.name != WINDOW_LABEL:
            host.append(e)
    kernels: dict = {}
    launches = {k: 0 for k in PORT_KERNELS}
    spans = []
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        rec = kernels.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) * 1e-6
        for k in launches:
            if k in e.name:
                launches[k] += 1
    merged = _merge(spans)
    busy = sum(b - a for a, b in merged) * 1e-6
    # the idle stretches inside the window, each named by the innermost
    # host operation running at its middle
    gaps = []
    prev = lo if win else (merged[0][0] if merged else 0.0)
    for a, b in merged + [[hi, hi]] if win else merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host.sort(key=lambda e: e.time_range.start)
    by_label: dict = {}
    active: list = []  # host operations begun before the current gap
    nxt = 0
    for a, b in gaps:  # in time order
        mid = 0.5 * (a + b)
        while nxt < len(host) and host[nxt].time_range.start <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [e for e in active if e.time_range.end >= mid]
        best = min(active, default=None,
                   key=lambda e: e.time_range.end - e.time_range.start)
        label = best.name if best is not None else "host (no profiled op)"
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-6
    by_short: dict = {}
    for n, (_, s) in kernels.items():
        by_short[short_name(n)] = by_short.get(short_name(n), 0.0) + s
    device_ops = sorted(([n, s] for n, s in by_short.items()),
                        key=lambda x: -x[1])[:10]
    idle = sorted(([n, s] for n, s in by_label.items()),
                  key=lambda x: -x[1])[:10]
    return Reading(window_s=window_s, units=units, busy_s=busy,
                   kernels=kernels, launches=launches, counted=counted,
                   device_ops=device_ops, idle_gaps=idle)


def traced_window(run_until, seconds: float, log) -> Reading:
    """Profile `run_until(deadline)` (which runs units until the host clock
    passes the deadline, synchronizes, and returns how many it ran) for
    `seconds`, up to TRACE_ATTEMPTS times until the profiler's launches of
    every port kernel equal the counters'; → the first consistent reading,
    else the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    reading = None
    for attempt in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        before = counter_totals()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_LABEL):
                t0 = time.perf_counter()
                units = run_until(t0 + seconds)
                torch.cuda.synchronize()
                window_s = time.perf_counter() - t0
        after = counter_totals()
        counted = {k: after[k] - before[k] for k in after}
        reading = _read(prof, window_s, units, counted)
        bad = reading.mismatched()
        if not bad:
            return reading
        log(f"trace attempt {attempt + 1}: profiled launches differ from "
            "the launch counters for " + ", ".join(
                f"{k} ({reading.launches[k]} profiled, {counted[k]} counted)"
                for k in bad))
    return reading
