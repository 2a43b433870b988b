"""Timing, tracing and memory reports (counterpart of
`instantvnr_tpu/utils/profiling.py`; the reference's vidi helpers):

  vidi::StackTimer / HighPerformanceTimer → StackTimer (context manager)
  vidi::FPSCounter                        → FPSCounter
  util::total_n_bytes_allocated + vnrMemoryQuery → device_memory_report
  a kernel-level trace                    → trace(logdir) (torch.profiler,
                                            a Chrome trace)

PyTorch returns before the card finishes, so a host clock around work on
the card measures the enqueue unless `sync` waits for the work first.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import torch


def _cuda_devices(obj, out: set):
    """The CUDA devices of every tensor in obj (tensors, and tuples, lists
    and dicts of them)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, out)
    return out


def sync(*tensors):
    """Wait until the card has finished the work queued on each CUDA
    tensor's device (every leaf of every argument); CPU tensors need no
    wait."""
    for dev in _cuda_devices(tensors, set()):
        torch.cuda.synchronize(dev)


class StackTimer:
    """with StackTimer("training chunk"): ...  → prints the elapsed time on
    exit; `sync_on` (tensors) is waited for before the clock stops."""

    def __init__(self, label: str = "", out=sys.stderr, sync_on=None):
        self.label = label
        self.out = out
        self.sync_on = sync_on
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync_on is not None:
            sync(self.sync_on)
        self.elapsed = time.perf_counter() - self.t0
        if self.label:
            print(f"[timer] {self.label}: {self.elapsed * 1e3:.2f} ms",
                  file=self.out)
        return False


class FPSCounter:
    """Exponentially smoothed frames a second (vidi::FPSCounter)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self._last = None
        self.fps = 0.0

    def frame(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = 1.0 / max(now - self._last, 1e-9)
            self.fps = (self.alpha * inst + (1 - self.alpha) * self.fps
                        if self.fps else inst)
        self._last = now
        return self.fps


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the enclosed block with torch.profiler (the host's operations,
    and the card's kernels when CUDA is available) and write it as a
    Chrome trace, `logdir/trace.json` (chrome://tracing, Perfetto). Yields
    the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            # the card's last kernels end inside the trace
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def device_memory_report() -> str:
    """A line of memory statistics a device (vnrMemoryQueryPrint)."""
    from instantvnr_torch.api import memory_query

    lines = []
    for name, m in memory_query().items():
        if not m:
            lines.append(f"{name}: memory stats unavailable")
            continue
        lines.append(f"{name}: {m['bytes_in_use'] / 1e9:.2f} GB in use "
                     f"(peak {m['peak_bytes_in_use'] / 1e9:.2f} / limit "
                     f"{m['bytes_limit'] / 1e9:.2f})")
    return "\n".join(lines)
