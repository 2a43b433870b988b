"""Timing, tracing and memory reports (counterpart of
`instantvnr_tpu/utils/profiling.py`; the reference's vidi helpers):

  vidi::StackTimer / HighPerformanceTimer → span(name): a host span kept
                                            in memory while a profiler
                                            records
  util::total_n_bytes_allocated + vnrMemoryQuery → device_memory_report
  a kernel-level trace                    → trace(logdir) (torch.profiler,
                                            a Chrome trace, spans included)

Spans. `with span(name):` times a stage of the program on the host clock
(`time.perf_counter_ns`). It records only while a torch.profiler session
records (`trace()`, a profiled benchmark window); otherwise it costs one
read of the profiler's flag and returns one shared no-op context. A
record holds the span's name, start and end, its id, its parent's id (the
span open on the same thread when it began, 0 for none) and its root's
id: a span with no parent is a root, and its whole tree shares the
root's id (one `NeuralVolume.train` call is one tree). Each thread keeps
its own stack of open spans. Records stay in memory in `STORE`, up to its
cap (it counts the records it drops); `span_summary()` sums them by name
and `reset_spans()` clears them.

A span enters no profiler range unless asked (`annotate=True`): a range
of torch.profiler also comes back on the device's timeline, as a
`gpu_user_annotation` over the kernels launched inside it, and a reader
of the device's events would count it as device work. `trace()` writes
the spans into its Chrome trace instead, on the profiler's clock by an
anchor taken on both clocks.

PyTorch returns before the card finishes, so a host span around work on
the card measures the enqueue unless `sync` waits for the work first.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function


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


# -- spans --------------------------------------------------------------------


class SpanRecord(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int  # 0 for a root
    root: int  # the id its tree shares
    thread: int  # the OS thread's id, as the profiler names threads


class SpanStore:
    """Closed spans in memory, up to `cap`; `dropped` counts the rest."""

    def __init__(self, cap: int = 1 << 16):
        self.cap = cap
        self.records: list[SpanRecord] = []
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, record: SpanRecord):
        with self._lock:
            if len(self.records) < self.cap:
                self.records.append(record)
            else:
                self.dropped += 1

    def clear(self):
        with self._lock:
            self.records = []
            self.dropped = 0

    def summary(self) -> dict:
        """{name: {"count", "total_ms", "self_ms"}}: a span's self time is
        its duration less the part of it that its child spans cover."""
        with self._lock:
            records = list(self.records)
        children: dict = {}
        for r in records:
            if r.parent:
                children.setdefault(r.parent, []).append((r.start_ns,
                                                          r.end_ns))
        out: dict = {}
        for r in records:
            s = out.setdefault(r.name, {"count": 0, "total_ms": 0.0,
                                        "self_ms": 0.0})
            dur = r.end_ns - r.start_ns
            covered = _covered(children.get(r.id, ()), r.start_ns, r.end_ns)
            s["count"] += 1
            s["total_ms"] += dur * 1e-6
            s["self_ms"] += (dur - covered) * 1e-6
        return out


def _covered(intervals, lo: int, hi: int) -> int:
    """The length of [lo, hi] that the union of `intervals` covers."""
    total, reach = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


STORE = SpanStore()
_IDS = itertools.count(1)
# .stack: the thread's open spans; .tid: its OS id, read once (a system
# call, slow on some hosts)
_OPEN = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start_ns", "_range")

    def __init__(self, name: str, annotate: bool):
        self.name = name
        self._range = record_function(name) if annotate else None

    def __enter__(self):
        stack = _open().stack
        self.id = next(_IDS)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = 0, self.id
        stack.append(self)
        if self._range is not None:
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        local = _open()
        local.stack.pop()
        STORE.add(SpanRecord(self.name, self.start_ns, end, self.id,
                             self.parent, self.root, local.tid))
        return False


def _open():
    if not hasattr(_OPEN, "stack"):
        _OPEN.stack = []
        _OPEN.tid = threading.get_native_id()
    return _OPEN


def span(name: str, annotate: bool = False):
    """A context manager that records a span named `name` while a
    torch.profiler session records, and with `annotate` also enters a
    profiler range of that name; otherwise the shared no-op `NO_SPAN`."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name, annotate)


def span_summary() -> dict:
    """{name: {"count", "total_ms", "self_ms"}} of the spans recorded."""
    return STORE.summary()


def reset_spans():
    STORE.clear()


# -- the Chrome trace ---------------------------------------------------------

TRACE_FILE = "trace.json"
# ranges that tie the spans' clock to the trace's
ANCHOR = "profiling.anchor"
ANCHORS = 3  # the first range of a process is slow; the narrowest is kept


def _anchors() -> list:
    """(host clock before, host clock after) each of ANCHORS empty
    profiler ranges."""
    out = []
    for _ in range(ANCHORS):
        t0 = time.perf_counter_ns()
        with record_function(ANCHOR):
            pass
        out.append((t0, time.perf_counter_ns()))
    return out


def _add_spans(path: str, anchors: list):
    """Write the spans recorded since the first anchor into the Chrome
    trace at `path`, shifted onto its clock: the middle of the anchor
    range read most narrowly on the host is the middle of the host
    clock's readings around it."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    marks = sorted((e for e in events if e.get("name") == ANCHOR
                    and e.get("ph") == "X"), key=lambda e: e["ts"])
    if len(marks) != len(anchors):
        return
    i = min(range(len(anchors)), key=lambda k: anchors[k][1] - anchors[k][0])
    mark, (t0, t1) = marks[i], anchors[i]
    shift_us = mark["ts"] + 0.5 * mark.get("dur", 0) - 0.5e-3 * (t0 + t1)
    for r in list(STORE.records):
        if r.start_ns < anchors[0][0]:
            continue
        events.append({"ph": "X", "cat": "program_span", "name": r.name,
                       "pid": mark["pid"], "tid": r.thread,
                       "ts": r.start_ns * 1e-3 + shift_us,
                       "dur": (r.end_ns - r.start_ns) * 1e-3,
                       "args": {"id": r.id, "parent": r.parent,
                                "root": r.root}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the enclosed block with torch.profiler (the host's operations,
    and the card's kernels when CUDA is available) and write it as a
    Chrome trace, `logdir/trace.json` (chrome://tracing, Perfetto), with
    the spans recorded meanwhile (category `program_span`). Yields the
    trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        anchors = _anchors()
        try:
            yield path
        finally:
            # the card's last kernels end inside the trace
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    _add_spans(path, anchors)


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
