"""utils/profiling.py of the port on the CPU: StackTimer, FPSCounter,
sync (nothing to wait for on CPU tensors), trace (a Chrome trace written
by torch.profiler) and device_memory_report."""
import io
import json
import time

import pytest
import torch

from instantvnr_torch.utils import profiling


def test_stack_timer_measures_and_reports():
    out = io.StringIO()
    x = torch.ones(4)
    with profiling.StackTimer("chunk", out=out, sync_on=(x, [x * 2])) as t:
        time.sleep(0.02)
    assert 0.015 < t.elapsed < 5.0
    assert out.getvalue().startswith("[timer] chunk: ")
    assert out.getvalue().rstrip().endswith(" ms")
    quiet = io.StringIO()
    with profiling.StackTimer(out=quiet) as t:
        pass
    assert quiet.getvalue() == "" and t.elapsed >= 0.0


def test_fps_counter_smooths():
    c = profiling.FPSCounter(alpha=0.5)
    assert c.frame() == 0.0  # the first frame has no interval
    time.sleep(0.01)
    first = c.frame()
    assert 0.0 < first <= 100.0 + 1e-6
    time.sleep(0.05)
    second = c.frame()
    # half the new rate (~20 fps), half the last
    assert second < first and second > 0.5 * first


def test_sync_on_cpu_tensors_waits_for_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("synchronized for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    x = torch.zeros(3)
    profiling.sync(x, (x, {"a": [x]}), 1.5, None)
    profiling.sync()
    assert profiling._cuda_devices(({"a": x}, [x]), set()) == set()


def test_trace_writes_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    with profiling.trace(str(logdir)) as path:
        a = torch.randn(64, 64)
        for _ in range(3):
            a = torch.mm(a, a).relu()
    assert path == str(logdir / "trace.json")
    with open(path) as f:
        doc = json.load(f)
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]


def test_trace_propagates_and_writes_nothing_on_error(tmp_path):
    with pytest.raises(ValueError):
        with profiling.trace(str(tmp_path / "p")):
            raise ValueError("boom")
    assert not (tmp_path / "p" / "trace.json").exists()


def test_device_memory_report_on_cpu():
    assert profiling.device_memory_report() == (
        "cpu: memory stats unavailable")
