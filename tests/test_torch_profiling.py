"""utils/profiling.py of the port on the CPU: spans (nothing recorded
without a profiler; ids, parents, roots, counts and self times under one;
the cap; a stack a thread; the training step's spans), sync (nothing to
wait for on CPU tensors), trace (a Chrome trace written by torch.profiler,
the spans in it) and device_memory_report."""
import json
import threading
import time

import pytest
import torch

from torch.profiler import ProfilerActivity, profile

from instantvnr_torch.utils import profiling


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


# -- spans ----------------------------------------------------------------------


@pytest.fixture
def store(monkeypatch):
    """A fresh span store of the module's own, in place of the process's."""
    fresh = profiling.SpanStore()
    monkeypatch.setattr(profiling, "STORE", fresh)
    return fresh


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_a_span_without_a_profiler_records_nothing(store):
    for annotate in (False, True):
        s = profiling.span("idle", annotate=annotate)
        assert s is profiling.NO_SPAN
        with s as value:
            assert value is None
    assert store.records == [] and store.dropped == 0
    assert profiling.span_summary() == {}


def test_nested_spans_give_parents_roots_counts_and_self_times(store):
    with recording():
        with profiling.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.003)
        with profiling.span("outer"):
            pass
    recs = by_name(store.records)
    (o1, o2), inner = recs["outer"], recs["inner"]
    assert (o1.parent, o1.root) == (0, o1.id)
    assert (o2.parent, o2.root) == (0, o2.id) and o2.id != o1.id
    assert all(r.parent == o1.id and r.root == o1.id for r in inner)
    assert len({r.id for r in store.records}) == 4
    assert all(o1.start_ns <= r.start_ns < r.end_ns <= o1.end_ns
               for r in inner)
    summary = profiling.span_summary()
    assert summary["outer"]["count"] == 2 and summary["inner"]["count"] == 2
    dur = [r.end_ns - r.start_ns for r in (o1, o2, *inner)]
    assert summary["outer"]["total_ms"] == pytest.approx(
        (dur[0] + dur[1]) * 1e-6)
    assert summary["outer"]["self_ms"] == pytest.approx(
        (dur[0] - dur[2] - dur[3] + dur[1]) * 1e-6)
    assert summary["inner"]["self_ms"] == pytest.approx(
        summary["inner"]["total_ms"])
    assert summary["inner"]["total_ms"] >= 6.0
    assert summary["outer"]["self_ms"] >= 2.0
    profiling.reset_spans()
    assert store.records == [] and profiling.span_summary() == {}


def test_self_time_counts_overlapping_children_once():
    assert profiling._covered([(5, 20), (10, 30), (40, 50)], 0, 45) == 30
    assert profiling._covered([], 0, 10) == 0


def test_the_cap_counts_the_records_it_drops(store):
    store.cap = 2
    with recording():
        for _ in range(5):
            with profiling.span("x"):
                pass
    assert len(store.records) == 2 and store.dropped == 3
    assert profiling.span_summary()["x"]["count"] == 2
    profiling.reset_spans()
    assert store.records == [] and store.dropped == 0


def test_two_threads_keep_separate_stacks(store):
    opened, closed = threading.Event(), threading.Event()

    def worker():
        with profiling.span("w.outer"):
            opened.set()
            closed.wait(10)
            with profiling.span("w.inner"):
                pass

    with recording():
        t = threading.Thread(target=worker)
        t.start()
        assert opened.wait(10)
        with profiling.span("m.outer"):
            closed.set()
            with profiling.span("m.inner"):
                pass
            t.join(10)
    assert not t.is_alive()
    recs = {r.name: r for r in store.records}
    assert recs["w.inner"].parent == recs["w.outer"].id
    assert recs["m.inner"].parent == recs["m.outer"].id
    assert recs["w.outer"].parent == 0 and recs["m.outer"].parent == 0
    assert recs["w.inner"].root == recs["w.outer"].id
    assert recs["m.inner"].root == recs["m.outer"].id
    assert recs["w.inner"].thread != recs["m.inner"].thread


def test_spans_in_the_chrome_trace_on_its_clock(store, tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as path:
        with profiling.span("stage"):
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
        with profiling.span("ranged", annotate=True):
            pass
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"stage", "ranged"}
    mm = next(e for e in events if e.get("name") == "aten::mm")
    st = spans["stage"]
    # the span encloses the operation it ran, on the operation's thread
    assert st["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= st["ts"] + st[
        "dur"]
    assert (st["pid"], st["tid"]) == (mm["pid"], mm["tid"])
    assert st["args"]["parent"] == 0 and st["args"]["root"] == st["args"][
        "id"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    # only the span that asked for it is a profiler range
    assert "ranged" in ranges and "stage" not in ranges


def test_a_training_call_gives_its_step_spans(store):
    from instantvnr_torch import api
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig)

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=2,
                                              n_features_per_level=2,
                                              log2_hashmap_size=8),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=1))
    sv = api.SimpleVolume.synthetic((8, 8, 8), "vorts", device="cpu")
    nv = api.NeuralVolume(cfg, sv, device="cpu", train_batch=256)
    nv.train(1, fast_mode=True)  # nothing recorded without a profiler
    assert store.records == []
    with recording():
        nv.train(2, fast_mode=True)
    recs = by_name(store.records)
    (call,) = recs["train.call"]
    (wait,) = recs["train.wait"]
    steps = recs["train.step"]
    assert call.parent == 0 and len(steps) == 2
    assert wait.parent == call.id
    assert all(s.parent == call.id for s in steps)
    assert all(r.root == call.id for r in store.records)
    stages = ("train.sample", "train.forward", "train.backward", "train.adam")
    for stage in stages:
        assert sorted(r.parent for r in recs[stage]) == sorted(
            s.id for s in steps), stage
    assert set(recs) == {"train.call", "train.wait", "train.step", *stages}
    summary = profiling.span_summary()
    assert summary["train.step"]["count"] == 2
    assert summary["train.call"]["total_ms"] >= (
        summary["train.step"]["total_ms"] + summary["train.wait"]["total_ms"])


def test_isosurface_stages_are_spans_and_profiler_ranges(store):
    from instantvnr_torch.ops import isosurface as mt

    z, y, x = torch.meshgrid(*(torch.linspace(-1, 1, 9),) * 3,
                             indexing="ij")
    grid = (x * x + y * y + z * z).sqrt()
    plain = mt.extract_isosurface(grid, 0.6, slab=4)
    assert store.records == []
    with recording() as prof:
        verts, faces = mt.extract_isosurface(grid, 0.6, slab=4)
    assert (verts == plain[0]).all() and (faces == plain[1]).all()
    stages = ("isosurface.slab", "isosurface.extract", "isosurface.weld",
              "isosurface.to_host")
    counts = {k: v["count"] for k, v in profiling.span_summary().items()}
    assert counts == dict(zip(stages, (2, 2, 1, 1)))
    ranges = {e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU}
    assert set(stages) <= ranges
