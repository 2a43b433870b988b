"""The per-layer metrics that read the program's spans
(`instantvnr_torch/utils/profiling.py`): each reader against a planted
span store, and on the card a traced run of the first training cell that
reports them.

    python3 -m pytest benchmark/tests/test_bench_spans.py -q -p no:cacheprovider
"""
import json
import os
import subprocess

import pytest

from benchmark import harness
from benchmark.tests.cells import training_cells
from instantvnr_torch.utils import profiling

ROOT = os.path.dirname(harness.PACKAGE_DIR)
CELL = training_cells()[0]
READERS = {"host_step_ms.train": "train.step",
           "host_wait_ms.train": "train.wait",
           "host_sample_ms.train": "train.sample",
           "host_forward_ms.train": "train.forward",
           "host_backward_ms.train": "train.backward",
           "host_adam_ms.train": "train.adam"}
MS = 1_000_000  # ns


@pytest.fixture
def store(monkeypatch):
    fresh = profiling.SpanStore()
    monkeypatch.setattr(profiling, "STORE", fresh)
    return fresh


def inputs(trace=True):
    return harness.MetricInputs(cell={"name": CELL}, config={}, traffic={},
                                spans=harness.Spans(), units=30,
                                window_s=1.0,
                                trace=object() if trace else None)


def plant(store, calls: int, steps_a_call: int):
    """`calls` train.call trees: steps of 4 ms (sample 0.5, forward 1,
    backward 1.5, Adam 0.75 ms) and a 2 ms wait."""
    ids = iter(range(1, 10_000))
    t = 0
    stages = (("train.sample", 0.5), ("train.forward", 1.0),
              ("train.backward", 1.5), ("train.adam", 0.75))
    for _ in range(calls):
        call, t0 = next(ids), t
        for _ in range(steps_a_call):
            step, s0 = next(ids), t
            for name, ms in stages:
                store.add(profiling.SpanRecord(name, t, t + int(ms * MS),
                                               next(ids), step, call, 1))
                t += int(ms * MS)
            t = s0 + 4 * MS
            store.add(profiling.SpanRecord("train.step", s0, t, step, call,
                                           call, 1))
        store.add(profiling.SpanRecord("train.wait", t, t + 2 * MS,
                                       next(ids), call, call, 1))
        t += 2 * MS
        store.add(profiling.SpanRecord("train.call", t0, t, call, 0, call,
                                       1))


EXPECTED = {"host_step_ms.train": 4.0, "host_wait_ms.train": 2.0 / 10,
            "host_sample_ms.train": 0.5, "host_forward_ms.train": 1.0,
            "host_backward_ms.train": 1.5, "host_adam_ms.train": 0.75}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_its_stage_a_step(name, store):
    reader = harness.load_module(ROOT, "metrics", name)
    assert reader.SPAN == READERS[name]
    plant(store, calls=3, steps_a_call=10)
    assert reader.read(inputs()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_none_from_an_empty_store(name, store):
    reader = harness.load_module(ROOT, "metrics", name)
    assert reader.read(inputs()) is None
    plant(store, calls=1, steps_a_call=2)
    # nothing read outside a traced run
    assert reader.read(inputs(trace=False)) is None


def test_a_reader_gives_none_from_a_program_without_spans(store,
                                                          monkeypatch):
    plant(store, calls=1, steps_a_call=2)
    monkeypatch.delattr(profiling, "span_summary")
    for name in READERS:
        assert harness.load_module(ROOT, "metrics", name).read(
            inputs()) is None


def test_the_manifest_lists_the_span_metrics_for_c1():
    entries = {p["name"]: p for p in harness.load_manifest(ROOT)["per_layer"]}
    for name in READERS:
        e = entries[name]
        assert (e["source"], e["unit"], e["better"], e["moves"],
                e["workloads"]) == ("program_span", "ms", "lower",
                                    "train_msamples_per_s",
                                    training_cells())
    for cell in training_cells():
        assert set(READERS) <= set(harness.per_layer_names(
            harness.load_manifest(ROOT), cell))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_traced_run_of_c1_reports_the_span_metrics(card):
    cmd = harness.load_manifest(ROOT)["command"]
    out = subprocess.run(cmd + ["--workload", CELL, "--seed", "4000000021",
                                "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert set(READERS) <= set(metrics), sorted(metrics)
    assert all(metrics[n]["value"] > 0 for n in READERS)
    # a span is no device operation: it enters no profiler range
    ops = [name for name, _ in result["breakdown"]["device_ops"]]
    assert not [n for n in ops if n.startswith("train.")], ops
