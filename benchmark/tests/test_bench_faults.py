"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a size a test run holds, with the cell's own limits:
first sound, then once for each fault the cell can have, planted in the
program where the fault would arise (an exchange between chips has no
place in a one-chip cell)."""
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import frame_cell
from benchmark.tests.cells import training_cells

ROOT = harness.os.path.dirname(harness.PACKAGE_DIR)
SEED = 2**31 + 77
GRID = {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 8,
        "log2_hashmap_size": 14, "base_resolution": 16,
        "per_level_scale": 2.0}
TRAIN = {"traffic": {"batch": 16384, "steps_per_call": 2,
                     "volume_dims": [48, 48, 48]}}
FRAMES = {"config": {"encoding": {**GRID, "n_levels": 4,
                                  "n_features_per_level": 4,
                                  "log2_hashmap_size": 12,
                                  "base_resolution": 8}},
          "traffic": {"width": 40, "height": 32,
                      "volume_dims": [32, 32, 32], "warm_frames": 5,
                      "camera": {"eye": [4.8, 3.2, -64.0],
                                 "center": [0, 0, 0], "up": [0, 1, 0],
                                 "fovy": 45.0}}}


def run(cell, overrides, root=ROOT):
    out = harness.run_cell(root, cell, SEED, 0.5, False, time.perf_counter(),
                           device="cpu", overrides=overrides)
    return out["correct"], out["checks"]


# every training cell runs the 2^19 reference model: a smaller table here
TRAIN_SMALL = {**TRAIN, "config": {"encoding": GRID}}


# -- training ----------------------------------------------------------------


def state_unchanged(mp):
    from instantvnr_torch import api

    mp.setattr(api, "train_steps", lambda field, vol, state, n, b: state)


def half_batch(mp):
    from instantvnr_torch.models import trainer

    draw = trainer.sample_static

    def half(vol, gen, batch, *a, **k):
        coords, targets = draw(vol, gen, batch, *a, **k)
        return coords[: batch // 2], targets[: batch // 2]

    mp.setattr(trainer, "sample_static", half)


def decay_off_after_set_up(mp):
    # the learning rate wrong from the window on: the first steps, which
    # set-up takes, stay sound, so only the late step can catch it
    from benchmark.traffic import train
    from instantvnr_torch.models import optimizer

    lr_at = optimizer.lr_at_step
    first = train.CHECK_STEPS + TRAIN["traffic"]["steps_per_call"]
    mp.setattr(optimizer, "lr_at_step",
               lambda cfg, step: lr_at(cfg, step) * (0.5 if step > first
                                                     else 1.0))


TRAIN_CELLS = training_cells()
CELL = {w["name"]: w for w in harness.load_manifest(ROOT)["workloads"]}[
    TRAIN_CELLS[0]]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_sound_training_run_is_correct(cell, trace):
    out = harness.run_cell(ROOT, cell, SEED, 0.5, trace, time.perf_counter(),
                           device="cpu", overrides=TRAIN_SMALL)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    m = harness.load_manifest(ROOT)
    if not trace:
        assert set(out["metrics"]) == set(harness.end_to_end_names(m, cell))
    else:  # the host clock's layers; the device's need the card
        assert {"dispatch_ms.train", "train_mfu"} <= set(out["metrics"])


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   decay_off_after_set_up],
                         ids=["state_unchanged", "half_batch",
                              "decay_off_after_set_up"])
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_faulty_training_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    ok, checks = run(cell, TRAIN_SMALL)
    assert not ok, checks


# -- frames ------------------------------------------------------------------


def frame_unchanged(mp):
    from instantvnr_torch.render import renderer

    mp.setattr(renderer.Renderer, "render", lambda self: self._frame)


def _wrap_sample(mp, change):
    """Plant `change` on every sample the frame takes, where the sample is
    produced: the network's output."""
    from instantvnr_torch.models import network

    net = network.network_apply_chunked

    def net_changed(*a, **k):
        return change(net(*a, **k))

    mp.setattr(network, "network_apply_chunked", net_changed)


def answer_altered(mp):
    def change(v):
        v = v.clone()
        v[: max(1, v.shape[0] // 64)] += 0.5
        return v

    _wrap_sample(mp, change)


def half_left_out(mp):
    def change(v):
        v = v.clone()
        v[v.shape[0] // 2:] = 0.0
        return v

    _wrap_sample(mp, change)


FRAME_CELLS = [frame_cell.CELL]


@pytest.mark.parametrize("cell", FRAME_CELLS)
def test_a_sound_frame_run_is_correct(cell, tmp_path):
    ok, checks = run(cell, FRAMES, frame_cell.checkout_with_frames(tmp_path))
    assert ok, checks


@pytest.mark.parametrize("fault", [frame_unchanged, answer_altered,
                                   half_left_out],
                         ids=["state_unchanged", "answer_altered",
                              "half_left_out"])
@pytest.mark.parametrize("cell", FRAME_CELLS)
def test_a_faulty_frame_is_not_correct(cell, fault, monkeypatch, tmp_path):
    root = frame_cell.checkout_with_frames(tmp_path)
    fault(monkeypatch)
    ok, checks = run(cell, FRAMES, root)
    assert not ok, checks


def test_the_sessions_free_the_program_before_the_reference():
    # the check runs after release(): the program's objects are gone
    ctx = harness.Context(
        root=ROOT, cell=CELL, config={**harness.data_file(
            ROOT, "configs", CELL["config"]), "encoding": GRID},
        traffic={**harness.data_file(ROOT, "workloads", CELL["traffic"]),
                 **TRAIN["traffic"]}, seed=SEED, device=torch.device("cpu"))
    sess = harness.load_module(ROOT, "traffic", "train").Session(ctx)
    sess.setup()
    sess.release()
    assert not hasattr(sess, "nv") and not hasattr(sess, "sv")
    # what the late check keeps of the program's state is on the host
    assert all(x.device.type == "cpu" for x in sess.late["params"])


class _Reading:
    """A profiled window whose launches of `dropped` differ from the
    launch counters."""

    def __init__(self, dropped):
        self.dropped = dropped
        self.window_s, self.units, self.busy_s = 1.0, 100, 0.9
        self.kernels = {"hash_encode_backward_kernel": [100, 0.2],
                        "adam_step_kernel": [100, 0.022]}

    def mismatched(self):
        return self.dropped

    def device_s(self, *patterns):
        return sum(s for n, (_, s) in self.kernels.items()
                   if any(p in n for p in patterns))

    def total_kernel_s(self):
        return sum(s for _, s in self.kernels.values())


@pytest.mark.parametrize("dropped", [[], ["hash_encode_backward_kernel"]],
                         ids=["consistent", "dropped"])
def test_a_reading_that_dropped_events_reports_no_device_metric(dropped):
    m = harness.load_manifest(ROOT)
    cell = CELL["name"]
    spans = harness.Spans()
    spans.add("train_call", 0.05)
    inputs = harness.MetricInputs(
        cell=CELL, config=harness.data_file(ROOT, "configs", CELL["config"]),
        traffic=harness.data_file(ROOT, "workloads", CELL["traffic"]),
        spans=spans, units=10, window_s=0.05, trace=_Reading(dropped),
        reference={"flops_per_sample": 98688}, root=ROOT)
    out = harness.per_layer_metrics(m, cell, inputs)
    source = {p["name"]: p["source"] for p in m["per_layer"]}
    traced = {n for n in harness.per_layer_names(m, cell)
              if source[n] == "device_trace"}
    assert {"dispatch_ms.train", "train_mfu"} <= set(out)
    if dropped:
        assert not traced & set(out)
    else:
        assert {"adam_ms.train", "device_idle.train"} <= set(out)
        assert out["device_idle.train"]["value"] == pytest.approx(10.0)


def test_a_busy_time_past_the_window_shows_in_the_idle_share():
    # a busy time longer than its window is a fault of the reading, and the
    # idle share shows it below 0 rather than hiding it at 0
    reading = _Reading([])
    reading.busy_s = 1.1
    inputs = harness.MetricInputs(
        cell={}, config={}, traffic={}, spans=harness.Spans(), units=1,
        window_s=1.0, trace=reading, root=ROOT)
    for name in ("device_idle.train", "device_idle.frame"):
        idle = harness.load_module(ROOT, "metrics", name).read(inputs)
        assert idle == pytest.approx(-10.0)
