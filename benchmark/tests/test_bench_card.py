"""On the card: each cell's command runs and comes out correct, and each
cell's control (the reference in the precision below the configuration's,
in the program's place) comes out not correct; so does the frame cell
that a later change may add as data (benchmark/tests/frame_cell.py).
These tests carry the `cuda` marker and skip without a card:

    python3 -m pytest benchmark/tests -m cuda -q -p no:cacheprovider
"""
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness
from benchmark.tests import frame_cell

ROOT = os.path.dirname(harness.PACKAGE_DIR)
CELLS = [w["name"] for w in harness.load_manifest(ROOT)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_the_command_is_correct(card, cell):
    cmd = harness.load_manifest(ROOT)["command"]
    out = subprocess.run(cmd + ["--workload", cell, "--seed", "4000000001",
                                "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_the_frame_cell_added_as_data_is_correct(card, tmp_path):
    root = frame_cell.checkout_with_frames(tmp_path)
    out = harness.run_cell(root, frame_cell.CELL, 4000000005, 2.0, False,
                           time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"frame_fps", "frame_ms_p95", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS + [frame_cell.CELL])
def test_the_control_is_not_correct(card, cell, tmp_path):
    import torch

    root = ROOT if cell in CELLS else frame_cell.checkout_with_frames(
        tmp_path)
    m = harness.load_manifest(root)
    w = {x["name"]: x for x in m["workloads"]}[cell]
    ctx = harness.Context(root=root, cell=w,
                          config=harness.data_file(root, "configs",
                                                   w["config"]),
                          traffic=harness.data_file(root, "workloads",
                                                    w["traffic"]),
                          seed=4000000003, device=torch.device("cuda"))
    sess = harness.load_module(ROOT, "traffic",
                               ctx.traffic["kind"]).Session(ctx)
    sess.setup()
    sess.run_until(time.perf_counter() + 1.0, harness.Spans())
    sess.release()
    torch.cuda.empty_cache()
    readings = sess.calibration()
    limits = harness.data_file(root, "limits", cell)
    assert all(readings["program"][k] <= v for k, v in limits.items())
    assert any(readings["control"][k] > v for k, v in limits.items())
    for fault in readings["faults"].values():
        assert any(fault[k] > v for k, v in limits.items())
