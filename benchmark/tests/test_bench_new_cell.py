"""A cell, a configuration and a traffic mix added as files and manifest
entries only: a throwaway checkout in a temporary directory, whose run
finds them by name with the harness unedited."""
import json
import os
import shutil
import time

from benchmark import harness
from benchmark.tests.cells import training_cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_a_cell_added_as_data_runs_unedited(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for sub in ("configs", "workloads", "limits"):
        (tmp_path / "benchmark" / sub).mkdir(parents=True)
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "vnr_ref_2e19.json")) as f:
        cfg = json.load(f)
    cfg["encoding"] = {**cfg["encoding"], "n_levels": 2,
                       "n_features_per_level": 2, "log2_hashmap_size": 8}
    (tmp_path / "benchmark" / "configs" / "tiny_grid.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark" / "workloads" / "train_tiny.json").write_text(
        json.dumps({"kind": "train", "batch": 1024, "steps_per_call": 2,
                    "volume_dims": [16, 16, 16]}))
    (tmp_path / "benchmark" / "limits" / "train_tiny_grid.json").write_text(
        json.dumps({"loss_gap": 0.01, "first_loss_gap": 1e-4,
                    "grad_gap": 0.02, "change_gap": 0.1,
                    "late_loss_gap": 1e-4, "late_grad_gap": 0.02,
                    "late_change_gap": 0.1}))
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny_grid", "source": "a test",
                         "file": "benchmark/configs/tiny_grid.json",
                         "reduced": [], "why": "a throwaway"})
    m["workloads"].append({"name": "train_tiny_grid", "config": "tiny_grid",
                           "traffic": "train_tiny", "chips": 1,
                           "why": "a throwaway"})
    for e in m["end_to_end"] + m["per_layer"]:
        if set(training_cells()) & set(e.get("workloads", [])):
            e["workloads"].append("train_tiny_grid")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    # a window of 0 s runs one call: the late step comes at the same
    # optimizer count in every run, and so do its widest gaps
    for trace in (False, True):
        out = harness.run_cell(str(tmp_path), "train_tiny_grid", 2**31 + 9,
                               0.0, trace, time.perf_counter(), device="cpu")
        assert out["correct"], out["checks"]
        assert out["attempted"] > 0 and out["failed"] == 0
        if not trace:
            assert set(out["metrics"]) == {"train_msamples_per_s", "setup_s"}
        else:
            # the host-clock layers; the device's need the card
            assert {"dispatch_ms.train", "train_mfu"} <= set(out["metrics"])
