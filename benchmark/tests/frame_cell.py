"""The progressive-frame cell, added to a throwaway checkout as data only.

`frames_exact_512` is not in BENCHMARK.json: its runs spread by more than
the largest bound the benchmark may set (PERF.md, Open questions). Its
traffic kind, reference, readers, workload and limits stay under
benchmark/, so a later change adds the cell with these manifest entries
alone; the tests run it that way."""
import json
import os
import shutil

from benchmark import harness

ROOT = os.path.dirname(harness.PACKAGE_DIR)
CELL = "frames_exact_512"
ENTRIES = {
    "workload": {"name": CELL, "config": "vnr_ref_2e19",
                 "traffic": "frames_exact_512", "chips": 1,
                 "why": "a held 512^2 orbit view, one jittered progressive "
                        "pass a frame, the network (K3 + K1) at every "
                        "sample: the exact wavefront a viewer inspects"},
    "end_to_end": [
        {"name": "frame_fps", "unit": "frames/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": [CELL]},
        {"name": "frame_ms_p95", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": [CELL]}],
    "per_layer": [
        {"name": "dispatch_ms.frame", "unit": "ms", "better": "lower",
         "source": "host_clock",
         "layer": "api.VNRenderer.render, render/renderer.py and "
                  "render/compaction.py (host)"},
        {"name": "supersteps.frame", "unit": "count", "better": "lower",
         "source": "program_counter", "layer": "render/raymarch.py"},
        {"name": "march_ms.frame", "unit": "ms", "better": "lower",
         "source": "device_trace",
         "layer": "csrc/raymarch_emit.cu and csrc/compaction.cu"},
        {"name": "network_ms.frame", "unit": "ms", "better": "lower",
         "source": "device_trace",
         "layer": "models/network.py network_apply_chunked (K3 + K1 "
                  "inference)"},
        {"name": "blend_ms.frame", "unit": "ms", "better": "lower",
         "source": "device_trace",
         "layer": "the frame's plain PyTorch operations (selection, blend, "
                  "accumulation)"},
        {"name": "frame_mfu", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "the whole frame"},
        {"name": "device_idle.frame", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device"}],
}


def manifest_with_frames(manifest: dict) -> dict:
    m = json.loads(json.dumps(manifest))
    m["workloads"].append(ENTRIES["workload"])
    m["end_to_end"] += ENTRIES["end_to_end"]
    m["per_layer"] += [{**p, "moves": "frame_fps", "workloads": [CELL]}
                       for p in ENTRIES["per_layer"]]
    return m


def checkout_with_frames(tmp_path) -> str:
    """A checkout whose BENCHMARK.json adds the frame cell; the data files
    are the benchmark's own, the modules found in this package."""
    for sub in ("configs", "workloads", "limits"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub),
                        tmp_path / "benchmark" / sub)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(
        manifest_with_frames(harness.load_manifest(ROOT))))
    return str(tmp_path)
