"""The benchmark's harness: one cell, one seed, one run.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is found by name, so a later cell, configuration or
metric adds files and BENCHMARK.json entries and edits none:

- `benchmark/configs/<config>.json`: a configuration's sizes;
- `benchmark/workloads/<traffic>.json`: a traffic mix, its `kind` and
  parameters;
- `benchmark/traffic/<kind>.py`: the generator of a kind of traffic, a
  `Session` class (set-up, the measured loop, the check);
- `benchmark/metrics/<metric>.py`: a per-layer metric's reader, `read(m)`
  → a number, or None when there is nothing to read;
- `benchmark/counts/<kernel>.py`: a kernel's operations and bytes.

A run: the session makes its inputs from the seed and warms every shape
it uses (set-up), runs its loop for --seconds (the window), and with
--trace 1 then runs a profiled window for the per-layer metrics. After
the window the peak memory is read, the program's state is freed, and the
plain reference (benchmark/reference/) checks what the timed path
produced. The last line of standard output is the result.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
# whole top-level module names that no run may hold once its window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "instantvnr_tpu")
TRACE_SECONDS = 1.0  # the profiled window of a --trace 1 run


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# -- finding things by name --------------------------------------------------


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def data_file(root: str, sub: str, name: str) -> dict:
    with open(os.path.join(root, "benchmark", sub, name + ".json")) as f:
        return json.load(f)


def load_module(root: str, sub: str, name: str):
    """benchmark/<sub>/<name>.py of the checkout at `root`, else of this
    package (names may hold dots, so the file is loaded by path)."""
    for base in (os.path.join(root, "benchmark"), PACKAGE_DIR):
        path = os.path.join(base, sub, name + ".py")
        if os.path.exists(path):
            key = f"benchmark_{sub}_{name}".replace(".", "_")
            if key in sys.modules:
                return sys.modules[key]
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no benchmark/{sub}/{name}.py")


def forbidden_loaded() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


# -- what a session is handed --------------------------------------------------


class Spans:
    """The harness's host-clock spans around its calls into the program,
    by name."""

    def __init__(self):
        self.seconds: dict = {}

    def add(self, name: str, seconds: float):
        self.seconds.setdefault(name, []).append(seconds)

    def total(self, name: str) -> float:
        return sum(self.seconds.get(name, ()))

    def values(self, name: str) -> list:
        return list(self.seconds.get(name, ()))


@dataclass
class Context:
    root: str
    cell: dict  # the BENCHMARK.json workload entry
    config: dict  # benchmark/configs/<config>.json
    traffic: dict  # benchmark/workloads/<traffic>.json
    seed: int
    device: object  # torch.device


@dataclass
class Check:
    """One number compared with its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class MetricInputs:
    """What a per-layer reader reads."""

    cell: dict
    config: dict
    traffic: dict
    spans: Spans  # the untraced window's spans
    units: int  # steps or frames in the window
    window_s: float
    trace: object  # benchmark.trace.Reading or None
    program: dict = field(default_factory=dict)  # counters the program kept
    reference: dict = field(default_factory=dict)  # the reference's counts
    root: str = ""

    def count(self, kernel: str):
        """benchmark/counts/<kernel>.py."""
        return load_module(self.root, "counts", kernel)


# -- the run ------------------------------------------------------------------


def device_info(torch, count: int) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.split("\n")[0]
        info["power_limit"] = out.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


# the card's state that can slow a run: nvidia-smi's names
CARD_STATE = ("clocks.sm", "clocks_throttle_reasons.active",
              "temperature.gpu")


def card_state() -> str:
    """The card's SM clock, its active clock-throttle reasons (a bit mask;
    0x0000000000000000 is none, 0x...01 idle) and its temperature, read
    once by nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(CARD_STATE),
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
    line = out.stdout.split("\n")[0].strip()
    if out.returncode or not line:
        return f"not read ({(out.stderr or out.stdout).strip()[:200]})"
    return ", ".join(f"{k} {v.strip()}"
                     for k, v in zip(CARD_STATE, line.split(",")))


def _metric_applies(entry: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in e2e_of_cell


def end_to_end_names(manifest: dict, cell: str) -> list:
    return [m["name"] for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_names(manifest: dict, cell: str) -> list:
    e2e = set(end_to_end_names(manifest, cell))
    return [m["name"] for m in manifest["per_layer"]
            if _metric_applies(m, cell, e2e)]


def per_layer_metrics(manifest: dict, workload: str,
                      inputs: MetricInputs) -> dict:
    """The cell's per-layer metrics, each from its reader. A reading whose
    profiled launches differ from the launch counters dropped events, and
    every device time and the busy time read short from it: then no metric
    from the device trace is reported."""
    reading = inputs.trace
    bad = reading.mismatched() if reading is not None else ["no reading"]
    entries = {m["name"]: m for m in manifest["per_layer"]}
    metrics = {}
    for name in per_layer_names(manifest, workload):
        if entries[name]["source"] == "device_trace" and bad:
            log(f"{name}: left out, the profiler's launches of "
                f"{', '.join(bad)} do not match the launch counters")
            continue
        value = load_module(inputs.root, "metrics", name).read(inputs)
        if value is None:
            log(f"{name}: nothing to read in this cell")
            continue
        metrics[name] = {"value": float(value),
                         "unit": entries[name]["unit"]}
    return metrics


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t_process: float, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    """One run → the result object. `device` and `overrides` (a dict of
    config and traffic keys) serve the tests on the CPU, which also skip
    the look for a card; the command line always asks for the card."""
    import torch

    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    config = data_file(root, "configs", cell["config"])
    traffic = data_file(root, "workloads", cell["traffic"])
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    ctx = Context(root=root, cell=cell, config=config, traffic=traffic,
                  seed=seed, device=torch.device(device))
    kind = load_module(root, "traffic", traffic["kind"])
    units_of = {m["name"]: m["unit"] for m in
                manifest["end_to_end"] + manifest["per_layer"]}
    on_card = ctx.device.type == "cuda"

    sess = kind.Session(ctx)
    sess.setup()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    spans = Spans()
    units = sess.run_until(t0 + seconds, spans)  # ends synchronized
    window_s = time.perf_counter() - t0
    if on_card:  # whether a slow window ran at lowered clocks
        log("card at the window's close: " + card_state())
    reading = None
    if trace and on_card:
        from benchmark.trace import traced_window

        reading = traced_window(lambda until: sess.run_until(until, Spans()),
                                TRACE_SECONDS, log)
    program = sess.program_counters()
    memory_peak = (torch.cuda.max_memory_allocated(ctx.device) if on_card
                   else 0)
    sess.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # the reference's float32 products stay float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks, reference = sess.check()
    failed = sess.failed()

    if trace:
        inputs = MetricInputs(cell=cell, config=config, traffic=traffic,
                              spans=spans, units=units, window_s=window_s,
                              trace=reading, program=program,
                              reference=reference, root=root)
        metrics = per_layer_metrics(manifest, workload, inputs)
    else:
        e2e = sess.end_to_end(units, window_s, spans)
        e2e["setup_s"] = setup_s
        metrics = {name: {"value": float(e2e[name]), "unit": units_of[name]}
                   for name in end_to_end_names(manifest, workload)}

    result = {
        "correct": all(c.ok for c in checks),
        "attempted": int(units),
        "failed": int(failed),
        "metrics": metrics,
        "device": (device_info(torch, int(cell["chips"])) if on_card
                   else {"platform": "cpu", "kind": "cpu", "count": 1}),
    }
    result["device"]["memory_peak_bytes"] = int(memory_peak)
    if reading is not None:
        result["device"]["busy_s"] = reading.busy_s
        result["device"]["window_s"] = reading.window_s
        result["breakdown"] = {"device_ops": reading.device_ops,
                               "idle_gaps": reading.idle_gaps}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def main(argv, t_process: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.path.dirname(PACKAGE_DIR)
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        log(f"unknown workload {args.workload!r}")
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_process)
    loaded = forbidden_loaded()
    if loaded:
        log("modules that no run may load are loaded: " + ", ".join(loaded))
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
