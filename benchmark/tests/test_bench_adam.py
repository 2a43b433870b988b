"""Adam's layer (`csrc/adam.cu` `adam_step`, one launch a step):
`adam_ms.train` and `adam_roofline.train` read `adam_step_kernel` from a
profiled window and nothing without it, `counts/adam_step.py` gives the
kernel table's bound at the reference model's tree, the launch check
counts the kernel, and the harness's card-state line; on the card, a
traced run of each training cell reads the layer.

    python3 -m pytest benchmark/tests/test_bench_adam.py -q -p no:cacheprovider
"""
import json
import math
import os
import subprocess

import pytest

from benchmark import harness, trace
from benchmark.reference import fields
from benchmark.tests.cells import training_cells

ROOT = os.path.dirname(harness.PACKAGE_DIR)
N_PARAMS = 23_380_032  # the 2^19 table's 2,920,448 rows × 8, and 16,448 MLP weights
BOUND_MS = 0.19542  # 654.6 MB at 3.35 TB/s


class _Reading:
    def __init__(self, kernels, units=100):
        self.kernels, self.units = kernels, units

    def device_s(self, *patterns):
        return sum(s for n, (_, s) in self.kernels.items()
                   if any(p in n for p in patterns))


def inputs(kernels, reference=None):
    return harness.MetricInputs(
        cell={}, config={}, traffic={}, spans=harness.Spans(), units=100,
        window_s=1.0, trace=None if kernels is None else _Reading(kernels),
        reference={"n_params": N_PARAMS} if reference is None else reference,
        root=ROOT)


def reader(name):
    return harness.load_module(ROOT, "metrics", name)


FUSED = {"adam_step_kernel": [100, 0.0220],
         "hash_encode_backward_kernel<unsigned short, 8>": [100, 0.116]}


def test_the_readers_read_the_fused_kernel():
    assert reader("adam_ms.train").read(inputs(FUSED)) == pytest.approx(0.22)
    assert reader("adam_roofline.train").read(inputs(FUSED)) == (
        pytest.approx(100 * BOUND_MS / 0.22, rel=1e-4))


@pytest.mark.parametrize("name", ["adam_ms.train", "adam_roofline.train"])
@pytest.mark.parametrize("case", ["no_trace", "foreach_kernels_only",
                                  "no_steps"])
def test_the_readers_read_nothing_without_the_kernel(name, case):
    if case == "no_trace":
        m = inputs(None)
    elif case == "foreach_kernels_only":  # Adam's form before the kernel
        m = inputs({"multi_tensor_apply_kernel": [1400, 0.13]})
    else:
        m = inputs(FUSED)
        m.trace.units = 0
    assert reader(name).read(m) is None


def test_the_roofline_reads_nothing_without_the_parameter_count():
    assert reader("adam_roofline.train").read(
        inputs(FUSED, reference={"mlp_widths": [64, 64, 1]})) is None


def test_the_bound_at_the_reference_models_tree():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "vnr_ref_2e19.json")) as f:
        model = fields.model_for(json.load(f))
    n = sum(math.prod(s) for s in model.leaf_shapes())
    assert n == N_PARAMS
    count = harness.load_module(ROOT, "counts", "adam_step")
    assert n * count.BYTES_PER_PARAM / 1e6 == pytest.approx(654.6, abs=0.05)
    s, by = count.bound(n)
    assert by == "bytes"
    assert s * 1e3 == pytest.approx(0.1954, abs=5e-5)


def test_the_launch_check_counts_the_kernel():
    from instantvnr_torch.ops import adam

    assert trace.PORT_KERNELS["adam_step_kernel"] == (
        ("instantvnr_torch.ops.adam", "counter"),)
    before = trace.counter_totals()["adam_step_kernel"]
    adam.counter.launches += 3
    try:
        assert trace.counter_totals()["adam_step_kernel"] == before + 3
    finally:
        adam.counter.launches -= 3


@pytest.mark.parametrize("rc,out,err,expected", [
    (0, "1980 MHz, 0x0000000000000000, 41\n", "",
     "clocks.sm 1980 MHz, clocks_throttle_reasons.active "
     "0x0000000000000000, temperature.gpu 41"),
    (2, "", "Field \"x\" is not a valid field to query.", "not read (Field"),
], ids=["read", "refused"])
def test_the_card_state_line(monkeypatch, rc, out, err, expected):
    def fake(cmd, **kw):
        assert cmd[1] == "--query-gpu=" + ",".join(harness.CARD_STATE)
        return subprocess.CompletedProcess(cmd, rc, out, err)

    monkeypatch.setattr(harness.subprocess, "run", fake)
    assert harness.card_state().startswith(expected)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", training_cells())
def test_a_traced_run_reads_adams_layer(card, cell):
    cmd = harness.load_manifest(ROOT)["command"]
    out = subprocess.run(cmd + ["--workload", cell, "--seed", "4000000031",
                                "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["adam_ms.train"]["value"] > 0, sorted(metrics)
    assert 0 < metrics["adam_roofline.train"]["value"] <= 100
    # the profiled launches agreed with the counters on the first reading
    assert "trace attempt" not in out.stderr, out.stderr[-3000:]
    assert "card at the window's close: clocks.sm" in out.stderr
