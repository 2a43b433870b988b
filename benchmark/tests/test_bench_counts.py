"""The kernels' bounds in benchmark/counts/ at the shapes of the port's
kernel table (PERF.md, Findings): the reference schema's 2^19 layout at
B = 2^16, in bf16 compute from the float32 master table."""
import json
import os

import pytest
import torch

from benchmark.harness import load_module
from benchmark.reference import fields

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B = 1 << 16
# the kernel table's bounds, ms, and what bounds them
TABLE = {"hash_encode_forward": 0.02089, "hash_encode_backward": 0.04879,
         "fused_mlp_train_forward": 0.02262, "fused_mlp_backward": 0.02523}


@pytest.fixture(scope="module")
def model():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "vnr_ref_2e19.json")) as f:
        return fields.HashGridModel(json.load(f))


@pytest.fixture(scope="module")
def distinct_rows(model):
    gen = torch.Generator().manual_seed(19)
    coords = torch.rand((B, 3), generator=gen)
    idx, _ = fields.grid_corners(model.spec, coords)
    return int(torch.unique(idx).numel())


def test_uniform_coords_touch_the_tables_rows(distinct_rows):
    # the table's 1.90 M distinct rows at B = 2^16 uniform coordinates
    assert abs(distinct_rows - 1.90e6) < 0.01e6


@pytest.mark.parametrize("kernel", sorted(TABLE))
def test_bound_matches_the_kernel_table(kernel, model, distinct_rows):
    count = load_module(ROOT, "counts", kernel)
    spec = model.spec
    if kernel == "hash_encode_forward":
        s, by = count.bound(B, spec.n_levels, spec.n_features, distinct_rows)
    elif kernel == "hash_encode_backward":
        s, by = count.bound(B, spec.n_levels, spec.n_features,
                            spec.n_entries, distinct_rows)
    else:
        s, by = count.bound(B, model.widths())
    assert by == "bytes"
    assert s * 1e3 == pytest.approx(TABLE[kernel], rel=2e-3)


def test_model_flops_per_sample(model):
    # four 64 x 64 matrices and one 64 x 1: 16,448 multiply-adds
    assert model.mlp_macs() == 16448


def test_bounds_grow_with_the_batch(model):
    k1 = load_module(ROOT, "counts", "fused_mlp_train_forward")
    a, _ = k1.bound(B, model.widths())
    b, _ = k1.bound(8 * B, model.widths())
    assert b == pytest.approx(8 * a, rel=1e-3)
