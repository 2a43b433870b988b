"""CUDA kernels of the port against their plain versions, on the card.

Marked `cuda`: each test skips without an NVIDIA GPU (decided inside the
fixture, never at import). Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda

Shapes are ragged on purpose (row counts that are not a multiple of the
MLP tile, frames that are not a multiple of the compositor tile) so the
masked edges are exercised; main-path shapes are covered by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from instantvnr_torch.config import NetworkConfig
from instantvnr_torch.ops import fused_mlp as fm
from instantvnr_torch.ops import slab_composite as sc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("width,n_hidden,n_in,n_out,act,out_act", [
    (64, 4, 64, 1, "ReLU", "None"),
    (16, 2, 8, 4, "Sine", "None"),
    (32, 1, 40, 1, "Squareplus", "Squareplus"),
    (128, 3, 128, 3, "ReLU", "ReLU"),
])
def test_fused_mlp_kernel_matches_plain(cuda, width, n_hidden, n_in, n_out,
                                        act, out_act):
    rng = np.random.default_rng(width + n_in)
    widths = [n_in] + [width] * n_hidden + [n_out]
    ws = [torch.tensor(rng.standard_normal((a, b)).astype(np.float32)
                       * np.sqrt(2.0 / a), device=cuda)
          for a, b in zip(widths[:-1], widths[1:])]
    x = torch.tensor(rng.standard_normal((1001, n_in)).astype(np.float32),
                     device=cuda)
    cfg = NetworkConfig(n_neurons=width, n_hidden_layers=n_hidden,
                        activation=act, output_activation=out_act)
    before = fm.counter.launches
    got = fm.fused_mlp_apply(ws, x, cfg)
    torch.cuda.synchronize()
    assert fm.counter.launches == before + 1
    ref = fm.fused_mlp_reference(ws, x, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    assert float((got - ref).abs().mean()) <= 1e-3


@pytest.mark.parametrize("lut", [False, True])
def test_composite_kernel_matches_plain(cuda, lut):
    rng = np.random.default_rng(7)
    d, ay, ax, hi, wi = 19, 17, 33, 37, 300

    def t(*shape, lo=0.0, hi_=1.0):
        return torch.tensor(rng.uniform(lo, hi_, shape).astype(np.float32),
                            device=cuda)

    my = t(d, hi, ay, hi_=0.1)
    mx = t(d, wi, ax, hi_=0.1)
    covy = (t(d, hi) > 0.1).float()
    covx = (t(d, wi) > 0.1).float()
    kc = 8
    ctrl = torch.zeros((kc, 8), device=cuda)
    ctrl[:, 0] = torch.tensor(np.sort(rng.uniform(0, 1, kc)), device=cuda)
    ctrl[0, 0], ctrl[-1, 0] = 0.0, 1.0
    ctrl[:, 1:5] = t(kc, 4)
    ctrl[:, 5], ctrl[:, 6] = 0.05, 0.95
    # a smooth LUT: a random one would be steep enough (slope ~1e3) to turn
    # float32 summation-order noise in the resample into 1e-4 differences
    xs = torch.linspace(0.0, 1.0, 1024, device=cuda)[:, None]
    table = (0.5 + 0.4 * torch.sin(6.0 * xs + torch.arange(4, device=cuda))
             if lut else None)
    args = (t(d, ay, ax), my, mx, covy, covx, t(hi, wi, hi_=2.0), ctrl, table)
    c1, a1 = sc.composite_slabs(*args)
    c2, a2 = sc.composite_slabs_reference(*args)
    torch.cuda.synchronize()
    assert float(a2.max()) > 0.05
    np.testing.assert_allclose(c1.cpu().numpy(), c2.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(a1.cpu().numpy(), a2.cpu().numpy(), atol=1e-4)
