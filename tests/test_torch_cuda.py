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

from instantvnr_torch.config import EncodingConfig, NetworkConfig
from instantvnr_torch.ops import fused_mlp as fm
from instantvnr_torch.ops import hash_encoding as he
from instantvnr_torch.ops import iso_sweep as isw
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


@pytest.mark.parametrize("width,n_hidden,n_in,n_out,act,out_act", [
    (64, 4, 64, 1, "ReLU", "None"),
    (16, 2, 8, 4, "Sine", "Squareplus"),
    (32, 0, 40, 1, "ReLU", "Squareplus"),
    (128, 3, 128, 3, "Squareplus", "None"),
])
def test_fused_mlp_training_kernels_match_plain(cuda, width, n_hidden, n_in,
                                                n_out, act, out_act):
    """The training forward (y and the saved pre-activations) and the
    backward (every dW, dx) against the plain training form: outputs at
    the MLP tolerance, dW within 1e-3 and the bf16 dx within 1e-2 of their
    largest entries."""
    rng = np.random.default_rng(width + n_hidden)
    widths = [n_in] + [width] * n_hidden + [n_out]
    ws = [torch.tensor(rng.standard_normal((a, b)).astype(np.float32)
                       * np.sqrt(2.0 / a), device=cuda)
          for a, b in zip(widths[:-1], widths[1:])]
    b = 1001
    x = torch.tensor(rng.standard_normal((b, n_in)).astype(np.float32),
                     device=cuda).to(torch.bfloat16)
    g = torch.tensor(rng.standard_normal((b, n_out)).astype(np.float32),
                     device=cuda)
    cfg = NetworkConfig(n_neurons=width, n_hidden_layers=n_hidden,
                        activation=act, output_activation=out_act)
    grads = {}
    for kernel in (True, False):
        tw = [w.clone().requires_grad_() for w in ws]
        tx = x.clone().requires_grad_()
        before = (fm.train_forward_counter.launches,
                  fm.backward_counter.launches)
        y = (fm.fused_mlp_apply(tw, tx, cfg) if kernel
             else fm.fused_mlp_train_reference(tw, tx, cfg))
        (y * g).sum().backward()
        torch.cuda.synchronize()
        launched = (fm.train_forward_counter.launches - before[0],
                    fm.backward_counter.launches - before[1])
        assert launched == ((1, 1) if kernel else (0, 0))
        grads[kernel] = (y.detach(), tx.grad, [w.grad for w in tw])
    (y1, dx1, dw1), (y2, dx2, dw2) = grads[True], grads[False]
    np.testing.assert_allclose(y1.cpu().numpy(), y2.cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    assert dx1.dtype == torch.bfloat16
    for got, ref, tol in [(dx1, dx2, 1e-2)] + [(a, r, 1e-3)
                                               for a, r in zip(dw1, dw2)]:
        ref = ref.float().cpu().numpy()
        np.testing.assert_allclose(got.float().cpu().numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
    z1, zs1 = fm._kernel_train_forward(ws, x, cfg)
    z2, zs2 = fm._plain_train_forward(ws, x, cfg)
    np.testing.assert_allclose(zs1.cpu().numpy(), zs2.cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(z1.cpu().numpy(), z2.cpu().numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("n_features", [2, 8])
@pytest.mark.parametrize("table_dtype,compute", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_hash_encode_kernels_match_plain(cuda, n_features, table_dtype,
                                         compute):
    """Forward (dense and hashed levels, a ragged batch) against the plain
    gather: f32 at atol 1e-5, bf16 at one bf16 step (the 8-corner sum runs
    in another order). Backward (f32 table) against the plain index_add_
    at atol 5e-4, rtol 1e-4: float atomics add in a varying order."""
    spec = he.HashGridSpec.from_config(EncodingConfig(
        n_levels=6, n_features_per_level=n_features, log2_hashmap_size=12,
        base_resolution=4))
    assert any(spec.level_is_dense) and not all(spec.level_is_dense)
    rng = np.random.default_rng(n_features)
    tdt, cdt = getattr(torch, table_dtype), getattr(torch, compute)
    table = torch.tensor(rng.uniform(-1, 1, (spec.n_entries, n_features)
                                     ).astype(np.float32), device=cuda).to(tdt)
    b = 10007
    c = rng.random((b, 3)).astype(np.float32)
    c[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]
    coords = torch.tensor(c, device=cuda)
    before = he.counter.launches
    got = he.hash_encode(table, coords, spec, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert he.counter.launches == before + 1 and got.dtype == cdt
    ref = he.hash_encode_reference(table, coords, spec, compute_dtype=cdt)
    atol = 1e-5 if compute == "float32" else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol, rtol=0)
    if table_dtype != "float32":
        return
    g = torch.tensor(rng.standard_normal((b, spec.n_output_dims)).astype(
        np.float32), device=cuda).to(cdt)
    grads = []
    for encode in (he.hash_encode, he.hash_encode_reference):
        t = table.clone().requires_grad_()
        encode(t, coords, spec, compute_dtype=cdt).backward(g)
        grads.append(t.grad.cpu().numpy())
    torch.cuda.synchronize()
    np.testing.assert_allclose(grads[0], grads[1], atol=5e-4, rtol=1e-4)


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


def _ext_inputs(cuda, rng, c_f, shadow, lut):
    """Ragged shapes (frame not a multiple of the 4 x 256 tile, slab not a
    multiple of the staging chunks) with smooth fields: the shading
    amplifies summation-order noise where the gradient is tiny or random."""
    d, ay, ax, hi, wi = 19, 17, 33, 37, 300

    def t(*shape, lo=0.0, hi_=1.0):
        return torch.tensor(rng.uniform(lo, hi_, shape).astype(np.float32),
                            device=cuda)

    zz, yy, xx = np.meshgrid(np.linspace(0, 1, d), np.linspace(0, 1, ay),
                             np.linspace(0, 1, ax), indexing="ij")
    value = 0.5 + 0.4 * np.sin(3 * xx + 2 * yy) * np.cos(2 * zz)
    grads = [0.4 * 3 * np.cos(3 * xx + 2 * yy) * np.cos(2 * zz),
             0.4 * 2 * np.cos(3 * xx + 2 * yy) * np.cos(2 * zz),
             -0.4 * 2 * np.sin(3 * xx + 2 * yy) * np.sin(2 * zz)]
    fields = np.stack([value] + grads, axis=1)[:, :c_f]
    my = t(d, hi, ay, hi_=0.1)
    mx = t(d, wi, ax, hi_=0.1)
    kc = 8
    ctrl = torch.zeros((kc, 8), device=cuda)
    ctrl[:, 0] = torch.tensor(np.sort(rng.uniform(0, 1, kc)), device=cuda)
    ctrl[0, 0], ctrl[-1, 0] = 0.0, 1.0
    ctrl[:, 1:5] = t(kc, 4)
    ctrl[:, 5], ctrl[:, 6] = 0.05, 0.95
    xs = torch.linspace(0.0, 1.0, 1024, device=cuda)[:, None]
    table = (0.5 + 0.4 * torch.sin(6.0 * xs + torch.arange(4, device=cuda))
             if lut else None)
    light = np.array([0.4, -0.6, 0.7], np.float32)
    misc = torch.tensor(np.concatenate([[0.3, 0.9], light / np.linalg.norm(
        light), [5.0, -40.0, 9.0], [1.0, 1.3, 0.8]]).astype(np.float32),
        device=cuda)
    return (torch.tensor(fields.astype(np.float32), device=cuda),
            t(d, ay, ax) if shadow else None, my, mx,
            (t(d, hi) > 0.1).float(), (t(d, wi) > 0.1).float(),
            t(hi, wi, hi_=2.0), t(d, wi, lo=-5.0, hi_=40.0),
            t(d, hi, lo=-5.0, hi_=40.0), t(d, lo=0.0, hi_=19.0), ctrl, misc,
            (1, 2, 0), table)


@pytest.mark.parametrize("c_f,shadow,lut", [
    (4, False, False), (4, True, False), (1, True, False), (4, False, True),
    (4, True, True), (1, True, True)])
def test_composite_ext_kernel_matches_plain(cuda, c_f, shadow, lut):
    rng = np.random.default_rng(11 + c_f + 2 * shadow + 4 * lut)
    args = _ext_inputs(cuda, rng, c_f, shadow, lut)
    before = sc.ext_counter.launches
    c1, a1 = sc.composite_slabs_ext(*args)
    torch.cuda.synchronize()
    assert sc.ext_counter.launches == before + 1
    c2, a2 = sc.composite_slabs_ext_reference(*args)
    assert float(a2.max()) > 0.05
    # 2e-4 with shading, as the JAX package holds its shaded kernel to its
    # scan (test_slab_pallas.py:99): cos_nh^40 amplifies summation order
    atol = 2e-4 if c_f == 4 else 1e-4
    np.testing.assert_allclose(c1.cpu().numpy(), c2.cpu().numpy(), atol=atol)
    np.testing.assert_allclose(a1.cpu().numpy(), a2.cpu().numpy(), atol=1e-4)


@pytest.mark.parametrize("iso", [0.35, 0.6])
def test_iso_sweep_kernel_matches_plain(cuda, iso):
    from instantvnr_torch.render.slabmarch import _interp_matrix

    rng = np.random.default_rng(5)
    fields, _, _, _, covy, covx = _ext_inputs(cuda, rng, 4, False, False)[:6]
    d, _, ay, ax = fields.shape
    hi, wi = covy.shape[1], covx.shape[1]
    # banded interpolation matrices, as the slab sweep builds them: each
    # slab magnified a little more about an off-centre epipole
    grow = 1.0 + 0.02 * torch.arange(d, dtype=torch.float32, device=cuda)
    my = _interp_matrix(hi, ay, ay / hi / grow, 0.3 + 0.0 * grow)
    mx = _interp_matrix(wi, ax, ax / wi / grow, 1.1 + 0.0 * grow)
    before = isw.counter.launches
    f1, z1, g1 = isw.iso_sweep(fields, my, mx, covy, covx, iso)
    torch.cuda.synchronize()
    assert isw.counter.launches == before + 1
    f2, z2, g2 = isw.iso_sweep_reference(fields, my, mx, covy, covx, iso)
    assert float(f2.mean()) > 0.05
    # a crossing within float32 noise of the isovalue may flip: allow a few
    agree = f1 == f2
    assert float(agree.float().mean()) >= 0.999
    both = (f1 > 0.5) & (f2 > 0.5)
    np.testing.assert_allclose(z1[both].cpu().numpy(), z2[both].cpu().numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(g1[both].cpu().numpy(), g2[both].cpu().numpy(),
                               atol=1e-3)
