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


def _mlp_inputs(cuda, seed, widths, rows):
    rng = np.random.default_rng(seed)
    ws = [torch.tensor(rng.standard_normal((a, b)).astype(np.float32)
                       * np.sqrt(2.0 / a), device=cuda)
          for a, b in zip(widths[:-1], widths[1:])]
    x = torch.tensor(rng.standard_normal((rows, widths[0])).astype(
        np.float32), device=cuda).to(torch.bfloat16)
    return ws, x, rng


@pytest.mark.parametrize("rows", [1001, 262143])
def test_fused_mlp_kernels_ragged_rows(cuda, rows):
    """ModelConfig() widths at row counts that leave a partial tile and a
    partial persistent stride: the inference form, the training forward
    and the backward against their plain versions."""
    cfg = NetworkConfig()
    ws, x, rng = _mlp_inputs(cuda, rows, [64] * 5 + [1], rows)
    got = fm.fused_mlp_apply(ws, x, cfg)
    ref = fm.fused_mlp_reference(ws, x, cfg)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    assert float((got - ref).abs().mean()) <= 1e-3
    z1, zs1 = fm._kernel_train_forward(ws, x, cfg)
    z2, zs2 = fm._plain_train_forward(ws, x, cfg)
    for a, r in ((z1, z2), (zs1, zs2)):
        np.testing.assert_allclose(a.cpu().numpy(), r.cpu().numpy(),
                                   atol=2e-2, rtol=2e-2)
    g = torch.tensor(rng.standard_normal((rows, 1)).astype(np.float32),
                     device=cuda)
    dx1, dw1 = fm._kernel_backward(ws, x, zs2, z2, g, cfg)
    dx2, dw2 = fm._plain_backward(ws, x, zs2, z2, g, cfg)
    for a, r, tol in [(dx1, dx2, 1e-2)] + [(a, r, 1e-3)
                                           for a, r in zip(dw1, dw2)]:
        r = r.float().cpu().numpy()
        np.testing.assert_allclose(a.float().cpu().numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max())


def test_fused_mlp_backward_meets_f64_oracle_at_b65536(cuda):
    """ModelConfig() widths at the training batch B = 2^16 with an L1
    loss's ±1/B cotangent: every dW of the tensor-core backward within
    1e-3 of its largest entry of a float64 oracle built from the plain
    residuals, dx within 1e-2, and two runs give the same bits."""
    cfg = NetworkConfig()
    b = 1 << 16
    ws, x, rng = _mlp_inputs(cuda, 16, [64] * 5 + [1], b)
    g = torch.tensor(np.sign(rng.standard_normal((b, 1))).astype(np.float32)
                     / b, device=cuda)
    z_out, zs = fm._plain_train_forward(ws, x, cfg)
    dx1, dw1 = fm._kernel_backward(ws, x, zs, z_out, g, cfg)
    dx2, dw2 = fm._kernel_backward(ws, x, zs, z_out, g, cfg)
    torch.cuda.synchronize()
    assert torch.equal(dx1, dx2)
    assert all(torch.equal(a, r) for a, r in zip(dw1, dw2))
    # the float64 oracle: the plain chain in float64 from the same residuals
    dx_ref, dw_ref = fm._plain_backward([w.double() for w in ws], x.double(),
                                        zs, z_out, g.double(), cfg)
    for a, r, tol in [(dx1, dx_ref, 1e-2)] + [(a, r, 1e-3)
                                              for a, r in zip(dw1, dw_ref)]:
        r = r.cpu().numpy()
        np.testing.assert_allclose(a.double().cpu().numpy(), r, rtol=0,
                                   atol=tol * np.abs(r).max())


def test_fused_mlp_kernel_chain_end_to_end_at_b65536(cuda):
    """ModelConfig() widths at B = 2^16, each backward on its own forward's
    residuals: the backward kernel on the forward kernel's residuals within
    1e-3 (dW) and 1e-2 (dx) of the plain backward on the same residuals,
    and of the plain forward and backward on the rows where both forwards
    round every activation alike; those that part stay under 1% of B
    (chip_smoke.PARTED_ROWS_MAX)."""
    from instantvnr_torch.ops.mlp import apply_activation

    cfg = NetworkConfig()
    b = 1 << 16
    ws, x, rng = _mlp_inputs(cuda, 17, [64] * 5 + [1], b)
    g = torch.tensor(np.sign(rng.standard_normal((b, 1))).astype(np.float32)
                     / b, device=cuda)
    z1, zs1 = fm._kernel_train_forward(ws, x, cfg)
    z2, zs2 = fm._plain_train_forward(ws, x, cfg)
    h1, h2 = (apply_activation(zs, cfg.activation).to(torch.bfloat16)
              for zs in (zs1, zs2))
    parted = ((h1 != h2) | ((zs1 > 0) != (zs2 > 0))).any(-1).any(0)
    assert int(parted.sum()) <= 0.01 * b
    kept = g * (~parted).float()[:, None]
    pairs = [(fm._kernel_backward(ws, x, zs1, z1, g, cfg),
              fm._plain_backward(ws, x, zs1, z1, g, cfg)),
             (fm._kernel_backward(ws, x, zs1, z1, kept, cfg),
              fm._plain_backward(ws, x, zs2, z2, kept, cfg))]
    torch.cuda.synchronize()
    for (dx1, dw1), (dx2, dw2) in pairs:
        for a, r, tol in [(dx1, dx2, 1e-2)] + [(a, r, 1e-3)
                                               for a, r in zip(dw1, dw2)]:
            r = r.float().cpu().numpy()
            np.testing.assert_allclose(a.float().cpu().numpy(), r, rtol=0,
                                       atol=tol * np.abs(r).max())


def test_decode_blob_gathers_through_k3(cuda):
    """A decode blob of the 2^19 model on the card: network_apply on the
    card's render params launches hash_encode_forward once and fused_mlp
    once, takes no packed tables, and its features match the plain packed
    gather of the same bf16 params within one bf16 step (HASH_FWD_ATOL)."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.metrics import _grid_coords_slab
    from instantvnr_torch.models.network import (NeuralField, network_apply,
                                                 render_params)

    field = NeuralField.from_config(ModelConfig())
    spec = field.spec
    rng = np.random.default_rng(19)
    widths = [spec.n_output_dims] + [64] * 4 + [1]
    params = {"table": torch.tensor(rng.uniform(-1, 1, (
        spec.n_entries, spec.n_features)).astype(np.float32), device=cuda),
        "mlp": [torch.tensor((rng.standard_normal((a, b)) * np.sqrt(
            2.0 / a)).astype(np.float32), device=cuda)
            for a, b in zip(widths[:-1], widths[1:])]}
    rp = render_params(params, field)
    assert rp["table"].dtype == torch.bfloat16 and "packed" not in rp
    coords = _grid_coords_slab((128, 128, 128), 0, 16, cuda)
    before = (he.counter.launches, fm.counter.launches)
    y = network_apply(rp, coords, field)
    torch.cuda.synchronize()
    assert (he.counter.launches - before[0],
            fm.counter.launches - before[1]) == (1, 1)
    packed = he.packed_dense_tables(rp["table"], spec)
    ref_feats = he.hash_encode_packed(rp["table"], packed, coords, spec,
                                      compute_dtype=torch.bfloat16)
    feats = he.hash_encode(rp["table"], coords, spec,
                           compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(feats.float().cpu().numpy(),
                               ref_feats.float().cpu().numpy(), atol=1e-2,
                               rtol=0)
    ref = fm.fused_mlp_reference(rp["mlp"], ref_feats, field.cfg.network)
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    assert float((y - ref).abs().mean()) <= 1e-3


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


def _random_pairs(rng, cuda, d, n, n_in):
    """Per-row pairs (j0 [d, n] int32 in [0, n_in − 2], weights [d, n, 2]
    in [0, 1)) at random: the compositors' resample inputs."""
    return (torch.tensor(rng.integers(0, n_in - 1, (d, n)), dtype=torch.int32,
                         device=cuda),
            torch.tensor(rng.uniform(0.0, 1.0, (d, n, 2)).astype(np.float32),
                         device=cuda))


@pytest.mark.parametrize("lut", [False, True])
def test_composite_kernel_matches_plain(cuda, lut):
    rng = np.random.default_rng(7)
    d, ay, ax, hi, wi = 19, 17, 33, 37, 300

    def t(*shape, lo=0.0, hi_=1.0):
        return torch.tensor(rng.uniform(lo, hi_, shape).astype(np.float32),
                            device=cuda)

    my = _random_pairs(rng, cuda, d, hi, ay)
    mx = _random_pairs(rng, cuda, d, wi, ax)
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
    """Ragged shapes (a frame that is not a multiple of the 32 x 8 tile)
    with smooth fields: the shading amplifies summation-order noise where
    the gradient is tiny or random."""
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
    my = _random_pairs(rng, cuda, d, hi, ay)
    mx = _random_pairs(rng, cuda, d, wi, ax)
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


def _f64_oracle(spec, coords, g, cdt):
    """The table gradient summed in float64: each corner's product of
    weight and cotangent row, rounded to the compute type, added in
    float64 (order does not matter at that precision)."""
    idx, w = he.corner_indices_and_weights(spec, coords)
    b, nl, nf = coords.shape[0], spec.n_levels, spec.n_features
    contrib = (g.to(cdt).reshape(b, nl, 1, nf)
               * w.to(cdt).reshape(b, nl, 8, 1)).double().reshape(-1, nf)
    return torch.zeros((spec.n_entries, nf), dtype=torch.float64,
                       device=coords.device).index_add_(0, idx.reshape(-1),
                                                        contrib)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_features", [2, 8])
@pytest.mark.parametrize("log2", [14, 19])
def test_hash_backward_kernel_at_b65536(cuda, log2, n_features, compute):
    """K4 at the training batch B = 2^16 on the reference schema's 2^14 and
    2^19 layouts: against the plain index_add_ and a float64 oracle at
    chip_smoke's HASH_BWD_ATOL / HASH_BWD_RTOL (5e-4, 1e-4); float
    reductions add in a varying order. One launch per call."""
    spec = he.HashGridSpec.from_config(EncodingConfig(
        log2_hashmap_size=log2, n_features_per_level=n_features))
    cdt = getattr(torch, compute)
    rng = np.random.default_rng(log2 + n_features)
    b = 1 << 16
    coords = torch.tensor(rng.random((b, 3)).astype(np.float32), device=cuda)
    g = torch.tensor(rng.standard_normal((b, spec.n_output_dims)).astype(
        np.float32), device=cuda).to(cdt)
    before = he.backward_counter.launches
    got = he._kernel_backward(spec.n_entries, coords, spec, g, cdt)
    torch.cuda.synchronize()
    assert he.backward_counter.launches == before + 1
    plain = he._plain_backward(spec.n_entries, coords, spec, g, cdt)
    oracle = _f64_oracle(spec, coords, g, cdt)
    for ref in (plain.double(), oracle):
        np.testing.assert_allclose(got.double().cpu().numpy(),
                                   ref.cpu().numpy(), atol=5e-4, rtol=1e-4)


def _rendered_inputs(cuda, cam, width, height, view):
    """The compositor and its inputs for one frame of a 48 x 40 x 56 vorts
    volume, as slab_composite_args builds them on the card: view "plain",
    "shaded", "shadow" or "shaded+shadow" (the four instantiations)."""
    from instantvnr_torch.config import TransferFunctionConfig
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.render import slabmarch as sm
    from instantvnr_torch.render.shadow import shadow_volume_for
    from instantvnr_torch.utils.tfn import bake_transfer_function

    vol = synthetic_volume((48, 40, 56), kind="vorts", device=cuda).data
    tf = bake_transfer_function(TransferFunctionConfig(), device=cuda)
    shade = "shaded" in view
    axis, flipped = sm.principal_axis(cam)
    comp, args, _ = sm.slab_composite_args(
        vol, tf, sm.camera_arrays(cam, cuda), width, height,
        sm.SlabSettings(shading="gradient" if shade else "none"), axis,
        flipped, grad_volumes=sm.compute_gradient_volumes(vol) if shade
        else None,
        shadow_volume=shadow_volume_for(vol, tf, (0.2, 0.9, 0.3))
        if "shadow" in view else None)
    return comp, args, flipped


@pytest.mark.parametrize("view", ["plain", "shaded", "shadow",
                                  "shaded+shadow"])
@pytest.mark.parametrize("camera", ["orbit", "zoomed-out", "flipped"])
def test_banded_compositor_on_rendered_inputs(cuda, camera, view):
    """Each instantiation of the banded kernel template against its plain
    version on the inputs a frame builds: an orbit camera at a ragged
    301 x 157 frame; a zoomed-out camera at 23 x 17 (a pixel steps over 2
    or more texels, so the 2 x 2 windows of neighbours do not touch); a
    camera on
    the far side (the slab axis flipped) at 130 x 97. Tolerances as
    chip_smoke's COMP_ATOL / EXT_ATOL: 1e-4, 2e-4 with shading."""
    from instantvnr_torch.render.camera import Camera

    eye, size = {"orbit": ((20.0, 9.0, -110.0), (301, 157)),
                 "zoomed-out": ((60.0, -40.0, -900.0), (23, 17)),
                 "flipped": ((-15.0, 12.0, 100.0), (130, 97))}[camera]
    cam = Camera(eye=eye, center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                 fovy=40.0)
    comp, args, flipped = _rendered_inputs(cuda, cam, *size, view)
    assert flipped == (camera == "flipped")
    plain = (sc.composite_slabs_reference if view == "plain"
             else sc.composite_slabs_ext_reference)
    counter = sc.counter if view == "plain" else sc.ext_counter
    before = counter.launches
    c1, a1 = comp(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    c2, a2 = plain(*args)
    assert float(a2.max()) > 0.05
    atol = 2e-4 if "shaded" in view else 1e-4
    np.testing.assert_allclose(c1.cpu().numpy(), c2.cpu().numpy(), atol=atol)
    np.testing.assert_allclose(a1.cpu().numpy(), a2.cpu().numpy(), atol=1e-4)
