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
    from instantvnr_torch.render.slabmarch import _interp_pairs

    rng = np.random.default_rng(5)
    fields, _, _, _, covy, covx = _ext_inputs(cuda, rng, 4, False, False)[:6]
    d, _, ay, ax = fields.shape
    hi, wi = covy.shape[1], covx.shape[1]
    # the per-row pairs, as the slab sweep builds them: each slab magnified
    # a little more about an off-centre epipole
    grow = 1.0 + 0.02 * torch.arange(d, dtype=torch.float32, device=cuda)
    my = _interp_pairs(hi, ay, ay / hi / grow, 0.3 + 0.0 * grow)
    mx = _interp_pairs(wi, ax, ax / wi / grow, 1.1 + 0.0 * grow)
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
    float64 (order does not matter at that precision). Either layout."""
    idx, w = he._corners(spec, coords)
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


# the rendered-input cameras: (eye, frame size, volume dims (dx, dy, dz))
_CAMERAS = {"orbit": ((20.0, 9.0, -110.0), (301, 157), (48, 40, 56)),
            "zoomed-out": ((60.0, -40.0, -900.0), (23, 17), (48, 40, 56)),
            "flipped": ((-15.0, 12.0, 100.0), (130, 97), (48, 40, 56)),
            # a volume one voxel tall: every slab is one row of voxels
            "one-voxel": ((3.0, 20.0, -40.0), (67, 45), (16, 1, 16))}


def _camera(name):
    from instantvnr_torch.render.camera import Camera

    eye, size, dims = _CAMERAS[name]
    return Camera(eye=eye, center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                  fovy=40.0), size, dims


def _rendered_inputs(cuda, cam, width, height, view, dims=(48, 40, 56)):
    """The compositor and its inputs for one frame of a vorts volume (dx,
    dy, dz), as slab_composite_args builds them on the card: view "plain",
    "shaded", "shadow" or "shaded+shadow" (the four instantiations)."""
    from instantvnr_torch.config import TransferFunctionConfig
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.render import slabmarch as sm
    from instantvnr_torch.render.shadow import shadow_volume_for
    from instantvnr_torch.utils.tfn import bake_transfer_function

    vol = synthetic_volume(dims, kind="vorts", device=cuda).data
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
@pytest.mark.parametrize("camera", ["orbit", "zoomed-out", "flipped",
                                    "one-voxel"])
def test_banded_compositor_on_rendered_inputs(cuda, camera, view):
    """Each instantiation of the banded kernel template against its plain
    version on the inputs a frame builds: an orbit camera at a ragged
    301 x 157 frame; a zoomed-out camera at 23 x 17 (a pixel steps over 2
    or more texels, so the 2 x 2 windows of neighbours do not touch); a
    camera on the far side (the slab axis flipped) at 130 x 97; a volume
    one voxel tall (slabs of one row: each pair reads its sole voxel).
    Tolerances as chip_smoke's COMP_ATOL / EXT_ATOL: 1e-4, 2e-4 with
    shading."""
    cam, size, dims = _camera(camera)
    comp, args, flipped = _rendered_inputs(cuda, cam, *size, view, dims)
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


@pytest.mark.parametrize("camera", ["orbit", "zoomed-out", "flipped",
                                    "one-voxel"])
def test_iso_sweep_on_rendered_inputs(cuda, camera):
    """The sweep against its plain version on the inputs an isosurface
    frame builds (render/isosurf.py::slab_iso_args, the per-row pairs), at
    the compositor cases' cameras and frames, the isovalue the volume's
    median: found agrees on 99.9% of the pixels at least and hit_z, hit_g
    within 1e-3 where both hit, as test_iso_sweep_kernel_matches_plain
    (chip_smoke's ISO_ATOL)."""
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.render import slabmarch as sm
    from instantvnr_torch.render.isosurf import IsoSettings, slab_iso_args

    cam, (w, h), dims = _camera(camera)
    vol = synthetic_volume(dims, kind="vorts", device=cuda).data
    axis, flipped = sm.principal_axis(cam)
    assert flipped == (camera == "flipped")
    args, _ = slab_iso_args(vol, sm.compute_gradient_volumes(vol), w, h,
                            IsoSettings(), axis, flipped,
                            sm.camera_arrays(cam, cuda))
    iso = float(vol.median())
    before = isw.counter.launches
    f1, z1, g1 = isw.iso_sweep(*args, iso)
    torch.cuda.synchronize()
    assert isw.counter.launches == before + 1
    f2, z2, g2 = isw.iso_sweep_reference(*args, iso)
    assert float(f2.sum()) >= 3  # the surface is hit
    assert float((f1 == f2).float().mean()) >= 0.999
    both = (f1 > 0.5) & (f2 > 0.5)
    np.testing.assert_allclose(z1[both].cpu().numpy(), z2[both].cpu().numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(g1[both].cpu().numpy(), g2[both].cpu().numpy(),
                               atol=1e-3)


@pytest.mark.parametrize("table_dtype,compute", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("n_features", [1, 2, 4, 8])
@pytest.mark.parametrize("log2", [14, 19])
@pytest.mark.parametrize("b", [1 << 16, 50021])
def test_hash_forward_kernel_at_schema_layouts(cuda, b, log2, n_features,
                                               table_dtype, compute):
    """K3 on the reference schema's 2^14 and 2^19 layouts (8 levels, F
    features) at the training batch B = 2^16 and a ragged B, from an f32
    or a bf16 table, against the plain gather: f32 at atol 1e-5, bf16 at
    chip_smoke's HASH_FWD_ATOL (1e-2, one bf16 step: the 8-corner sum in
    another order). Samples on the cube's faces and corners take the dense
    levels' wrap at the upper face. One launch per call."""
    spec = he.HashGridSpec.from_config(EncodingConfig(
        log2_hashmap_size=log2, n_features_per_level=n_features))
    rng = np.random.default_rng(log2 + n_features + b)
    tdt, cdt = getattr(torch, table_dtype), getattr(torch, compute)
    table = torch.tensor(rng.uniform(-1, 1, (spec.n_entries, n_features)
                                     ).astype(np.float32), device=cuda).to(tdt)
    c = rng.random((b, 3)).astype(np.float32)
    c[:8] = [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)]
    coords = torch.tensor(c, device=cuda)
    before = he.counter.launches
    got = he.hash_encode(table, coords, spec, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert he.counter.launches == before + 1 and got.dtype == cdt
    assert got.shape == (b, spec.n_output_dims)
    ref = he.hash_encode_reference(table, coords, spec, compute_dtype=cdt)
    atol = 1e-5 if compute == "float32" else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol, rtol=0)


def _wavefront_rays(device, w, h, dims=(128, 128, 128)):
    """The rays of a w × h frame over a vorts volume (the bench camera),
    voxel space, with the ground truth's macrocell."""
    from instantvnr_torch import api
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.render.renderer import _frame_rays
    from instantvnr_torch.render.slabmarch import camera_arrays

    sv = api.SimpleVolume.synthetic(dims, "vorts", device=device)
    d = max(dims)
    cam = Camera(eye=(0.15 * d, 0.1 * d, -2.0 * d), center=(0.0, 0.0, 0.0),
                 up=(0.0, 1.0, 0.0), fovy=45.0)
    org, dirn, t0, t1, light, lo, hi = _frame_rays(
        w, h, camera_arrays(cam, device),
        torch.tensor(dims, dtype=torch.float32, device=device),
        torch.tensor([0.7, 0.9, 0.4], device=device), sv.transform)
    return sv, org, dirn, t0, t1, light


@pytest.mark.parametrize("w,h", [(512, 512), (300, 167)])
@pytest.mark.parametrize("k,skips", [(8, 8), (16, 8), (8, 1), (16, 1)])
def test_raymarch_emit_kernel_matches_plain(cuda, w, h, k, skips):
    """raymarch_emit against the plain _emit_samples on the rays of a
    frame (R = 2^18 at 512², and a ragged R), three supersteps each from
    the carried state: equal bit for bit (IEEE division, floorf, no FMA, the
    same order of operations). One launch per call."""
    from instantvnr_torch.render import raymarch as rm

    sv, org, dirn, t0, t1, _ = _wavefront_rays(cuda, w, h)
    state = rm.init_ray_state(t0, t1)
    emitted = 0
    for _ in range(3):
        before = rm.emit_counter.launches
        got = rm.raymarch_emit(org, dirn, t1, state, sv.macrocell, 1.0, k,
                               skips)
        torch.cuda.synchronize()
        assert rm.emit_counter.launches == before + 1
        ref = rm._emit_samples(org, dirn, t1, state, sv.macrocell, 1.0, k,
                               skips)
        for g, r in zip(got[0] + got[1:], ref[0] + ref[1:]):
            assert torch.equal(g, r)
        emitted += int(ref[3].sum())
        state = state._replace(t=ref[0][0], t_cell_end=ref[0][1],
                               ss=ref[0][2])
    assert emitted > 1000


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("w,h", [(64, 64), (300, 167)])
@pytest.mark.parametrize("k", [1, 8, 16, 32, 40])
def test_raymarch_emit_kernel_edges(cuda, k, w, h, dead):
    """The edges of the staged design: K = 1 (a tile of one slot), 8, 16,
    32 (the most slots staged at once) and 40 (two chunks, each stored a
    row segment a ray); R a multiple of the block of
    128 rays (64²) and not (300 × 167, a ragged last block); with `dead`,
    whole blocks of rays whose range is empty (t_far at or before t) and
    a dead stretch that ends inside a block. Three supersteps from the
    carried state, all seven outputs bit for bit the plain version's."""
    from instantvnr_torch.render import raymarch as rm

    sv, org, dirn, t0, t1, _ = _wavefront_rays(cuda, w, h)
    t_far = t1.clone()
    if dead:
        t_far[128:640] = t0[128:640]
        t_far[1000:1100] = -1.0
    state = rm.init_ray_state(t0, t_far)
    emitted = 0
    for _ in range(3):
        got = rm.raymarch_emit(org, dirn, t_far, state, sv.macrocell, 1.0,
                               k, 8)
        torch.cuda.synchronize()
        ref = rm._emit_samples(org, dirn, t_far, state, sv.macrocell, 1.0,
                               k, 8)
        for g, r in zip(got[0] + got[1:], ref[0] + ref[1:]):
            assert torch.equal(g, r)
        if dead:
            assert not ref[3][128:640].any()
        emitted += int(ref[3].sum())
        state = state._replace(t=ref[0][0], t_cell_end=ref[0][1],
                               ss=ref[0][2])
    assert emitted > 100


@pytest.mark.parametrize("shading,neural", [("none", True), ("ssh", False)])
def test_wavefront_frame_on_card_matches_cpu(cuda, shading, neural):
    """A NEURAL_WAVEFRONT frame (a 2-level model, seeded weights) and a
    REFERENCE_SSH frame of a 32³ volume, 48², on the card against the
    CPU, from the same rays and jitter: the emission is exact on both, so
    the frames part only by the sample values: the fused MLP's tolerance
    (atol 2e-2, mean 1e-3) for the network, 1e-4 for the trilinear ground
    truth (pow and exp of the two devices' libraries)."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import (NeuralField,
                                                 params_from_numpy,
                                                 render_params)
    from instantvnr_torch.render import raymarch as rm
    from instantvnr_torch.render.renderer import (make_neural_sample_fn,
                                                  reference_sample_fn)

    frames = []
    jitter = torch.rand(48 * 48, generator=torch.Generator().manual_seed(3))
    field = NeuralField.from_config(ModelConfig(
        encoding=EncodingConfig(n_levels=2, n_features_per_level=4,
                                log2_hashmap_size=10),
        network=NetworkConfig(n_neurons=16, n_hidden_layers=2)))
    rng = np.random.default_rng(8)
    params_np = {
        "table": rng.uniform(-0.5, 0.5, (field.spec.n_entries, 4)
                             ).astype(np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((8, 16), (16, 16), (16, 1))]}
    for dev in ("cpu", cuda):
        sv, org, dirn, t0, t1, light = _wavefront_rays("cpu", 48, 48,
                                                       (32, 32, 32))
        if dev != "cpu":
            sv = type(sv)(sv.volume, device=dev)
            org, dirn, t0, t1, light = (x.to(dev) for x in
                                        (org, dirn, t0, t1, light))
        if neural:
            ctx = render_params(params_from_numpy(params_np, dev), field)
            fn = make_neural_sample_fn(field)
            sample = lambda p, fn=fn, ctx=ctx: fn(ctx, p)  # noqa: E731
        else:
            vol = sv.volume.data
            sample = lambda p, vol=vol: reference_sample_fn(vol, p)  # noqa
        before = rm.emit_counter.launches
        rgba = rm.raymarch(sample, org, dirn, t0, t1, sv.macrocell, sv.tf,
                           jitter.to(dev), rm.RaymarchSettings(
                               shading=shading, n_iters=8),
                           light_dir=light, scale=sv.transform.scale)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert rm.emit_counter.launches > before
        frames.append(rgba.cpu().numpy())
    cpu, card = frames
    assert cpu[:, 3].max() > 0.05
    if neural:
        np.testing.assert_allclose(card, cpu, atol=2e-2, rtol=0)
        assert np.abs(card - cpu).mean() <= 1e-3
    else:
        np.testing.assert_allclose(card, cpu, atol=1e-4, rtol=0)


# -- the path tracer and the brick pool --------------------------------------


def _random_pool(rng, ss, dtype, n_cells=(5, 4, 3)):
    """A LUT over n_cells macrocells with some cells missing and a random
    corner-packed pool behind it."""
    from instantvnr_torch.ops.brick_sample import _brick_edge

    mx, my, mz = n_cells
    n = mx * my * mz
    lut = np.full(n, -1, np.int32)
    held = rng.permutation(n)[: n * 2 // 3]
    lut[held] = np.arange(held.size, dtype=np.int32)
    packed = rng.uniform(-1.0, 2.0, (held.size * _brick_edge(ss) ** 3, 8))
    return (torch.from_numpy(lut), torch.from_numpy(packed).to(dtype),
            (mx * 16 - 3, my * 16 - 7, mz * 16), (mx, my, mz))


@pytest.mark.parametrize("n", [1 << 18, 1001])
@pytest.mark.parametrize("ss", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_brick_sample_kernel_matches_plain(cuda, n, ss, dtype):
    """brick_sample equals its plain version bit for bit, misses (cells the
    pool does not hold: 0.0) and the domain's faces and corners
    included."""
    from instantvnr_torch.ops import brick_sample as bs

    rng = np.random.default_rng(n + ss)
    lut, packed, dims, mcd = _random_pool(rng, ss, dtype)
    p = rng.random((n, 3)).astype(np.float32)
    p[:8] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 0.25],
             [0.5, 0.5, 1], [1, 0.5, 0], [0, 0, 1], [0.999999, 0, 1]]
    p = torch.from_numpy(p)
    ref = bs.brick_sample_reference(lut, packed, p, dims, mcd, ss)
    before = bs.counter.launches
    got = bs.brick_sample(lut.to(cuda), packed.to(cuda), p.to(cuda), dims,
                          mcd, ss)
    torch.cuda.synchronize()
    assert bs.counter.launches == before + 1
    card_plain = bs.brick_sample_reference(lut.to(cuda), packed.to(cuda),
                                           p.to(cuda), dims, mcd, ss)
    assert torch.equal(got, card_plain)
    assert (ref == 0).any() and (ref != 0).any()
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-6)


def _random_pt_state(rng, r, dims=(40, 36, 48)):
    """A tracker state of r rays inside (and around) a volume of `dims`:
    shadow rays, inactive rays and late scatter counts included."""
    dx, dy, dz = dims
    org = rng.uniform(0.0, 1.0, (r, 3)) * np.array([dx, dy, dz])
    d = rng.standard_normal((r, 3))
    d[: r // 50, 0] = 0.0  # axis-parallel rays
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.0, 5.0, r)
    t_far = t + rng.uniform(0.0, 60.0, r)
    f = np.float32
    return [torch.from_numpy(a) for a in (
        org.astype(f), d.astype(f), t.astype(f), t_far.astype(f),
        rng.exponential(1.0, r).astype(f),
        rng.uniform(0.0, 1.0, (r, 3)).astype(f),
        rng.uniform(0.0, 1.0, (r, 3)).astype(f),
        rng.integers(0, 8, r).astype(np.int32), rng.random(r) < 0.4,
        rng.random(r) < 0.9)]


def _pt_scene(dims, lut_tf):
    from instantvnr_torch.accel import macrocell as mcmod
    from instantvnr_torch.config import TransferFunctionConfig
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.utils.tfn import bake_transfer_function

    cfg = TransferFunctionConfig()
    if lut_tf:
        knots = np.linspace(0.0, 1.0, 70)
        alphas = np.random.default_rng(4).uniform(0.0, 0.9, 70)
        cfg = TransferFunctionConfig(
            colors=((0.0, 0.2, 0.3, 0.9), (0.5, 0.9, 0.6, 0.1),
                    (1.0, 1.0, 0.2, 0.2)),
            alphas=tuple((float(a), float(b)) for a, b in zip(knots, alphas)))
    vol = synthetic_volume(dims, kind="vorts", device="cpu")
    tf = bake_transfer_function(cfg, device="cpu")
    return vol, tf, mcmod.build(vol.data, vol.dims, tf)


@pytest.mark.parametrize("r", [1 << 18, 1001])
@pytest.mark.parametrize("cell_skips,density", [(0, 1.0), (2, 1.0),
                                                (2, 2.5)])
def test_pt_track_kernel_matches_plain(cuda, r, cell_skips, density):
    """pt_track equals its plain version bit for bit on every ray (NaN-free
    outputs compared by their bits)."""
    from instantvnr_torch.ops import pathtrace as opt

    dims = (40, 36, 48)
    _, _, mc = _pt_scene(dims, False)
    st = _random_pt_state(np.random.default_rng(r + cell_skips), r, dims)
    args = st[:5] + [mc.max_opacity]
    ref = opt.pt_track_reference(*[a.to(cuda) for a in args], dims, density,
                                 cell_skips)
    before = opt.track_counter.launches
    got = opt.pt_track(*[a.to(cuda) for a in args], dims, density,
                       cell_skips)
    torch.cuda.synchronize()
    assert opt.track_counter.launches == before + 1
    for g, w in zip(got, ref):
        assert torch.equal(g, w)
    cpu = opt.pt_track_reference(*args, dims, density, cell_skips)
    for g, w in zip(got, cpu):
        assert torch.equal(g.cpu(), w)
    assert got[3].any() and (~got[3]).any() and got[4].any()


@pytest.mark.parametrize("r", [1 << 18, 1001])
@pytest.mark.parametrize("lut_tf", [False, True])
def test_pt_resolve_kernel_matches_plain(cuda, r, lut_tf):
    """pt_resolve against its plain version on the card: the decisions
    (scatter counts, shadow and active flags) equal, the floats equal bit
    for bit but for log1pf / sinf / cosf, where two builds of the CUDA math
    library may round one ulp apart (rtol 1e-6)."""
    from instantvnr_torch.ops import pathtrace as opt
    from instantvnr_torch.ops.slab_composite import pack_controls, pack_lut
    from instantvnr_torch.ops.trilinear import sample_volume

    dims = (40, 36, 48)
    vol, tf, mc = _pt_scene(dims, lut_tf)
    rng = np.random.default_rng(r + lut_tf)
    st = _random_pt_state(rng, r, dims)
    track = opt.pt_track_reference(*st[:5], mc.max_opacity, dims, 1.0, 2)
    values = sample_volume(vol.data, track[5])
    u = torch.from_numpy(rng.random((6, r)).astype(np.float32))
    consts = torch.tensor([0.4, 0.5, -0.76, 1.0, 0.9, 0.8, 1.0, 0.5, 2.0,
                           2.0, 0.0, 1.0, 38.0, 36.0, 40.0])
    args = (st[0], st[1], st[3], *st[5:], *track[:5], values, u,
            pack_controls(tf), pack_lut(tf), consts)
    on_card = [None if a is None else a.to(cuda) for a in args]
    ref = opt.pt_resolve_reference(*on_card, 1.0, 1.5)
    before = opt.resolve_counter.launches
    got = opt.pt_resolve(*on_card, 1.0, 1.5)
    torch.cuda.synchronize()
    assert opt.resolve_counter.launches == before + 1
    for g, w in zip(got, ref):
        if g.dtype in (torch.bool, torch.int32):
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    assert (got[7] > st[7].to(cuda)).any()  # hits
    assert (got[8] != st[8].to(cuda)).any()  # shadow rays fired / resolved
    assert (~got[9] & st[9].to(cuda)).any()  # paths ended


@pytest.mark.parametrize("mode", ["PATHTRACE_REFERENCE", "PATHTRACE_DECODED",
                                  "PATHTRACE_NEURAL"])
def test_pathtrace_frame_on_card_matches_cpu(cuda, mode):
    """A 24² frame of each path-tracing mode (vorts 32³, a 2-level model
    with seeded weights) on the card against the CPU, from one uniform
    stream drawn on the CPU and copied to both: at least 99% of the pixels
    within 1e-5 (a path parts where log1pf / sinf / cosf, or the network's
    bf16 rounding, differ between the devices)."""
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import params_from_numpy
    from instantvnr_torch.ops import brick_sample as bs
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.ops import pathtrace as opt
    from instantvnr_torch.render.camera import Camera

    class Stream:
        def __init__(self):
            self.g = torch.Generator().manual_seed(11)

        def tau(self, r, device):
            return torch.rand(r, generator=self.g).to(device)

        def event(self, r, device):
            return torch.rand((6, r), generator=self.g).to(device)

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=2,
                                              n_features_per_level=4,
                                              log2_hashmap_size=10),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=2))
    rng = np.random.default_rng(8)
    n_entries = NeuralField.from_config(cfg).spec.n_entries
    params_np = {
        "table": rng.uniform(-0.5, 0.5, (n_entries, 4)).astype(np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((8, 16), (16, 16), (16, 1))]}
    jitter = torch.rand((24 * 24, 2),
                        generator=torch.Generator().manual_seed(5))
    frames = []
    for dev in ("cpu", "cuda"):
        sv = api.SimpleVolume.synthetic((32, 32, 32), "vorts", device=dev)
        nv = api.NeuralVolume(cfg, sv, device=dev)
        nv.params = params_from_numpy(params_np, dev)
        r = api.VNRenderer(nv, 24, 24, api.RenderMode[mode])
        r.set_camera(Camera(eye=(5, 4, -60), center=(0, 0, 0),
                            up=(0, 1, 0), fovy=45))
        r._impl._next_jitter = lambda j=jitter.to(dev): j
        r._impl._uniforms = Stream
        counts = (opt.track_counter.launches, bs.counter.launches)
        r.render()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert opt.track_counter.launches > counts[0]
            assert (bs.counter.launches > counts[1]) == (
                mode != "PATHTRACE_NEURAL")
        frames.append(r.mapframe())
    cpu, card = frames
    assert cpu[..., 3].max() > 0
    share = float((np.abs(card - cpu).max(-1) <= 1e-5).mean())
    assert share >= 0.99, share


def _smooth_grid(shape, seed):
    """A smooth random [sz, sy, sx] grid: noise averaged along each axis."""
    g = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
    for axis in range(3):
        g = 0.5 * g + 0.25 * (g.roll(1, axis) + g.roll(-1, axis))
    return g


@pytest.mark.parametrize("shape,z0", [((9, 13, 17), 0), ((2, 5, 3), 7),
                                      ((33, 40, 31), 96), ((17, 64, 64), 16)])
@pytest.mark.parametrize("where", ["median", "low", "outside"])
def test_isosurface_kernels_match_plain(cuda, shape, z0, where):
    """mt_count + mt_emit against the plain dense emission and its masked
    gather, on the card and on the CPU: tris and ids bit for bit, in the
    same order; one launch when the slab has no triangle, two otherwise."""
    from instantvnr_torch.ops import isosurface as mt

    grid = _smooth_grid(shape, sum(shape))
    iso = {"median": float(grid.median()), "low": float(grid.min()) + 1e-3,
           "outside": 2.0}[where]
    g = grid.to(cuda)
    before = mt.counter.launches
    tris, ids = mt.extract_slab(g, iso, z0)
    torch.cuda.synchronize()
    k = tris.shape[0]
    assert mt.counter.launches == before + (2 if k else 1)
    assert (k == 0) == (where == "outside")
    pt, pv, pi = mt._extract_slab_reference(g, iso, z0)
    ct, ci = mt.extract_slab(grid, iso, z0)
    for ref_t, ref_i in ((pt[pv], pi[pv]), (ct.to(cuda), ci.to(cuda))):
        assert torch.equal(tris.view(torch.int32), ref_t.view(torch.int32))
        assert torch.equal(ids, ref_i)


def _checkerboard(shape):
    z, y, x = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    return torch.from_numpy(((x + y + z) % 2).astype(np.float32))


@pytest.mark.parametrize("case", ["checkerboard", "ragged_tail"])
def test_isosurface_kernels_dense_and_ragged(cuda, case):
    """The edges of the one-thread-a-triangle design: a checkerboard grid,
    where every cell emits 12 triangles (whole blocks of 256 cells write
    3,072 triangles each, in 12 rounds), and a slab whose few live cells
    all lie in its last, ragged block (4 × 16 × 18 cells: 4 whole blocks
    and 128). tris and ids bit for bit and in order against the plain
    version, on the card and on the CPU; two launches."""
    from instantvnr_torch.ops import isosurface as mt

    if case == "checkerboard":
        grid, z0, want = _checkerboard((9, 40, 33)), 5, 8 * 39 * 32 * 12
    else:
        grid, z0 = torch.zeros((5, 17, 19)), 64
        grid[4, 15:, 10:] = 1.0
        want = None
    g = grid.to(cuda)
    before = mt.counter.launches
    tris, ids = mt.extract_slab(g, 0.5, z0)
    torch.cuda.synchronize()
    assert mt.counter.launches == before + 2
    if want is not None:
        assert tris.shape[0] == want
    pt, pv, pi = mt._extract_slab_reference(g, 0.5, z0)
    ct, ci = mt.extract_slab(grid, 0.5, z0)
    assert tris.shape[0] > 0
    for ref_t, ref_i in ((pt[pv], pi[pv]), (ct.to(cuda), ci.to(cuda))):
        assert torch.equal(tris.view(torch.int32), ref_t.view(torch.int32))
        assert torch.equal(ids, ref_i)


def test_extract_isosurface_on_card_matches_cpu(cuda):
    """The welded mesh of a grid and of a network (slabs decoded on the
    card) equal the CPU's extraction of the same grid, the card's decode
    of the network included."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.metrics import decode_volume
    from instantvnr_torch.models.network import (NeuralField,
                                                 params_from_numpy,
                                                 render_params)
    from instantvnr_torch.ops import isosurface as mt

    grid = _smooth_grid((40, 36, 30), 3)
    iso = float(grid.median())
    cv, cf = mt.extract_isosurface(grid, iso, slab=16)
    gv, gf = mt.extract_isosurface(grid.to(cuda), iso, slab=16)
    assert len(cf) > 0
    np.testing.assert_array_equal(gf, cf)
    np.testing.assert_array_equal(gv.view(np.int32), cv.view(np.int32))
    cfg = ModelConfig(encoding=EncodingConfig(n_levels=2,
                                              n_features_per_level=4,
                                              log2_hashmap_size=10),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=2))
    field = NeuralField.from_config(cfg)
    rng = np.random.default_rng(4)
    params = params_from_numpy({
        "table": rng.uniform(-1, 1, (field.spec.n_entries, 4)).astype(
            np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((8, 16), (16, 16), (16, 1))]}, "cuda")
    dims = (30, 36, 40)
    dec = decode_volume(field, render_params(params, field), dims)
    iso = float(dec.median())
    nv_, nf = mt.extract_isosurface_network(field, params, dims, iso)
    dv, df = mt.extract_isosurface(dec.cpu(), iso, slab=16)
    assert len(nf) > 0
    np.testing.assert_array_equal(nf, df)
    np.testing.assert_array_equal(nv_.view(np.int32), dv.view(np.int32))


def test_train_out_of_core_pinned_batches(cuda, monkeypatch):
    """The card's double-buffered path hands each step the batch the
    sampler wrote for it, in order, though the sampler fills the other
    pinned buffer while the step's copy may be in flight."""
    from instantvnr_torch.models import trainer

    class Counting:
        """A sampler writing batch i as coords = i + u and values = i."""

        def __init__(self):
            self.i = 0

        def sample_into(self, coords, values):
            coords[...] = self.i + np.random.default_rng(self.i).random(
                coords.shape, np.float32)
            values[...] = self.i
            self.i += 1

    seen = []

    def record(field, state, coords, targets):
        # a copy on the card, in stream order after the batch's own copy;
        # the spin keeps the card behind the host
        assert coords.device.type == "cuda"
        seen.append((coords.clone(), targets.clone()))
        torch.cuda._sleep(1_000_000)
        return state

    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField

    monkeypatch.setattr(trainer, "train_step_hostbatch", record)
    field = NeuralField.from_config(ModelConfig(encoding=EncodingConfig(
        n_levels=2, n_features_per_level=2, log2_hashmap_size=8)))
    state = trainer.create_train_state(field, 0, "cuda")
    sampler = Counting()
    trainer.train_out_of_core(field, sampler, state, 12, 4096)
    torch.cuda.synchronize()
    assert sampler.i == 12 and len(seen) == 12
    for i, (c, v) in enumerate(seen):
        np.testing.assert_array_equal(
            c.cpu().numpy(),
            i + np.random.default_rng(i).random((4096, 3), np.float32))
        assert (v.cpu().numpy() == i).all()


# -- the facade's setters ----------------------------------------------------


@pytest.mark.parametrize("setter", ["tf_config", "tf_handle",
                                    "framebuffer_size"])
def test_facade_setters_on_card_match_cpu(cuda, setter):
    """A DECODED_SLAB frame after set_transfer_function (a config and a
    TransferFunctionObject) or set_framebuffer_size, on the card against
    the CPU: a 4-level 2^12 model with seeded weights on vorts 32³, every
    pixel within 5e-3 (the decode's bf16 MLP rounds in other places; the
    compositor sums in another order), as chip_smoke.py's small slice."""
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig, TransferFunctionConfig
    from instantvnr_torch.models.network import params_from_numpy
    from instantvnr_torch.render.camera import Camera

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=4,
                                              n_features_per_level=2,
                                              log2_hashmap_size=12),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=2))
    rng = np.random.default_rng(11)
    tf = TransferFunctionConfig(
        colors=((0.0, 1.0, 0.1, 0.0), (1.0, 0.9, 0.8, 0.1)),
        alphas=((0.0, 0.0), (0.4, 0.5), (1.0, 0.9)))
    frames = []
    for dev in ("cpu", cuda):
        sv = api.SimpleVolume.synthetic((32, 32, 32), "vorts", device=dev)
        nv = api.NeuralVolume(cfg, sv, device=dev)
        if not frames:
            spec = nv.field.spec
            params_np = {
                "table": rng.uniform(-1, 1, (spec.n_entries, spec.n_features)
                                     ).astype(np.float32),
                "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])
                         ).astype(np.float32)
                        for s in ((8, 16), (16, 16), (16, 1))]}
        nv.params = params_from_numpy(params_np, dev)
        r = api.VNRenderer(nv, 40, 37)
        r.set_camera(Camera(eye=(6.0, 5.0, -70.0), center=(0, 0, 0),
                            up=(0, 1, 0), fovy=45.0))
        if setter == "tf_config":
            r.set_transfer_function(tf)
        elif setter == "tf_handle":
            r.set_transfer_function(api.TransferFunctionObject(tf))
        else:
            r.set_framebuffer_size(33, 50)
        r.render()
        frames.append(r.mapframe())
    cpu, card = frames
    assert card.shape == cpu.shape == ((50, 33, 4) if setter ==
                                       "framebuffer_size" else (37, 40, 4))
    assert cpu[..., 3].max() > 0.05
    np.testing.assert_allclose(card, cpu, atol=5e-3, rtol=0)


# -- the twelfth slice: paired hash, the differentiable march, fV-SRN --------


@pytest.mark.parametrize("n_features", [2, 4, 8])
@pytest.mark.parametrize("table_dtype,compute", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_paired_hash_kernels_match_plain(cuda, n_features, table_dtype,
                                         compute):
    """K3 and K4 in the paired layout (dense and hashed levels, a ragged
    batch) against the plain paired gather and index_add_, at
    test_hash_encode_kernels_match_plain's tolerances; each launches the
    paired form once, never the tcnn one."""
    spec = he.HashGridSpec.from_config(EncodingConfig(
        n_levels=6, n_features_per_level=n_features, log2_hashmap_size=12,
        base_resolution=4, hash_variant="paired"))
    assert spec.paired and any(spec.level_is_dense)
    rng = np.random.default_rng(n_features + 40)
    tdt, cdt = getattr(torch, table_dtype), getattr(torch, compute)
    table = torch.tensor(rng.uniform(-1, 1, (spec.n_entries, n_features)
                                     ).astype(np.float32), device=cuda).to(tdt)
    b = 10007
    c = rng.random((b, 3)).astype(np.float32)
    c[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]
    coords = torch.tensor(c, device=cuda)
    before = (he.counter.launches, he.paired_counter.launches)
    got = he.hash_encode(table, coords, spec, compute_dtype=cdt)
    torch.cuda.synchronize()
    assert (he.counter.launches, he.paired_counter.launches) == (
        before[0], before[1] + 1)
    ref = he.hash_encode_reference(table, coords, spec, compute_dtype=cdt)
    atol = 1e-5 if compute == "float32" else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol, rtol=0)
    if table_dtype != "float32":
        return
    g = torch.tensor(rng.standard_normal((b, spec.n_output_dims)).astype(
        np.float32), device=cuda).to(cdt)
    before = (he.backward_counter.launches,
              he.paired_backward_counter.launches)
    grads = []
    for encode in (he.hash_encode, he.hash_encode_reference):
        t = table.clone().requires_grad_()
        encode(t, coords, spec, compute_dtype=cdt).backward(g)
        grads.append(t.grad.cpu().numpy())
    torch.cuda.synchronize()
    assert (he.backward_counter.launches,
            he.paired_backward_counter.launches) == (before[0], before[1] + 1)
    np.testing.assert_allclose(grads[0], grads[1], atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("log2", [14, 19])
def test_paired_hash_backward_at_b65536(cuda, log2):
    """The paired K4 at the training batch on the reference schema's
    layouts against the plain index_add_ and a float64 oracle (5e-4,
    1e-4)."""
    spec = he.HashGridSpec.from_config(EncodingConfig(
        log2_hashmap_size=log2, hash_variant="paired"))
    rng = np.random.default_rng(log2 + 7)
    b = 1 << 16
    coords = torch.tensor(rng.random((b, 3)).astype(np.float32), device=cuda)
    g = torch.tensor(rng.standard_normal((b, spec.n_output_dims)).astype(
        np.float32), device=cuda)
    got = he._kernel_backward(spec.n_entries, coords, spec, g, torch.float32)
    torch.cuda.synchronize()
    plain = he._plain_backward(spec.n_entries, coords, spec, g,
                               torch.float32)
    oracle = _f64_oracle(spec, coords, g, torch.float32)
    for ref in (plain.double(), oracle):
        np.testing.assert_allclose(got.double().cpu().numpy(),
                                   ref.cpu().numpy(), atol=5e-4, rtol=1e-4)


def _fixed_steps_loss(dev, neural):
    """tests/test_torch_differentiable.py's losses on `dev`: sum(rgba²) of
    a 16² fixed_steps frame of vorts 32³, through a 4-level network's
    training params or the sampled volume. → (loss, leaves)."""
    from instantvnr_torch.accel import macrocell as mcmod
    from instantvnr_torch.config import (ModelConfig,
                                         TransferFunctionConfig)
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.models.network import (NeuralField,
                                                 params_from_numpy)
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.render.raymarch import RaymarchSettings
    from instantvnr_torch.render.renderer import (_render_frame,
                                                  make_neural_sample_fn,
                                                  reference_sample_fn)
    from instantvnr_torch.render.slabmarch import camera_arrays
    from instantvnr_torch.utils.tfn import bake_transfer_function

    vol = synthetic_volume((32,) * 3, kind="vorts", device=dev).data
    tf = bake_transfer_function(TransferFunctionConfig(), device=dev)
    mc = mcmod.build(vol, (32, 32, 32), tf)
    settings = RaymarchSettings(n_iters=4, max_supersteps=24,
                                fixed_steps=True)
    cam = camera_arrays(Camera(eye=(10.0, 20.0, -60.0), center=(0, 0, 0),
                               up=(0, 1, 0), fovy=40.0), dev)
    jitter = torch.rand(256, generator=torch.Generator().manual_seed(5)).to(
        dev)
    if neural:
        field = NeuralField.from_config(ModelConfig(
            encoding=EncodingConfig(n_levels=4, n_features_per_level=4,
                                    log2_hashmap_size=12, base_resolution=4),
            network=NetworkConfig(n_neurons=16, n_hidden_layers=2)))
        rng = np.random.default_rng(6)
        p = params_from_numpy({
            "table": rng.uniform(-0.5, 0.5, (field.spec.n_entries, 4)
                                 ).astype(np.float32),
            "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
                np.float32) for s in ((16, 16), (16, 16), (16, 1))]}, dev)
        leaves = [p["table"], *p["mlp"]]
        fn, ctx = make_neural_sample_fn(field), p
    else:
        leaves = [vol.clone()]
        fn, ctx = reference_sample_fn, leaves[0]
    for t in leaves:
        t.requires_grad_(True)
    _, frame = _render_frame(fn, 16, 16, settings,
                             ctx, cam, mc, tf, jitter, None, 1)
    return (frame ** 2).sum(), leaves


@pytest.mark.parametrize("neural", [True, False], ids=["network", "volume"])
def test_differentiable_march_on_card_matches_cpu(cuda, neural):
    """The fixed_steps frame's gradients on the card against the CPU's
    plain forms: with the network, through K3, K1's training form, K2 and
    K4 (counted), never the inference K1, each gradient within 5e-2 of its
    largest entry (the fused MLP's tolerance carried through the blend);
    with the volume, 1e-4."""
    from instantvnr_torch.render import raymarch as rm

    counters = (he.counter, he.backward_counter, fm.counter,
                fm.train_forward_counter, fm.backward_counter,
                rm.emit_counter)
    grads = []
    for dev in ("cpu", cuda):
        before = [c.launches for c in counters]
        loss, leaves = _fixed_steps_loss(dev, neural)
        loss.backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            got = [c.launches - b for c, b in zip(counters, before)]
            if neural:
                # one emission a superstep; one sample (K3, K1 training
                # form, and their backward) a superstep with valid slots
                k3, k4, k1, k1t, k2, emit = got
                assert k1 == 0 and emit == 24
                assert 0 < k3 == k1t == k2 == k4 <= emit
            else:
                assert got[:5] == [0] * 5 and got[5] == 24
        grads.append([t.grad.cpu().numpy() for t in leaves])
    for cpu, card in zip(*grads):
        assert np.abs(cpu).max() > 0 and np.isfinite(card).all()
        tol = 5e-2 if neural else 1e-4
        np.testing.assert_allclose(card, cpu, rtol=0,
                                   atol=tol * np.abs(cpu).max())


def test_edge_pixel_frame_on_card_matches_cpu(cuda):
    """The 10 × 7 DECODED_SLAB frame whose pixel (6, 5) sees a ray graze
    the volume's top face: the card's coverage test is the CPU's (both in
    float64), so the frames agree and the pixel stays 0."""
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import params_from_numpy
    from instantvnr_torch.render.camera import Camera

    frames = []
    rng = np.random.default_rng(4)
    p = None
    for dev in ("cpu", cuda):
        sv = api.SimpleVolume.synthetic((16,) * 3, "vorts", device=dev)
        nv = api.NeuralVolume(ModelConfig(
            encoding=EncodingConfig(n_levels=2, n_features_per_level=4,
                                    log2_hashmap_size=10),
            network=NetworkConfig(n_neurons=16, n_hidden_layers=2)), sv,
            device=dev)
        if p is None:
            p = {"table": rng.uniform(-0.5, 0.5, (nv.field.spec.n_entries, 4)
                                      ).astype(np.float32),
                 "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])
                          ).astype(np.float32)
                         for s in ((8, 16), (16, 16), (16, 1))]}
        nv.params = params_from_numpy(p, dev)
        r = api.VNRenderer(nv, 10, 7)
        r.set_camera(Camera(eye=(3.0, 2.5, -38.0), center=(0.0, 0.0, 0.0),
                            up=(0.0, 1.0, 0.0), fovy=45.0))
        r.render()
        frames.append(r.mapframe())
    cpu, card = frames
    assert cpu[..., 3].max() > 0.05
    np.testing.assert_array_equal(cpu[5, 6], 0.0)
    np.testing.assert_array_equal(card[5, 6], 0.0)
    np.testing.assert_allclose(card, cpu, atol=5e-3, rtol=0)


def test_fvsrn_on_card_matches_cpu(cuda):
    """fV-SRN is plain PyTorch on both devices (no kernel in either
    package): its forward and gradients on the card against the CPU,
    float32 compute at 1e-4 (sums in another order), bf16 at the decode's
    tolerance."""
    from instantvnr_torch.models.fvsrn import FvsrnConfig, FvsrnField
    from instantvnr_torch.models.network import network_apply

    for compute, atol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        field = FvsrnField(FvsrnConfig(latent_res=(9, 8, 7),
                                       compute_dtype=compute))
        gen = torch.Generator().manual_seed(2)
        p = field.init(gen, "cpu")
        c = torch.rand((20011, 3), generator=gen)
        outs, grads = [], []
        for dev in ("cpu", cuda):
            q = {"table": p["table"].detach().to(dev).requires_grad_(),
                 "mlp": [w.detach().to(dev).requires_grad_()
                         for w in p["mlp"]]}
            y = network_apply(q, c.to(dev), field)
            y.square().sum().backward()
            outs.append(y.detach().cpu().numpy())
            grads.append([t.grad.cpu().numpy()
                          for t in [q["table"], *q["mlp"]]])
        np.testing.assert_allclose(outs[1], outs[0], atol=atol, rtol=0)
        for a, b in zip(*grads):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=10 * atol * np.abs(a).max())



# -- the parallel slice: the traced hash kernels, TP and DP on the card -----


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("split", [False, True])
def test_traced_hash_kernels_at_shard_levels_match_plain(cuda, shard, split):
    """K3 and K4 over one model shard's level rows of the 2^19 schema
    (offsets rebased into its padded table) against the plain per-level
    gather and scatter, at B = 2^16: the forward at the hash grid's
    tolerance, the gradient table at atol 5e-4, rtol 1e-4."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.parallel import tp

    field = NeuralField.from_config(ModelConfig())
    spec = field.spec
    lps, e_max = tp.tp_layout(field, 2)
    lp = tp.local_level_params(tp.shard_level_params(field, 2), shard)
    caps = tp.level_caps(field, 2)
    gen = torch.Generator(device=cuda).manual_seed(shard)
    table = torch.rand((e_max, spec.n_features), generator=gen,
                       device=cuda) * 2 - 1
    b = 1 << 16
    coords = torch.rand((b, 3), generator=gen, device=cuda)
    g = torch.randn((b, lps * spec.n_features), generator=gen,
                    device=cuda).to(torch.bfloat16)
    grads = []
    for where in (cuda, torch.device("cpu")):
        t = table.to(where).clone().requires_grad_()
        c = coords.to(where)
        k3, k4 = he.counter.launches, he.backward_counter.launches
        if split:
            y = he.hash_encode_traced_splitgrad(t, c, lp, caps,
                                                spec.n_features,
                                                torch.bfloat16)
        else:
            y = he.hash_encode_traced(t, c, lp, lps, spec.n_features,
                                      torch.bfloat16)
        y.backward(g.to(where))
        launched = (he.counter.launches - k3,
                    he.backward_counter.launches - k4)
        assert launched == ((1, 1) if where.type == "cuda" else (0, 0))
        grads.append((y.detach().float().cpu(), t.grad.cpu()))
    (y_k, g_k), (y_p, g_p) = grads
    assert float((y_k - y_p).abs().max()) <= 1e-2
    np.testing.assert_allclose(g_k.numpy(), g_p.numpy(), atol=5e-4,
                               rtol=1e-4)


def _small_tp_plan(seed=11, b=4096):
    import torch_parallel_ranks as ranks

    from instantvnr_torch.parallel import tp

    field = ranks.small_field()
    spec, net = field.spec, field.cfg.network
    rng = np.random.default_rng(seed)
    widths = ([spec.n_output_dims] + [net.n_neurons] * net.n_hidden_layers
              + [1])
    params = {"table": torch.from_numpy(rng.uniform(
                  -0.5, 0.5, (spec.n_entries, spec.n_features)
                  ).astype(np.float32)),
              "mlp": [torch.from_numpy((rng.standard_normal((a, c))
                                        * np.sqrt(2.0 / a)).astype(
                                            np.float32))
                      for a, c in zip(widths[:-1], widths[1:])]}
    coords = rng.random((b, 3), np.float32)
    targets = rng.random((b, 1), np.float32)
    split = tp.split_params_tp(field, params, 2)
    return {"params": ranks._tree_np(params),
            "tp_split": ranks._tree_np(split), "batch": (coords, targets)}


def test_tp_forward_and_gradient_on_card_match_cpu(cuda):
    """Two gloo ranks on the card, tp = 2: the forward and the merged
    gradient on the card against the same ranks on the CPU (the forward at
    the MLP tolerance, each gradient within 1e-2 of its largest entry),
    K3 and K4 once each a rank on the card."""
    import torch_parallel_ranks as ranks

    from instantvnr_torch.parallel import mesh as pm

    plan = _small_tp_plan()
    outs = pm.spawn(ranks.tp_card_vs_cpu, 2, plan, device="cuda",
                    backend="gloo", timeout=300)
    for o in outs:
        card, cpu = o["cuda"], o["cpu"]
        assert (card["k3"], card["k4"], cpu["k3"], cpu["k4"]) == (1, 1, 0, 0)
        np.testing.assert_allclose(card["forward"], cpu["forward"],
                                   atol=2e-2, rtol=2e-2)
        assert float(card["loss"]) == pytest.approx(float(cpu["loss"]),
                                                    rel=1e-3)
        for a, b in zip(torch.utils._pytree.tree_leaves(card["grads"]),
                        torch.utils._pytree.tree_leaves(cpu["grads"])):
            assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max()


def test_dp_world1_step_on_card(cuda):
    """A world-1 NCCL group: the DP host-batch step equals
    trainer.train_step_hostbatch bit for bit on one gradient (K4's float
    atomics sum in a varying order, so the two steps share the first's
    gradient), and the reduce alone returns its input bit for bit (the
    mean divides by 1); one K3, K1 training form, K2 and K4 a step, one
    all-reduce."""
    import torch_parallel_ranks as ranks

    from instantvnr_torch.parallel import mesh as pm

    plan = _small_tp_plan()
    (out,) = pm.spawn(ranks.dp_world1_on_card, 1, plan, device="cuda",
                      timeout=300)
    assert all(out["same"]), out["same"]
    assert all(out["reduce_same"]), out["reduce_same"]
    assert out["single_launches"] == [1, 1, 1, 1]
    assert out["hostbatch_launches"] == [1, 1, 1, 1]
    assert out["train_launches"] == [1, 1, 1, 1]
    assert out["pins"] == ({"all_reduce": 1}, {"all_reduce": 1})


# -- the compacted wavefront and tracker (render/compaction.py) -------------


def _compaction_leaves(cuda, m, g):
    """16 leaves of 12-, 4- and 1-byte rows (float32 triples, float32,
    bool, int32)."""
    makers = (lambda: torch.rand((m, 3), generator=g, device=cuda),
              lambda: torch.rand(m, generator=g, device=cuda),
              lambda: torch.rand(m, generator=g, device=cuda) < 0.5,
              lambda: torch.randint(0, 1 << 30, (m,), generator=g,
                                    device=cuda, dtype=torch.int32))
    return [makers[i % 4]() for i in range(16)]


# the edge sizes: ragged tiles, a 768² frame's rays, the select form's n;
# all live and none live
@pytest.mark.parametrize("m,live,back", [
    (1 << 18, 0.45, True), (1000003, 0.1, True), (777, 0.9, False),
    (1, 0.45, True), (31, 0.45, True), (1023, 0.45, False),
    (1024, 0.45, True), (1025, 0.45, True), (589824, 0.45, True),
    (1 << 21, 0.45, False), (1025, 1.0, True), (1025, 0.0, True),
    (589824, 1.0, False), (589824, 0.0, True)])
def test_compaction_kernels_match_plain(cuda, m, live, back):
    """compact_rows (a stable partition of 16 leaves of 1-, 4- and 12-byte
    rows, the count and the order, with and without the copy back) and
    scatter_rows (on the partition's order and on a random permutation)
    against their plain versions, bit for bit, one launch a call."""
    from instantvnr_torch.ops import compaction as ops

    g = torch.Generator(device=cuda).manual_seed(m)
    leaves = _compaction_leaves(cuda, m, g)
    flags = torch.rand(m, generator=g, device=cuda) < live
    res = {}
    for name, fn in (("k", ops.compact_rows), ("p", ops.compact_rows_reference)):
        ls = [x.clone() for x in leaves]
        sc = [torch.empty_like(x) for x in ls]
        count = torch.zeros(1, dtype=torch.int32, device=cuda)
        order = torch.zeros(m, dtype=torch.int32, device=cuda)
        before = ops.compact_counter.launches
        fn(flags, ls, sc, count=count, order=order, copy_back=back)
        res[name] = (ls + sc if back else sc, count, order,
                     ops.compact_counter.launches - before)
    torch.cuda.synchronize()
    assert res["k"][3] == 1 and res["p"][3] == 0
    for a, b in zip(res["k"][0], res["p"][0]):
        assert torch.equal(a, b)
    assert torch.equal(res["k"][1], res["p"][1])
    assert torch.equal(res["k"][2], res["p"][2])
    assert int(res["k"][1]) == int(flags.sum())
    for perm in (res["p"][2],
                 torch.randperm(m, generator=g, device=cuda).to(torch.int32)):
        outs = {k: [torch.empty_like(x) for x in leaves] for k in "kp"}
        before = ops.scatter_counter.launches
        ops.scatter_rows(perm, leaves, outs["k"])
        assert ops.scatter_counter.launches == before + 1
        ops.scatter_rows_reference(perm, leaves, outs["p"])
        torch.cuda.synchronize()
        for a, b in zip(outs["k"], outs["p"]):
            assert torch.equal(a, b)


def test_select_rows_matches_plain(cuda):
    """The select form at a 512² frame's m·K = 2^21 slots: the 12-byte
    positions, the order and the count bit for bit the plain version's."""
    from instantvnr_torch.ops import compaction as ops

    n = 1 << 21
    g = torch.Generator(device=cuda).manual_seed(21)
    mask = torch.rand(n, generator=g, device=cuda) < 0.3
    pos = torch.rand((n, 3), generator=g, device=cuda)
    before = ops.compact_counter.launches
    got = ops.select_rows(mask, pos)
    assert ops.compact_counter.launches == before + 1
    want = (torch.empty_like(pos),
            torch.empty(n, dtype=torch.int32, device=cuda),
            torch.empty(1, dtype=torch.int32, device=cuda))
    ops.compact_rows_reference(mask, [pos], [want[0]], count=want[2],
                               order=want[1])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_compaction_graph_replay(cuda):
    """compact_rows (the flags one of its leaves, copy back, order and
    count) twice and select_rows captured in one CUDA graph, replayed three
    times with new rows and flags copied in: each replay bit for bit the
    plain versions on the same inputs (the workspace starts clean)."""
    from instantvnr_torch.ops import compaction as ops

    m, n = 100003, 300007
    g = torch.Generator(device=cuda).manual_seed(5)
    leaves = _compaction_leaves(cuda, m, g)
    scratch = [torch.empty_like(x) for x in leaves]
    count = torch.empty(1, dtype=torch.int32, device=cuda)
    order = torch.empty(m, dtype=torch.int32, device=cuda)
    mask = torch.zeros(n, dtype=torch.bool, device=cuda)
    pos = torch.zeros((n, 3), device=cuda)
    sel = []

    def program():
        for _ in range(2):
            ops.compact_rows(leaves[2], leaves, scratch, count=count,
                             order=order, copy_back=True)
        sel[:] = ops.select_rows(mask, pos)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        program()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        program()
    for share in (0.2, 0.7, 0.0):
        fresh = _compaction_leaves(cuda, m, g)
        fresh[2] = torch.rand(m, generator=g, device=cuda) < share
        for x, y in zip(leaves, fresh):
            x.copy_(y)
        mask.copy_(torch.rand(n, generator=g, device=cuda) < 1 - share)
        pos.copy_(torch.rand((n, 3), generator=g, device=cuda))
        wsc = [torch.empty_like(x) for x in fresh]
        wcount = torch.empty(1, dtype=torch.int32, device=cuda)
        worder = torch.empty(m, dtype=torch.int32, device=cuda)
        for _ in range(2):
            ops.compact_rows_reference(fresh[2], fresh, wsc, count=wcount,
                                       order=worder, copy_back=True)
        wsel = (torch.empty_like(pos),
                torch.empty(n, dtype=torch.int32, device=cuda),
                torch.empty(1, dtype=torch.int32, device=cuda))
        ops.compact_rows_reference(mask, [pos], [wsel[0]], count=wsel[2],
                                   order=wsel[1])
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(leaves + scratch, fresh + wsc):
            assert torch.equal(a, b)
        assert torch.equal(count, wcount) and torch.equal(order, worder)
        for a, b in zip(sel, wsel):
            assert torch.equal(a, b)


def test_count_forms_match_the_whole_batch(cuda):
    """K3, K1 (network_apply_chunked over two chunks) and brick_sample with
    a device-side count: the rows below it bit for bit the call without a
    count, the chunks past it skipped."""
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import network_apply_chunked
    from instantvnr_torch.models.network import render_params
    from instantvnr_torch.ops.brick_sample import brick_sample
    from instantvnr_torch.render.brickcache import build_brick_cache

    sv = api.SimpleVolume.synthetic((64, 64, 64), "vorts", device=cuda)
    nv = api.NeuralVolume(ModelConfig(), sv, device=cuda)
    params = render_params(nv.params, nv.field)
    g = torch.Generator(device=cuda).manual_seed(3)
    p = torch.rand((300001, 3), generator=g, device=cuda)
    count = torch.tensor([123457], dtype=torch.int32, device=cuda)
    whole = network_apply_chunked(params, p, nv.field, chunk=1 << 17)
    part = network_apply_chunked(params, p, nv.field, chunk=1 << 17,
                                 count=count)
    assert torch.equal(part[:123457], whole[:123457])
    ctx = build_brick_cache(nv.field, params, sv.macrocell)
    whole = brick_sample(ctx["lut"], ctx["packed"], p, ctx["dims"],
                         ctx["mcdims"])
    part = brick_sample(ctx["lut"], ctx["packed"], p, ctx["dims"],
                        ctx["mcdims"], count=count)
    assert torch.equal(part[:123457], whole[:123457])


@pytest.mark.parametrize("k,s", [(4, 2), (8, 3)])
def test_raymarch_emit_samples_per_slot(cuda, k, s):
    """raymarch_emit with samples_per_slot against the plain emission,
    bit for bit, three supersteps from the carried state."""
    from instantvnr_torch.render import raymarch as rm

    sv, org, dirn, t0, t1, _ = _wavefront_rays(cuda, 300, 167)
    state = rm.init_ray_state(t0, t1)
    for _ in range(3):
        got = rm.raymarch_emit(org, dirn, t1, state, sv.macrocell, 1.0, k, 8,
                               s)
        ref = rm._emit_samples(org, dirn, t1, state, sv.macrocell, 1.0, k, 8,
                               s)
        torch.cuda.synchronize()
        for a, b in zip(got[0] + got[1:], ref[0] + ref[1:]):
            assert torch.equal(a, b)
        state = state._replace(t=ref[0][0], t_cell_end=ref[0][1],
                               ss=ref[0][2])


@pytest.mark.parametrize("mode,policy", [
    ("NEURAL_WAVEFRONT", "none"), ("NEURAL_WAVEFRONT", "auto"),
    ("NEURAL_WAVEFRONT_GRADIENT", "none"), ("REFERENCE_RAYMARCH", None),
    ("NEURAL_WAVEFRONT_SSH", "auto")])
def test_compacted_frames_match_masked_on_card(cuda, mode, policy):
    """A 256² frame sequence through the compacted path (serialized,
    replayed, then fused as one CUDA graph) against the masked march with
    the same jitters: bit for bit in every frame."""
    import dataclasses

    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.render.camera import Camera

    sv = api.SimpleVolume.synthetic((128, 128, 128), "vorts", device=cuda)
    nv = api.NeuralVolume(ModelConfig(), sv, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    jit = [torch.rand(256 * 256, generator=g, device=cuda) for _ in range(5)]
    frames = {}
    for compact in (False, True):
        kw = {} if policy is None else {"streaming_cache": policy}
        r = api.VNRenderer(nv, 256, 256, api.RenderMode[mode], **kw)
        if not compact:
            r._impl.settings = dataclasses.replace(r._impl.settings,
                                                   compact=False)
        r.set_camera(Camera(eye=(40.0, 30.0, -260.0), center=(0, 0, 0),
                            up=(0, 1, 0), fovy=45))
        it = iter(jit)
        r._impl._next_jitter = lambda it=it: next(it)
        fs = []
        for _ in jit:
            r.render()
            fs.append(r.mapframe())
        frames[compact] = fs
    for a, b in zip(frames[True], frames[False]):
        np.testing.assert_array_equal(a, b)


def test_compacted_pathtrace_parity_on_card(cuda):
    """Under the bucket floor nothing compacts: the compacted tracker's
    first frame (its events in CUDA graphs drawing from the card's
    generator) equals the masked tracker's bit for bit from one seed."""
    import dataclasses

    from instantvnr_torch import api

    sv = api.SimpleVolume.synthetic((64, 64, 64), "vorts", device=cuda)
    frames = {}
    for compact in (False, True):
        r = api.VNRenderer(sv, 64, 64, api.RenderMode.PATHTRACE_REFERENCE)
        r._impl.settings = dataclasses.replace(r._impl.settings,
                                               compact=compact)
        r.render()
        frames[compact] = r.mapframe()
    np.testing.assert_array_equal(frames[True], frames[False])


# -- the hash encoding's coordinate gradient, the frame in its rays ----------


def _lattice_coords(spec, per_level=4):
    """float32 coords with one axis exactly on a lattice point of each
    level (p·scale rounds to k + 0.5, so x = p·scale + 0.5 is an integer
    and floor picks the cell whose lower face it is)."""
    rng = np.random.default_rng(11)
    out = []
    for scale in spec.scales:
        s = np.float32(scale)
        found = 0
        while found < per_level:
            kk = np.float32(int(rng.integers(0, max(int(s), 1))) + 0.5)
            p0 = np.float32(kk / s)
            cand = p0 + np.arange(-64, 65, dtype=np.float32) * np.spacing(p0)
            hit = cand[cand * s == kk]
            if hit.size:  # else the product's step passed over k + 0.5
                c = rng.random(3).astype(np.float32)
                c[found % 3] = hit[0]
                out.append(c)
                found += 1
    return np.stack(out)


def _coords_grad_inputs(cuda, spec, n, seed, cdt):
    """Coords [n, 3] (the grid's corners and faces, lattice points, then
    uniform) and a cotangent [n, L·F] in the compute type, on the card."""
    rng = np.random.default_rng(seed)
    c = rng.random((n, 3)).astype(np.float32)
    if n > 4:
        c[:4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]
        lat = _lattice_coords(spec)[:n - 4]
        c[4:4 + len(lat)] = lat
    g = rng.standard_normal((n, spec.n_output_dims)).astype(np.float32)
    return (torch.tensor(c, device=cuda),
            torch.tensor(g, device=cuda).to(cdt))


@pytest.mark.parametrize("variant", ["tcnn", "paired"])
@pytest.mark.parametrize("n_features", [1, 2, 4, 8])
@pytest.mark.parametrize("table_dtype,compute", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_hash_coords_kernel_matches_plain(cuda, variant, n_features,
                                          table_dtype, compute):
    """hash_encode_coords_backward on an 8-level 2^19 layout (dense and
    hashed levels) at n = 1, 1001 and 2^16 against the plain
    _plain_coords_backward on the same card tensors, within 1e-5 of the
    largest entry (float32 sums in another order). Coords that require
    grad launch it once a backward and never K4; a table that requires
    grad as well adds K4, with the coords' gradient unchanged."""
    spec = he.HashGridSpec.from_config(EncodingConfig(
        n_features_per_level=n_features, hash_variant=variant))
    tdt, cdt = getattr(torch, table_dtype), getattr(torch, compute)
    gen = torch.Generator(device=cuda).manual_seed(n_features)
    table = (torch.rand((spec.n_entries, n_features), generator=gen,
                        device=cuda) * 2 - 1).to(tdt)
    coords_c = he.coords_counter
    k4_c = he.paired_backward_counter if spec.paired else he.backward_counter
    for n in (1, 1001, 1 << 16):
        coords, g = _coords_grad_inputs(cuda, spec, n, n + n_features, cdt)
        ref = he._plain_coords_backward(table, coords, spec, g, cdt)
        for table_grad in (False, True):
            t = table.clone().requires_grad_(table_grad)
            c = coords.clone().requires_grad_()
            before = (coords_c.launches, k4_c.launches)
            he.hash_encode(t, c, spec, compute_dtype=cdt).backward(g)
            torch.cuda.synchronize()
            assert (coords_c.launches - before[0],
                    k4_c.launches - before[1]) == (1, int(table_grad))
            got = c.grad.cpu().numpy()
            want = ref.cpu().numpy()
            assert np.isfinite(got).all() and np.abs(want).max() > 0
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


def test_hash_coords_kernel_bits_repeat(cuda):
    """No atomics: two launches on the same inputs give the same bits."""
    for variant in ("tcnn", "paired"):
        spec = he.HashGridSpec.from_config(EncodingConfig(
            hash_variant=variant))
        gen = torch.Generator(device=cuda).manual_seed(3)
        table = torch.rand((spec.n_entries, spec.n_features), generator=gen,
                           device=cuda) * 2 - 1
        coords, g = _coords_grad_inputs(cuda, spec, 1 << 16, 5,
                                        torch.bfloat16)
        a = he._kernel_coords_backward(table, coords, spec, g, torch.bfloat16)
        b = he._kernel_coords_backward(table, coords, spec, g, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("split", [False, True])
def test_traced_coords_kernel_at_shard_levels(cuda, split):
    """The traced forms' coordinate gradient over a model shard's level
    rows of the 2^19 schema (the split-grad form's true gradient, where
    JAX gives zero) against the plain per-level version on the CPU, within
    1e-5 of the largest entry; one coordinate launch, no K4 with the table
    frozen."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.parallel import tp

    field = NeuralField.from_config(ModelConfig())
    spec = field.spec
    lps, e_max = tp.tp_layout(field, 2)
    lp = tp.local_level_params(tp.shard_level_params(field, 2), 1)
    caps = tp.level_caps(field, 2)
    gen = torch.Generator(device=cuda).manual_seed(21)
    table = torch.rand((e_max, spec.n_features), generator=gen,
                       device=cuda) * 2 - 1
    b = 1 << 16
    coords = torch.rand((b, 3), generator=gen, device=cuda)
    g = torch.randn((b, lps * spec.n_features), generator=gen,
                    device=cuda).to(torch.bfloat16)
    grads = []
    for where in (cuda, torch.device("cpu")):
        c = coords.to(where).clone().requires_grad_()
        before = (he.coords_counter.launches, he.backward_counter.launches)
        if split:
            y = he.hash_encode_traced_splitgrad(table.to(where), c, lp, caps,
                                                spec.n_features,
                                                torch.bfloat16)
        else:
            y = he.hash_encode_traced(table.to(where), c, lp, lps,
                                      spec.n_features, torch.bfloat16)
        y.backward(g.to(where))
        assert (he.coords_counter.launches - before[0],
                he.backward_counter.launches - before[1]) == (
                    (1, 0) if where.type == "cuda" else (0, 0))
        grads.append(c.grad.cpu().numpy())
    assert np.abs(grads[1]).max() > 0
    np.testing.assert_allclose(grads[0], grads[1], rtol=0,
                               atol=1e-5 * np.abs(grads[1]).max())


def test_compact_rows_refuses_a_short_scratch_leaf_on_card(cuda):
    """A scratch leaf of other than m rows raises before the launch, the
    ValueError of the CPU, and nothing is written."""
    from instantvnr_torch.ops import compaction as ops

    g = torch.Generator(device=cuda).manual_seed(4)
    active = torch.rand(1000, generator=g, device=cuda) < 0.4
    leaf = torch.rand((1000, 3), generator=g, device=cuda)
    before = leaf.clone()
    for rows in (1, 999, 1001):
        scratch = torch.zeros((rows, 3), device=cuda)
        launches = ops.compact_counter.launches
        with pytest.raises(ValueError, match="1000 rows"):
            ops.compact_rows(active, [leaf], [scratch], copy_back=True)
        assert ops.compact_counter.launches == launches
        assert not scratch.any()
    assert torch.equal(leaf, before)


def _ray_grad_loss(dev, trainable, compute="bfloat16", sampled_at=None):
    """The differentiable-march scene of _fixed_steps_loss (the network)
    differentiated in its rays' origins and directions → (loss, [org,
    dirn] leaves, the params' leaves). The rays are made on the CPU on
    both devices: the frame is only piecewise smooth in them (a step's
    quantization, a skipped cell), so a ray made 1 ulp apart on the card
    can take other steps and another gradient. `sampled_at`: a list that
    receives the emission kernel's launch count at each sample call."""
    from functools import partial

    from instantvnr_torch.accel import macrocell as mcmod
    from instantvnr_torch.config import (ModelConfig, NetworkConfig,
                                         TransferFunctionConfig)
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.models.network import (NeuralField,
                                                 params_from_numpy)
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.render.raymarch import RaymarchSettings, raymarch
    from instantvnr_torch.render.renderer import (_frame_rays,
                                                  make_neural_sample_fn)
    from instantvnr_torch.render.slabmarch import camera_arrays
    from instantvnr_torch.render.transform import default_transform
    from instantvnr_torch.utils.tfn import bake_transfer_function

    vol = synthetic_volume((32,) * 3, kind="vorts", device=dev).data
    tf = bake_transfer_function(TransferFunctionConfig(), device=dev)
    mc = mcmod.build(vol, (32, 32, 32), tf)
    settings = RaymarchSettings(n_iters=4, max_supersteps=24,
                                fixed_steps=True)
    cpu = torch.device("cpu")
    org, dirn, t0, t1, light, _, _ = (x.to(dev) for x in _frame_rays(
        16, 16, camera_arrays(Camera(eye=(10.0, 20.0, -60.0),
                                     center=(0, 0, 0), up=(0, 1, 0),
                                     fovy=40.0), cpu),
        torch.tensor([32.0] * 3), torch.tensor(settings.light_dir),
        default_transform((32, 32, 32), cpu)))
    jitter = torch.rand(256, generator=torch.Generator().manual_seed(5)).to(
        dev)
    field = NeuralField.from_config(ModelConfig(
        encoding=EncodingConfig(n_levels=4, n_features_per_level=4,
                                log2_hashmap_size=12, base_resolution=4),
        network=NetworkConfig(n_neurons=16, n_hidden_layers=2),
        compute_dtype=compute))
    rng = np.random.default_rng(6)
    p = params_from_numpy({
        "table": rng.uniform(-0.5, 0.5, (field.spec.n_entries, 4)
                             ).astype(np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((16, 16), (16, 16), (16, 1))]}, dev)
    params = [p["table"], *p["mlp"]]
    for t in params:
        t.requires_grad_(trainable)
    rays = [org.detach().clone().requires_grad_(),
            dirn.detach().clone().requires_grad_()]
    fn = partial(make_neural_sample_fn(field), p)
    if sampled_at is not None:
        from instantvnr_torch.render import raymarch as rm

        def fn(*a, _fn=fn):
            sampled_at.append(rm.emit_counter.launches)
            return _fn(*a)
    rgba = raymarch(fn, *rays, t0, t1, mc, tf, jitter, settings,
                    light_dir=light)
    return (rgba ** 2).sum(), rays, params


@pytest.mark.parametrize("trainable", [False, True])
def test_ray_gradient_on_card_matches_cpu(cuda, trainable):
    """The fixed_steps frame differentiated in its rays on the card (the
    emission kernels, K3, K1's training form, K2 and the coordinate
    kernel) against the CPU's plain forms, within 5e-2 of each gradient's
    largest entry (the fused MLP's tolerance carried through the blend).
    Launches: one emission a superstep, one emission backward for each
    emission up to the last superstep that sampled (a later one's outputs
    reach only the final marching state, which the frame does not read,
    so autograd never runs its backward), one coordinate pass a sampling
    superstep, K4 only with the params trainable."""
    from instantvnr_torch.render import raymarch as rm

    counters = (rm.emit_counter, he.counter, fm.train_forward_counter,
                fm.backward_counter, he.coords_counter, he.backward_counter,
                fm.counter, rm.emit_backward_counter)
    grads = []
    for dev in ("cpu", cuda):
        before = [c.launches for c in counters]
        sampled_at = []
        loss, rays, params = _ray_grad_loss(dev, trainable,
                                            sampled_at=sampled_at)
        loss.backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            emit, k3, k1t, k2, kc, k4, k1, emit_bwd = [
                c.launches - b for c, b in zip(counters, before)]
            assert emit == 24 and k1 == 0
            assert 0 < k3 == k1t == k2 == kc <= emit
            assert k4 == (kc if trainable else 0)
            assert emit_bwd == sampled_at[-1] - before[0] >= kc
        grads.append([t.grad.cpu().numpy() for t in rays]
                     + ([t.grad.cpu().numpy() for t in params] if trainable
                        else []))
        assert trainable or all(t.grad is None for t in params)
    for cpu, card in zip(*grads):
        assert np.abs(cpu).max() > 0 and np.isfinite(card).all()
        np.testing.assert_allclose(card, cpu, rtol=0,
                                   atol=5e-2 * np.abs(cpu).max())


# -- the emission's backward -------------------------------------------------


def _emit_backward_both(org, dirn, t_far, state, mc, k, skips, s, grads,
                        need=(True,) * 6):
    """The kernel's and the plain version's gradients of one emission."""
    from instantvnr_torch.render import raymarch as rm

    ins = (org, dirn, t_far, state.t, state.t_cell_end, state.ss)
    args = (mc, 1.0, k, skips, s)
    before = rm.emit_backward_counter.launches
    got = rm._kernel_emit_backward(*ins, grads, need, *args)
    torch.cuda.synchronize()
    assert rm.emit_backward_counter.launches == before + 1
    want = rm._plain_emit_backward(*ins, grads, need, *args)
    return got, want


def _assert_grads_close(got, want, rtol=1e-5):
    for name, a, b in zip(("org", "dirn", "t_far", "t", "tce", "ss"), got,
                          want):
        if a is None:
            continue
        b = torch.zeros_like(a) if b is None else b
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=rtol * float(b.abs().max()),
                                   err_msg=name)


def _random_cotangents(gen, r, kk, device):
    return [torch.randn(sh, generator=gen, device=device)
            for sh in ((r,),) * 3 + ((r, kk),) * 2]


@pytest.mark.parametrize("w,h,k,s,skips", [
    *((512, 512, 8, s, skips) for s in (1, 2) for skips in (1, 8)),
    *((300, 167, k, s, skips) for k in (1, 4, 8, 33) for s in (1, 2)
      for skips in (1, 8)),
    *((w, 1, k, 1, 8) for w in (1, 31, 127, 129, 16385) for k in (4, 8)),
    (16385, 1, 33, 2, 8)])
def test_raymarch_emit_backward_matches_plain(cuda, w, h, k, s, skips):
    """raymarch_emit_backward against the plain backward (autograd of
    _emit_samples on the same card tensors) on a frame's rays over vorts
    128³ (R = 2^18 at 512², a ragged R, and a frame's middle row of 1, 31,
    127, 129 and 16,385 rays: the edges of a lane group and of a block of
    rays), three supersteps from the carried state, with dead rays (an
    empty range) and rays whose state is past t_far: each leaf within 1e-5
    of its largest entry, the same bits on a second launch, one launch a
    call."""
    from instantvnr_torch.render import raymarch as rm

    sv, org, dirn, t0, t1, _ = _wavefront_rays(cuda, w, h)
    t_far = t1.clone()
    t_far[128:640] = t0[128:640]  # dead: the range is empty
    state = rm.init_ray_state(t0, t_far)
    state = state._replace(t=torch.where(
        torch.arange(len(t0), device=cuda) % 97 == 0, t_far + 1.0, state.t))
    gen = torch.Generator(device=cuda).manual_seed(k * 10 + s + skips)
    for _ in range(3):
        grads = _random_cotangents(gen, len(t0), k * s, cuda)
        got, want = _emit_backward_both(org, dirn, t_far, state,
                                        sv.macrocell, k, skips, s, grads)
        _assert_grads_close(got, want)
        again = rm._kernel_emit_backward(
            org, dirn, t_far, state.t, state.t_cell_end, state.ss, grads,
            (True,) * 6, sv.macrocell, 1.0, k, skips, s)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        (t, tce, ss), *_ = rm._emit_samples(org, dirn, t_far, state,
                                            sv.macrocell, 1.0, k, skips, s)
        state = state._replace(t=t, t_cell_end=tce, ss=ss)


def test_raymarch_emit_backward_ties_and_axis_parallel(cuda):
    """The scan's ties (tests/torch_emit_rays.py: t_y at the cell end, the
    last cell's exit at t_far, two axes' exits, the probe on an exit face)
    split on the card as autograd splits them, and axis-parallel rays (one
    and two zero components) get finite gradients, 0 on the zero axes:
    the kernel against the plain backward within 1e-5 of each leaf's
    largest entry, and against each tie's stated split."""
    from torch_emit_rays import (BASE_STEP, port_macrocell, random_rays,
                                 tie_cases, tie_cotangents)

    from instantvnr_torch.render import raymarch as rm

    mc = port_macrocell(cuda)
    for c in tie_cases().values():
        ins = [torch.tensor(c[x], device=cuda)
               for x in ("org", "dirn", "t_far", "t", "tce", "ss")]
        grads = [torch.tensor(g, device=cuda) for g in tie_cotangents(c)]
        args = (mc, BASE_STEP, c["k"], c["skips"], 1)
        got = rm._kernel_emit_backward(*ins, grads, (True,) * 6, *args)
        want = rm._plain_emit_backward(*ins, grads, (True,) * 6, *args)
        _assert_grads_close(got, want)
        if c["want"] is not None:
            leaves = dict(zip(("org", "dirn", "t_far", "t", "tce", "ss"),
                              got))
            exp = {leaf: torch.zeros_like(x) for leaf, x in leaves.items()}
            for (leaf, i), v in c["want"].items():
                exp[leaf].view(-1)[i] = v
            for leaf, x in leaves.items():
                torch.testing.assert_close(x, exp[leaf], rtol=0, atol=1e-6)
    gen = torch.Generator(device=cuda).manual_seed(9)
    for zero_axes in (1, 2):
        org, dirn, t0, t1 = (torch.tensor(x, device=cuda) for x in
                             random_rays(4096, 50 + zero_axes, zero_axes))
        state = rm.init_ray_state(t0, t1)
        for _ in range(3):
            grads = _random_cotangents(gen, 4096, 4, cuda)
            got, want = _emit_backward_both(org, dirn, t1, state, mc, 4, 8,
                                            1, grads)
            _assert_grads_close(got, want)
            zero = dirn == 0
            assert (got[0][zero] == 0).all() and (got[1][zero] == 0).all()
            (t, tce, ss), *_ = rm._emit_samples(org, dirn, t1, state, mc,
                                                BASE_STEP, 4, 8)
            state = state._replace(t=t, t_cell_end=tce, ss=ss)


@pytest.mark.parametrize("need", [
    (True, True, False, True, False, False),
    (True, True, False, False, False, False),
    (False, False, False, True, True, True)])
@pytest.mark.parametrize("nulls", [(0, 2, 4), (0,), (1,), (2,), (3,), (4,)])
def test_emit_backward_partial_needs_and_cotangents(cuda, need, nulls):
    """Only the gradients asked for are computed (the others None; the
    rays alone and the state alone, as a frame asks for them), and a
    missing cotangent counts as zero: the same numbers as the full call
    with zeros in its place, within 1e-5 of the plain backward's largest
    entry."""
    from instantvnr_torch.render import raymarch as rm

    sv, org, dirn, t0, t1, _ = _wavefront_rays(cuda, 64, 64)
    state = rm.init_ray_state(t0, t1)
    gen = torch.Generator(device=cuda).manual_seed(4)
    grads = _random_cotangents(gen, len(t0), 8, cuda)
    sparse = [None if i in nulls else g for i, g in enumerate(grads)]
    dense = [g if g is not None else torch.zeros_like(z)
             for g, z in zip(sparse, grads)]
    args = (sv.macrocell, 1.0, 8, 8, 1)
    ins = (org, dirn, t1, state.t, state.t_cell_end, state.ss)
    got = rm._kernel_emit_backward(*ins, sparse, need, *args)
    full = rm._kernel_emit_backward(*ins, dense, (True,) * 6, *args)
    for g, f, n in zip(got, full, need):
        assert (g is None) == (not n)
        if n:
            assert torch.equal(g, f)
    _assert_grads_close(got, rm._plain_emit_backward(*ins, dense,
                                                     (True,) * 6, *args))


def test_card_backward_never_runs_the_plain_emission(cuda, monkeypatch):
    """The ray-differentiated frame's backward on the card goes through
    raymarch_emit_backward alone: with the plain emission and its plain
    backward patched to raise, the frame still differentiates, one
    emission backward for each emission up to the last that sampled."""
    from instantvnr_torch.render import raymarch as rm

    def refuse(*a, **k):
        raise AssertionError("a card backward reached the plain emission")

    monkeypatch.setattr(rm, "_plain_emit_backward", refuse)
    monkeypatch.setattr(rm, "_emit_samples", refuse)
    before = (rm.emit_counter.launches, rm.emit_backward_counter.launches)
    sampled_at = []
    loss, rays, _ = _ray_grad_loss(cuda, False, sampled_at=sampled_at)
    loss.backward()
    torch.cuda.synchronize()
    assert rm.emit_counter.launches - before[0] == 24
    assert (rm.emit_backward_counter.launches - before[1]
            == sampled_at[-1] - before[0] > 0)
    assert all(torch.isfinite(r.grad).all() and r.grad.abs().max() > 0
               for r in rays)


# -- the fused Adam (csrc/adam.cu) against the plain form, bit for bit ------


def _adam_case(case, step, cuda):
    """(params, grads, state, l2 mask) of a test case on the card: C1's own
    tree (the 2^19 schema, 23.4 M parameters), ragged leaves (some views 4
    bytes into their buffers), or a tree longer than a launch takes. At
    step 1 the moments are zero, as a fresh state's are."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models import optimizer as opt
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.models.trainer import create_train_state
    from instantvnr_torch.ops import adam as kadam

    gen = torch.Generator(device=cuda).manual_seed(step)

    def like(t, scale, offset=0):
        buf = torch.randn(t.numel() + offset, generator=gen, device=cuda)
        out = (buf * scale)[offset:].view(t.shape)
        out[torch.rand(t.shape, generator=gen, device=cuda) < 0.05] = 0.0
        return out

    if case == "c1_tree":
        params = create_train_state(NeuralField.from_config(ModelConfig()),
                                    device=cuda).params
        offsets = [0] * (1 + len(params["mlp"]))
    else:
        sizes = ([1, 3, 5, 1001, (1 << 20) + 3] if case == "ragged"
                 else [17, 64 * 64, 1, 4096, 3, 8] * 3 + [2])
        assert case == "ragged" or len(sizes) > kadam.MAX_LEAVES
        offsets = [0, 1, 0, 1, 1] if case == "ragged" else [0, 1] * 9 + [0]
        leaves = [like(torch.empty(n), 1e-2, o)
                  for n, o in zip(sizes, offsets)]
        params = {"table": leaves[0], "mlp": leaves[1:]}
    leaves = opt._leaves(params)
    grads = [like(p, 1e-3, o) for p, o in zip(leaves, offsets)]
    mu = [like(p, 1e-4, o) for p, o in zip(leaves, offsets)]
    nu = [like(p, 1e-3, o).square_() for p, o in zip(leaves, offsets)]
    if step == 1:
        mu, nu = [torch.zeros_like(p) for p in leaves], \
            [torch.zeros_like(p) for p in leaves]
    tree = opt._tree
    state = opt.AdamState(step=step - 1, mu=tree(mu), nu=tree(nu))
    return params, tree(grads), state, opt.mlp_l2_mask(params)


@pytest.mark.parametrize("step", [1, 2, 2001, 3001])
@pytest.mark.parametrize("case", ["c1_tree", "ragged", "longer_tree"])
def test_adam_kernel_matches_plain_bit_for_bit(cuda, case, step):
    """p', m' and v' of the kernel equal the plain form's bit for bit; the
    inputs are left as they were; a tree of up to MAX_LEAVES leaves is one
    launch."""
    from instantvnr_torch.config import OptimizerConfig
    from instantvnr_torch.models import optimizer as opt
    from instantvnr_torch.ops import adam as kadam

    cfg = OptimizerConfig()
    params, grads, state, mask = _adam_case(case, step, cuda)
    inputs = [opt._leaves(t) for t in (params, grads, state.mu, state.nu)]
    before = [[t.clone() for t in ts] for ts in inputs]
    n0 = kadam.counter.launches
    new, st = opt.adam_update(cfg, params, grads, state, l2_mask=mask)
    torch.cuda.synchronize()
    launches = kadam.counter.launches - n0
    ref, rst = opt.adam_update_plain(cfg, params, grads, state, l2_mask=mask)
    n_leaves = len(opt._leaves(params))
    assert launches == -(-n_leaves // kadam.MAX_LEAVES)
    if case == "c1_tree":
        assert launches == 1
        assert sum(p.numel() for p in opt._leaves(params)) > 23_000_000
    assert st.step == rst.step == step
    for name, a, b in (("p", new, ref), ("m", st.mu, rst.mu),
                       ("v", st.nu, rst.nu)):
        for i, (x, y) in enumerate(zip(opt._leaves(a), opt._leaves(b))):
            assert x.dtype == torch.float32 and x.shape == y.shape
            diff = int((x != y).sum())
            assert diff == 0, f"{name}[{i}]: {diff} of {x.numel()} differ"
    for ts, olds in zip(inputs, before):
        for t, old in zip(ts, olds):
            assert torch.equal(t, old)
    assert new["table"] is not params["table"]


def test_adam_kernel_refuses_what_it_does_not_take(cuda):
    from instantvnr_torch.config import OptimizerConfig
    from instantvnr_torch.models import optimizer as opt

    cfg = OptimizerConfig()
    p = {"table": torch.zeros((64, 8), device=cuda),
         "mlp": [torch.zeros((8, 4), device=cuda)]}
    g = {"table": torch.ones((64, 8), device=cuda),
         "mlp": [torch.ones((8, 4), device=cuda)]}
    state = opt.adam_init(p)
    opt.adam_update(cfg, p, g, state)  # the sound tree runs
    bad = [{"table": g["table"].to(torch.bfloat16), "mlp": g["mlp"]},
           {"table": g["table"].t().contiguous().t(), "mlp": g["mlp"]},
           {"table": g["table"][:32], "mlp": g["mlp"]},
           {"table": g["table"].cpu(), "mlp": g["mlp"]}]
    for grads in bad:
        with pytest.raises(ValueError, match="contiguous float32"):
            opt.adam_update(cfg, p, grads, state)
    half = {"table": p["table"].half(), "mlp": p["mlp"]}
    with pytest.raises(ValueError, match="contiguous float32"):
        opt.adam_update(cfg, half, g, opt.adam_init(p))


def test_foreach_scalar_division_is_a_float32_reciprocal_product(cuda):
    """What csrc/adam.cu repeats: PyTorch's foreach kernels divide a float32
    list by a scalar as a product with the scalar's float32 reciprocal, for
    the bias corrections of steps 1-5000 and of every 97th step to 10^5."""
    from instantvnr_torch.config import OptimizerConfig
    from instantvnr_torch.models import optimizer as opt

    cfg = OptimizerConfig()
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(1 << 16, generator=gen, device=cuda) * 1e-3
    f32 = np.float32
    apart = 0
    for step in [*range(1, 5001), *range(5001, 100_001, 97)]:
        s = opt.adam_scalars(cfg, step)
        for c in (s.c1, s.c2):
            got = torch._foreach_div([x], c)[0]
            assert torch.equal(got, x * float(f32(1) / f32(c))), (step, c)
            apart += not torch.equal(got, x / torch.full_like(x, c))
    assert apart > 0  # a true division parts from it
