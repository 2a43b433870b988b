"""Port's fused-MLP plain versions == the JAX package's Pallas fused MLP
(interpret mode) and its XLA MLP, on the same numpy inputs.

Tolerance of the outputs: atol = rtol = 2e-2 with a mean abs difference
≤ 1e-3. Both sides round every hidden activation to bf16; under a
different summation order an activation near a rounding boundary lands on
the other bf16 neighbour, which flips isolated outputs by a few bf16 ulps.
The training form's gradients (every dW and dx) are held to JAX's
`custom_vjp` backward within 1e-3 of each gradient's largest entry: both
run the same float32 matmul chain over the same bf16-rounded activations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.config import NetworkConfig as JNetworkConfig
from instantvnr_tpu.ops.mlp import mlp_apply as j_mlp_apply
from instantvnr_tpu.ops.pallas.fused_mlp import fused_mlp_apply as j_fused
from instantvnr_torch.config import NetworkConfig
from instantvnr_torch.ops import fused_mlp as fm

ATOL = RTOL = 2e-2
MEAN_TOL = 1e-3


def _inputs(seed, n_in, width, n_hidden, n_out, b):
    rng = np.random.default_rng(seed)
    widths = [n_in] + [width] * n_hidden + [n_out]
    ws = [(rng.standard_normal((a, c)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, c in zip(widths[:-1], widths[1:])]
    x = rng.standard_normal((b, n_in)).astype(np.float32)
    return ws, x


def _close(got, ref):
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert np.abs(got - ref).mean() <= MEAN_TOL


@pytest.mark.parametrize("act", ["ReLU", "Sine", "Squareplus"])
@pytest.mark.parametrize("n_out", [1, 4])
def test_reference_matches_jax(act, n_out):
    ws, x = _inputs(3, 32, 32, 3, n_out, 1000)
    kw = dict(n_neurons=32, n_hidden_layers=3, activation=act,
              output_activation="None")
    jcfg, cfg = JNetworkConfig(**kw), NetworkConfig(**kw)
    jw = [jnp.asarray(w) for w in ws]
    j_kernel = np.asarray(j_fused(jw, jnp.asarray(x), jcfg, tile=256,
                                  interpret=True))
    j_xla = np.asarray(j_mlp_apply(jw, jnp.asarray(x), jcfg))
    tw = [torch.from_numpy(w) for w in ws]
    got = fm.fused_mlp_reference(tw, torch.from_numpy(x), cfg).numpy()
    assert got.shape == (1000, n_out) and got.dtype == np.float32
    _close(got, j_kernel)
    _close(got, j_xla)


def test_output_activation_honored():
    ws, x = _inputs(4, 16, 16, 2, 1, 300)
    kw = dict(n_neurons=16, n_hidden_layers=2, output_activation="Squareplus")
    j = np.asarray(j_mlp_apply([jnp.asarray(w) for w in ws], jnp.asarray(x),
                               JNetworkConfig(**kw)))
    got = fm.fused_mlp_reference([torch.from_numpy(w) for w in ws],
                                 torch.from_numpy(x),
                                 NetworkConfig(**kw)).numpy()
    _close(got, j)
    assert (got > 0).all()


def test_wrapper_takes_plain_version_on_cpu():
    ws, x = _inputs(5, 64, 64, 4, 1, 257)
    cfg = NetworkConfig()
    tw = [torch.from_numpy(w) for w in ws]
    before = fm.counter.launches
    got = fm.fused_mlp_apply(tw, torch.from_numpy(x).to(torch.bfloat16), cfg)
    ref = fm.fused_mlp_reference(tw, torch.from_numpy(x), cfg)
    assert fm.counter.launches == before  # no kernel launched on the CPU
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_wrapper_refuses_grad():
    """Inputs that require grad no longer make the wrapper refuse: on the
    CPU they take the plain training form, and nothing is launched."""
    ws, x = _inputs(6, 16, 16, 1, 1, 8)
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    cfg = NetworkConfig(n_neurons=16, n_hidden_layers=1)
    counters = (fm.counter, fm.train_forward_counter, fm.backward_counter)
    before = [c.launches for c in counters]
    y = fm.fused_mlp_apply(tw, torch.from_numpy(x), cfg)
    assert y.requires_grad and y.grad_fn is not None
    y.sum().backward()
    assert all(w.grad is not None for w in tw)
    assert [c.launches for c in counters] == before
    ref = fm.fused_mlp_reference([torch.from_numpy(w) for w in ws],
                                 torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(y.detach().numpy(), ref.numpy())


@pytest.mark.parametrize("act,out_act,n_hidden", [
    ("ReLU", "None", 3), ("Sine", "Squareplus", 1),
    ("Squareplus", "Sine", 3), ("ReLU", "ReLU", 1),
    # a single weight matrix: no residuals (fused_mlp.py:178-192)
    ("ReLU", "None", 0), ("ReLU", "Squareplus", 0)])
def test_training_form_matches_jax_custom_vjp(act, out_act, n_hidden):
    n_in, width, n_out, b = 32, 32, 2, 1000  # b ragged against tile 256
    ws, x = _inputs(8 + n_hidden, n_in, width, n_hidden, n_out, b)
    ct = np.random.default_rng(9).standard_normal((b, n_out)).astype(
        np.float32)
    kw = dict(n_neurons=width, n_hidden_layers=n_hidden, activation=act,
              output_activation=out_act)
    jcfg, cfg = JNetworkConfig(**kw), NetworkConfig(**kw)
    jw, jx = [jnp.asarray(w) for w in ws], jnp.asarray(x)

    def jloss(w, xx):
        return jnp.sum(j_fused(w, xx, jcfg, tile=256, interpret=True) * ct)

    j_y = np.asarray(j_fused(jw, jx, jcfg, tile=256, interpret=True))
    j_dw, j_dx = jax.grad(jloss, argnums=(0, 1))(jw, jx)
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    tx = torch.from_numpy(x).requires_grad_()
    y = fm.fused_mlp_apply(tw, tx, cfg)
    (y * torch.from_numpy(ct)).sum().backward()
    _close(y.detach().numpy(), j_y)
    assert tx.grad.dtype == torch.float32
    for got, ref in zip([tx.grad] + [w.grad for w in tw],
                        [j_dx] + list(j_dw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max())


def test_training_form_residuals_match_jax():
    """The saved pre-activations and z_out equal the Pallas kernel's
    residual outputs (`_pallas_forward(..., save_residuals=True)`)."""
    from instantvnr_tpu.ops.pallas.fused_mlp import _pallas_forward

    ws, x = _inputs(10, 16, 16, 2, 1, 512)
    kw = dict(n_neurons=16, n_hidden_layers=2, activation="Sine")
    j_z, j_zs = _pallas_forward([jnp.asarray(w) for w in ws], jnp.asarray(x),
                                JNetworkConfig(**kw), 256, True, True)
    z_out, zs = fm._plain_train_forward([torch.from_numpy(w) for w in ws],
                                        torch.from_numpy(x),
                                        NetworkConfig(**kw))
    assert zs.shape == (2, 512, 16) and zs.dtype == torch.float32
    _close(zs.numpy(), np.asarray(j_zs))
    _close(z_out.numpy(), np.asarray(j_z))


def _split_bf16(g):
    """float32 g → three bf16 terms g_i = bf16(g − Σ_{j<i} g_j), each
    rounded to nearest, as the backward kernel (`split3` in
    csrc/fused_mlp.cu) splits its cotangents; each subtraction is exact."""
    rest, out = g, []
    for _ in range(3):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return out


def test_split_bf16_rebuilds_f32():
    """The backward kernel's premise: three bf16 terms rebuild any normal
    float32 to within 2^-24 of its magnitude (two terms do not)."""
    rng = np.random.default_rng(11)
    mag = np.exp2(rng.uniform(-100, 100, 1 << 16))
    g = torch.from_numpy((rng.choice([-1.0, 1.0], mag.size) * mag
                          * rng.uniform(1, 2, mag.size)).astype(np.float32))
    parts = _split_bf16(g)
    assert len(parts) == 3 and all(p.dtype == torch.bfloat16 for p in parts)
    gd = g.double()
    rest3 = gd - sum(p.double() for p in parts)
    assert bool((rest3.abs() <= 2.0 ** -24 * gd.abs()).all())
    rest2 = gd - parts[0].double() - parts[1].double()
    assert float((rest2.abs() / gd.abs()).max()) > 2.0 ** -20


def test_split_products_meet_f64_oracle():
    """h_kᵀ Σ g_i, each product bf16 × bf16 (exact in float32) with float32
    accumulation as on the tensor cores, against a float64 oracle at the
    training batch: as close as the float32 product h_kᵀ g itself, and
    far closer than h_kᵀ bf16(g)."""
    rng = np.random.default_rng(12)
    b = 1 << 16
    h = torch.from_numpy(rng.standard_normal((b, 64)).astype(
        np.float32)).to(torch.bfloat16).float()
    g = torch.from_numpy((rng.standard_normal((b, 64)) / b).astype(
        np.float32))
    oracle = h.double().T @ g.double()
    scale = float(oracle.abs().max())

    def err(prod):
        return float((prod.double() - oracle).abs().max()) / scale

    split = sum(h.T @ p.float() for p in _split_bf16(g))
    e_split, e_f32 = err(split), err(h.T @ g)
    assert e_split <= 1e-6 and e_split <= 2.0 * e_f32 + 1e-7
    assert err(h.T @ g.to(torch.bfloat16).float()) > 100.0 * e_split


def test_plain_backward_float64_is_the_oracle():
    """_plain_backward with a float64 cotangent, weights and x runs the
    chain in float64 (the oracle the kernel's dW is held to on the card):
    its top dW is h_nᵀ g in float64, and every dW and dx lies within
    float32 rounding of the float32 chain."""
    cfg = NetworkConfig(n_neurons=32, n_hidden_layers=2)
    ws, x = _inputs(13, 16, 32, 2, 1, 512)
    ws = [torch.from_numpy(w) for w in ws]
    x = torch.from_numpy(x).to(torch.bfloat16)
    z_out, zs = fm._plain_train_forward(ws, x, cfg)
    g = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (512, 1)).astype(np.float32))
    dx, dws = fm._plain_backward(ws, x.float(), zs, z_out, g, cfg)
    dx64, dws64 = fm._plain_backward([w.double() for w in ws], x.double(),
                                     zs, z_out, g.double(), cfg)
    assert dx64.dtype == torch.float64
    assert all(d.dtype == torch.float64 for d in dws64)
    h_top = torch.relu(zs[-1]).to(torch.bfloat16).double()
    np.testing.assert_array_equal(dws64[-1].numpy(),
                                  (h_top.T @ g.double()).numpy())
    for a, r in zip([dx] + dws, [dx64] + dws64):
        r = r.numpy()
        np.testing.assert_allclose(a.double().numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


def test_pack_weights_layout():
    ws, _ = _inputs(7, 64, 64, 4, 1, 1)
    packed = fm.pack_weights([torch.from_numpy(w) for w in ws])
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == 64 * 64 * 4 + 64  # 33 KB of bf16 at 2 B each
    np.testing.assert_array_equal(
        packed[:64 * 64].float().numpy().reshape(64, 64),
        torch.from_numpy(ws[0]).to(torch.bfloat16).float().numpy())
