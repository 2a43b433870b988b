"""Port's fused-MLP plain version == the JAX package's Pallas fused MLP
(interpret mode) and its XLA MLP, on the same numpy inputs.

Tolerance: atol = rtol = 2e-2 with a mean abs difference ≤ 1e-3. Both
sides round every hidden activation to bf16; under a different summation
order an activation near a rounding boundary lands on the other bf16
neighbour, which flips isolated outputs by a few bf16 ulps.
"""
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
    ws, x = _inputs(6, 16, 16, 1, 1, 8)
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    with pytest.raises(RuntimeError, match="forward-only"):
        fm.fused_mlp_apply(tw, torch.from_numpy(x),
                           NetworkConfig(n_neurons=16, n_hidden_layers=1))


def test_pack_weights_layout():
    ws, _ = _inputs(7, 64, 64, 4, 1, 1)
    packed = fm.pack_weights([torch.from_numpy(w) for w in ws])
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == 64 * 64 * 4 + 64  # 33 KB of bf16 at 2 B each
    np.testing.assert_array_equal(
        packed[:64 * 64].float().numpy().reshape(64, 64),
        torch.from_numpy(ws[0]).to(torch.bfloat16).float().numpy())
