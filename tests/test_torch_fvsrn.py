"""fV-SRN (models/fvsrn.py) and its torch-checkpoint importer
(models/fvsrn_import.py) against the JAX package's, on the CPU (ROADMAP
Queue 1 item 5).

The same params (numpy, from a seed) go into both packages' FvsrnField.

Tolerances:
- float32 compute: atol 2e-5 on the forward and rtol 1e-4 of the largest
  entry on the gradients (float32 sums in another order; the activation's
  cos in another libm);
- bf16 compute: atol 2e-2 and mean 1e-3 on the forward, the decode's
  tolerance (tests/test_torch_fused_mlp.py: both round the operands to
  bf16 and sum in float32, but a last-bit difference before a round moves
  an activation by a bf16 step);
- the importer against a live nn.Module forward: atol 2e-4, rtol 1e-4 in
  float32, as JAX's tests/test_fvsrn_import.py holds its importer; the two
  importers' params: equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fvsrn_import import TinyFvsrn

from instantvnr_tpu import serializer as jser
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.models import fvsrn as jfv
from instantvnr_tpu.models.fvsrn_import import load_fvsrn_torch as j_import
from instantvnr_tpu.models.metrics import decode_volume as j_decode
from instantvnr_tpu.models.network import render_params as j_render_params
from instantvnr_tpu.models.trainer import create_train_state as j_create
from instantvnr_torch import api, serializer
from instantvnr_torch.apps import view_model
from instantvnr_torch.config import NetworkConfig
from instantvnr_torch.models import fvsrn as fv
from instantvnr_torch.models.fvsrn_import import load_fvsrn_torch
from instantvnr_torch.models.metrics import decode_volume
from instantvnr_torch.models.network import network_apply, render_params

SMALL = dict(latent_res=(6, 5, 4), latent_features=8, fourier_bands=3)
NET = dict(n_neurons=16, n_hidden_layers=2, activation="SnakeAlt")


def _cfgs(compute="bfloat16", **kw):
    args = dict(SMALL, **kw)
    return (jfv.FvsrnConfig(network=JNet(**NET), compute_dtype=compute,
                            **args),
            fv.FvsrnConfig(network=NetworkConfig(**NET),
                           compute_dtype=compute, **args))


def _params_np(field, extras=(), seed=2):
    rng = np.random.default_rng(seed)
    widths = [field.mlp_input_dims, 16, 16, 1]
    p = {"table": rng.standard_normal(
        (field.n_latent, field.cfg.latent_features)).astype(np.float32),
         "mlp": [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(
             np.float32) for a, b in zip(widths[:-1], widths[1:])]}
    if "fourier" in extras:
        m = 3 * field.cfg.fourier_bands  # 2M = 6·bands inputs, as the bands
        p["fourier"] = rng.standard_normal((m, 3)).astype(np.float32)
    if "bias" in extras:
        p["bias"] = [rng.standard_normal(b).astype(np.float32) * 0.1
                     for b in widths[1:]]
    return p


def _to(p, conv):
    return {k: ([conv(x) for x in v] if isinstance(v, list) else conv(v))
            for k, v in p.items()}


def _coords(b, seed=3):
    c = np.random.default_rng(seed).random((b, 3)).astype(np.float32)
    c[:3] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5]]
    return c


EXTRAS = [(), ("fourier",), ("bias",), ("fourier", "bias")]


@pytest.mark.parametrize("extras", EXTRAS, ids=lambda e: "+".join(e) or "none")
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_matches_jax(extras, compute):
    jcfg, tcfg = _cfgs(compute)
    jf, tf = jfv.FvsrnField(jcfg), fv.FvsrnField(tcfg)
    assert (jf.n_params, jf.mlp_input_dims, jf.n_latent) == (
        tf.n_params, tf.mlp_input_dims, tf.n_latent)
    p = _params_np(tf, extras)
    c = _coords(4096)
    want = np.asarray(jf.apply_params(_to(p, jnp.asarray), jnp.asarray(c)))
    # through network_apply, the family dispatch the trainer uses
    got = network_apply(_to(p, torch.from_numpy), torch.from_numpy(c),
                        tf).numpy()
    assert got.shape == want.shape == (4096, 1)
    if compute == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
        assert np.abs(got - want).mean() <= 1e-3


@pytest.mark.parametrize("extras", [(), ("fourier", "bias")],
                         ids=["native", "imported"])
def test_gradients_match_jax(extras):
    jcfg, tcfg = _cfgs("float32")
    jf, tf = jfv.FvsrnField(jcfg), fv.FvsrnField(tcfg)
    p = _params_np(tf, extras)
    c = _coords(2048)
    g = np.random.default_rng(5).standard_normal((2048, 1)).astype(
        np.float32)
    jg = jax.grad(lambda q: jnp.sum(jf.apply_params(q, jnp.asarray(c)) * g))(
        _to(p, jnp.asarray))
    tp = _to(p, lambda a: torch.tensor(a, requires_grad=True))
    (network_apply(tp, torch.from_numpy(c), tf)
     * torch.from_numpy(g)).sum().backward()

    def close(t, j):
        j = np.asarray(j)
        assert np.abs(j).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0,
                                   atol=1e-4 * np.abs(j).max())

    for key in p:
        if isinstance(p[key], list):
            for t, j in zip(tp[key], jg[key]):
                close(t, j)
        else:
            close(tp[key], jg[key])


def test_snakealt_activation():
    from instantvnr_torch.ops.mlp import apply_activation

    x = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(apply_activation(x, "SnakeAlt").numpy(),
                               0.5 * (x + 1 - torch.cos(2 * x)).numpy(),
                               atol=1e-7)


def test_trains_renders_and_npz_both_ways(tmp_path):
    """The facade trains an FvsrnConfig, renders a DECODED_SLAB frame, and
    its native .npz loads in JAX; JAX's loads in the port. BSON has no
    fV-SRN layout in either package."""
    jcfg, tcfg = _cfgs()
    simple = api.SimpleVolume.synthetic((16,) * 3, "sphere", device="cpu")
    nv = api.NeuralVolume(tcfg, simple, device="cpu", train_batch=4096)
    assert isinstance(nv.field, fv.FvsrnField)
    before = nv.get_psnr()
    nv.train(60)
    assert nv.get_psnr() > before + 3.0
    r = api.VNRenderer(nv, 16, 16)
    r.render()
    frame = r.mapframe()
    assert np.isfinite(frame).all() and frame[..., 3].max() > 0.05
    with pytest.raises(ValueError, match="fV-SRN"):
        nv.save_params(str(tmp_path / "f.bson"))
    path = str(tmp_path / "port.npz")
    nv.save_params(path)
    dims = (12, 10, 8)
    want = decode_volume(nv.field, render_params(nv.params, nv.field),
                         dims).numpy()
    jfield, jstate, jdims = jser.load_native(path)
    assert isinstance(jfield, jfv.FvsrnField) and jfield.cfg == jcfg
    got = np.asarray(j_decode(jfield, j_render_params(jstate.params, jfield),
                              dims))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert np.abs(got - want).mean() <= 1e-3
    # exact resume in the port
    again = api.NeuralVolume.from_checkpoint(path, simple=simple,
                                             device="cpu")
    assert again.step == nv.step and isinstance(again.field, fv.FvsrnField)
    np.testing.assert_array_equal(again.decode_volume().numpy(),
                                  nv.decode_volume().numpy())
    # the JAX package's file
    jfield = jfv.FvsrnField(jcfg)
    jstate = j_create(jax.random.PRNGKey(1), jfield)
    jpath = str(tmp_path / "jax.npz")
    jser.save_native(jpath, jfield, jstate, volume_dims=dims)
    field, state, got_dims = serializer.load_native(jpath, device="cpu")
    assert field.cfg == tcfg and got_dims == dims
    np.testing.assert_array_equal(state.params["table"].numpy(),
                                  np.asarray(jstate.params["table"]))


def _state_dict_file(tmp_path):
    net = TinyFvsrn()
    path = str(tmp_path / "fvsrn.pt")
    torch.save(net.state_dict(), path)
    return net, path


def test_importer_matches_jax_and_a_live_module(tmp_path):
    net, path = _state_dict_file(tmp_path)
    field, params = load_fvsrn_torch(path, device="cpu")
    jfield, jparams = j_import(path)
    assert field.cfg.latent_res == jfield.cfg.latent_res == (6, 5, 4)
    assert dataclasses.asdict(field.cfg) == dataclasses.asdict(jfield.cfg)
    assert sorted(params) == sorted(jparams) == ["bias", "fourier", "mlp",
                                                  "table"]
    for key in params:
        for a, b in zip(params[key] if isinstance(params[key], list)
                        else [params[key]],
                        jparams[key] if isinstance(jparams[key], list)
                        else [jparams[key]]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pts = _coords(256, seed=0)
    with torch.no_grad():
        want = net(torch.from_numpy(pts)).numpy()
    f32 = dataclasses.replace(field, cfg=dataclasses.replace(
        field.cfg, compute_dtype="float32"))
    got = network_apply(params, torch.from_numpy(pts), f32).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    # a whole module, a checkpoint dict around the state dict
    f2, p2 = load_fvsrn_torch({"state_dict": net.state_dict()},
                              device="cpu")
    assert f2 == field and torch.equal(p2["fourier"], params["fourier"])
    assert load_fvsrn_torch(net, device="cpu")[0] == field


def test_render_params_keep_the_import(tmp_path):
    """render_params (the decoder's and the renderers' params) keep an
    import's Fourier matrix and biases; the JAX package's drops them
    (ROADMAP Queue 3), so its decode of an import changes function."""
    _, path = _state_dict_file(tmp_path)
    field, params = load_fvsrn_torch(path, device="cpu")
    rp = render_params(params, field)
    assert rp["table"].dtype == torch.bfloat16
    assert sorted(rp) == sorted(params)
    c = torch.from_numpy(_coords(512))
    np.testing.assert_allclose(network_apply(rp, c, field).numpy(),
                               network_apply(params, c, field).numpy(),
                               atol=5e-2)
    jfield, jparams = j_import(path)
    assert "fourier" not in j_render_params(jparams, jfield)


def test_view_model_reads_an_import(tmp_path, capsys):
    _, path = _state_dict_file(tmp_path)
    info = view_model.main([path, "--synthetic", "sphere", "--dims", "12",
                            "--device", "cpu", "--evaluate"])
    out = capsys.readouterr().out
    assert "fV-SRN torch checkpoint" in out and "latent grid" in out
    assert info["n_params"] == load_fvsrn_torch(path, device="cpu")[
        0].n_params
    assert np.isfinite(info["psnr"]) and np.isfinite(info["ssim"])
