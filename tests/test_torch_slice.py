"""The decode + slab-render slice of the port == the JAX package, end to end,
at small size: a 4-level, 16-wide schema, a 32³ vorts volume, 40×40 frames.

- macrocell.build is equal exactly;
- the decode_all grid agrees within the MLP tolerance (test_torch_fused_mlp),
  and so does its PSNR against the volume;
- transfer-function classification (LUT and control-point forms) and the
  macrocell's range-max alpha agree at atol 1e-6;
- a frame from the SAME decoded grid agrees with the JAX Pallas compositor
  (interpret mode) at atol 2e-5, for the camera, clipped/scaled and
  custom-TF cases of tests/test_slab_pallas.py;
- the end-to-end frame (each package decodes its own grid from the same
  weights) agrees at atol 5e-3;
- BSON checkpoints cross between the packages (the port's writer is
  byte-identical) and both nlohmann-written fixtures load.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu import api as japi
from instantvnr_tpu import serializer as jser
from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.models.metrics import psnr_arrays as j_psnr_arrays
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_tpu.render.decoded import DecodedRenderer as JDecodedRenderer
from instantvnr_tpu.render.slabmarch import SlabSettings as JSlabSettings
from instantvnr_tpu.render.transform import default_transform as j_default_xf
from instantvnr_tpu.utils import tfn as jtfn
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch import api
from instantvnr_torch import serializer as ser
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.models.metrics import psnr_arrays
from instantvnr_torch.models.network import params_from_numpy
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.decoded import DecodedRenderer
from instantvnr_torch.render.transform import default_transform
from instantvnr_torch.utils import tfn
from instantvnr_torch.utils.tfn import bake_transfer_function

SCHEMA = dict(encoding=dict(n_levels=4, n_features_per_level=2,
                            log2_hashmap_size=12),
              network=dict(n_neurons=16, n_hidden_layers=2))
W = H = 40
FRAME_ATOL = 2e-5
E2E_ATOL = 5e-3
CUSTOM_TF = dict(
    colors=((0.0, 1.0, 0.1, 0.1), (0.5, 0.1, 1.0, 0.1), (1.0, 0.1, 0.1, 1.0)),
    alphas=((0.0, 0.0), (0.3, 0.05), (0.7, 0.6), (1.0, 1.0)),
    range=(0.1, 0.9))


def _jcfg():
    return JModelConfig(encoding=JEnc(**SCHEMA["encoding"]),
                        network=JNet(**SCHEMA["network"]))


def _cfg():
    return ModelConfig(encoding=EncodingConfig(**SCHEMA["encoding"]),
                       network=NetworkConfig(**SCHEMA["network"]))


@pytest.fixture(scope="module")
def scenes():
    jvol = j_synthetic_volume((32, 32, 32), kind="vorts")
    tvol = synthetic_volume((32, 32, 32), kind="vorts", device="cpu")
    return jvol, tvol


@pytest.fixture(scope="module")
def nets(scenes):
    """A JAX and a port NeuralVolume with the same weights; the table is
    scaled to ±1 so the field is not constant."""
    jvol, tvol = scenes
    jsv = japi.SimpleVolume(jvol)
    jnv = japi.NeuralVolume(_jcfg(), jsv)
    p = jnv.state.params
    p = {"table": p["table"] * 1e4, "mlp": list(p["mlp"])}
    jnv.state = jnv.state._replace(params=p)
    params_np = {"table": np.asarray(p["table"]),
                 "mlp": [np.asarray(w) for w in p["mlp"]]}
    tsv = api.SimpleVolume(tvol, device="cpu")
    tnv = api.NeuralVolume(_cfg(), tsv, device="cpu")
    tnv.params = params_from_numpy(params_np, "cpu")
    return jnv, tnv


def test_volume_and_macrocell_equal(scenes):
    jvol, tvol = scenes
    np.testing.assert_array_equal(tvol.data.numpy(), np.asarray(jvol.data))
    assert tvol.original_range == jvol.original_range
    for tfc in ({}, CUSTOM_TF):
        jm = jmc.build(jvol.data, jvol.dims, j_bake(JTFConfig(**tfc)))
        tm = mcmod.build(tvol.data, tvol.dims, bake_transfer_function(
            TransferFunctionConfig(**tfc), device="cpu"))
        for name in ("value_lo", "value_hi", "max_opacity"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)))
        assert tm.volume_dims == jm.volume_dims


def test_decode_all_matches(nets):
    jnv, tnv = nets
    jg = np.asarray(jnv.ensure_decoded(W, H).decoded)
    tg = tnv.ensure_decoded(W, H).decoded.numpy()
    assert jg.std() > 0.05  # a field, not a constant
    np.testing.assert_allclose(tg, jg, atol=2e-2, rtol=2e-2)
    assert np.abs(tg - jg).mean() <= 1e-3
    jvol = jnv.simple.volume.data
    p_ref = float(j_psnr_arrays(jnp.asarray(jg), jvol))
    p_got = float(psnr_arrays(torch.tensor(jg),
                              tnv.simple.volume.data))
    assert abs(p_got - p_ref) <= 1e-4 * abs(p_ref)


KNOTTY_TF = dict(colors=CUSTOM_TF["colors"], range=(0.0, 1.0),
                 alphas=tuple((float(x), float(a)) for x, a in zip(
                     np.linspace(0.0, 1.0, 70),
                     np.random.default_rng(11).uniform(0.0, 0.9, 70))))


@pytest.mark.parametrize("tfc", [{}, CUSTOM_TF, KNOTTY_TF],
                         ids=["default", "custom", "70-knot"])
def test_classify_matches(tfc):
    rng = np.random.default_rng(3)
    vals = rng.uniform(-0.1, 1.1, 2000).astype(np.float32)
    lo = rng.uniform(0.0, 1.0, 500).astype(np.float32)
    hi = np.minimum(lo + rng.uniform(0.0, 0.5, 500), 1.0).astype(np.float32)
    jtf = j_bake(JTFConfig(**tfc))
    ttf = bake_transfer_function(TransferFunctionConfig(**tfc), device="cpu")
    for name in ("classify", "classify_controls"):
        jrgb, ja = getattr(jtfn, name)(jtf, jnp.asarray(vals))
        trgb, ta = getattr(tfn, name)(ttf, torch.from_numpy(vals))
        np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), atol=1e-6)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_array_equal(
        tfn.max_alpha_in_range(ttf, torch.from_numpy(lo),
                               torch.from_numpy(hi)).numpy(),
        np.asarray(jtfn.max_alpha_in_range(jtf, jnp.asarray(lo),
                                           jnp.asarray(hi))))


def _frames(scenes, eye, xform=None, tfc=None, fovy=40):
    jvol, tvol = scenes
    jtf = j_bake(JTFConfig(**(tfc or {})))
    ttf = bake_transfer_function(TransferFunctionConfig(**(tfc or {})),
                                 device="cpu")
    jr = JDecodedRenderer(W, H, jmc.build(jvol.data, jvol.dims, jtf), jtf,
                          jvol.dims, initial_volume=jvol.data,
                          settings=JSlabSettings(pallas_compositor=True))
    tr = DecodedRenderer(W, H, mcmod.build(tvol.data, tvol.dims, ttf), ttf,
                         tvol.dims, initial_volume=tvol.data, device="cpu")
    jr.set_camera(JCamera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=fovy))
    tr.set_camera(Camera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=fovy))
    if xform is not None:
        jr.set_transform(j_default_xf(jvol.dims)._replace(
            **{k: jnp.asarray(v, jnp.float32) for k, v in xform.items()}))
        tr.set_transform(default_transform(tvol.dims, "cpu")._replace(
            **{k: torch.tensor(v, dtype=torch.float32)
               for k, v in xform.items()}))
    jr.render()
    tr.render()
    return jr.mapframe(), tr.mapframe()


@pytest.mark.parametrize("eye", [(0, 0, -70), (60, 9, 7), (-4, 66, 3)])
def test_frame_from_same_grid(scenes, eye):
    ref, got = _frames(scenes, eye)
    assert np.isfinite(got).all() and ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL)


def test_frame_from_same_grid_clipped_scaled(scenes):
    xf = dict(clip_lower=[4.0, 0.0, 6.0], clip_upper=[28.0, 25.0, 30.0],
              scale=[1.0, 1.4, 0.8])
    ref, got = _frames(scenes, (8, -6, -75), xform=xf, fovy=38)
    assert ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL)


def test_frame_from_same_grid_custom_tf(scenes):
    ref, got = _frames(scenes, (0, 0, -70), tfc=CUSTOM_TF)
    assert ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL)


def test_end_to_end_frame(nets):
    jnv, tnv = nets
    cam = dict(eye=(12.0, 8.0, -64.0), center=(0, 0, 0), up=(0, 1, 0),
               fovy=45.0)
    jr = japi.VNRenderer(jnv, W, H)
    jr.set_camera(JCamera(**cam))
    jr.render()
    tr = api.VNRenderer(tnv, W, H)
    tr.set_camera(Camera(**cam))
    tr.render()
    ref, got = jr.mapframe(), tr.mapframe()
    assert got.shape == (H, W, 4) and np.isfinite(got).all()
    assert ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=E2E_ATOL)
    # sampling rate and density knobs rebind without a re-decode
    decoded = tr._impl.decoded
    tr.set_volume_sampling_rate(2.0)
    tr.set_volume_density_scale(0.5)
    assert tr._impl.decoded is decoded
    jr.set_volume_sampling_rate(2.0)
    jr.set_volume_density_scale(0.5)
    jr.render()
    tr.render()
    np.testing.assert_allclose(tr.mapframe(), jr.mapframe(), atol=E2E_ATOL)


def test_bson_crosses_packages(nets, tmp_path):
    jnv, tnv = nets
    jpath, tpath = str(tmp_path / "jax.bson"), str(tmp_path / "port.bson")
    jnv.save_params(jpath)
    # JAX-written → port: equal arrays and macrocell
    jf, jp, jm, jdims, jmeta = jser.load_checkpoint(jpath)
    tf_, tp, tm, tdims, tmeta = ser.load_checkpoint(jpath, device="cpu")
    assert tdims == jdims and tmeta == jmeta
    assert tf_.cfg.to_json() == jf.cfg.to_json()
    np.testing.assert_array_equal(tp["table"].numpy(), np.asarray(jp["table"]))
    for a, b in zip(tp["mlp"], jp["mlp"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("value_lo", "value_hi"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    # port-written: byte-identical to the JAX writer on the same content
    tnv.save_params(tpath)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    # and the port renders a loaded checkpoint
    nv2 = api.NeuralVolume.from_checkpoint(tpath, device="cpu")
    r = api.VNRenderer(nv2, W, H)
    r.set_camera(Camera(eye=(0, 0, -70), center=(0, 0, 0), up=(0, 1, 0),
                        fovy=40))
    r.render()
    assert np.isfinite(r.mapframe()).all()


@pytest.mark.parametrize("name", ["tcnn_checkpoint_pristine.bson",
                                  "tcnn_checkpoint_tagged.bson"])
def test_fixtures_load(name):
    path = f"tests/fixtures/{name}"
    jf, jp, jm, jdims, jmeta = jser.load_checkpoint(path)
    tf_, tp, tm, tdims, tmeta = ser.load_checkpoint(path, device="cpu")
    assert tdims == jdims == (32, 32, 32) and tmeta == jmeta
    assert dataclasses.asdict(tf_.cfg.encoding) == dataclasses.asdict(
        jf.cfg.encoding)
    np.testing.assert_array_equal(tp["table"].numpy(), np.asarray(jp["table"]))
    for a, b in zip(tp["mlp"], jp["mlp"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tm.value_lo.numpy(), np.asarray(jm.value_lo))
