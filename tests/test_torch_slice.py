"""The decode + slab-render slice of the port == the JAX package, end to end,
at small size: a 4-level, 16-wide schema, a 32³ vorts volume, 40×40 frames.

- macrocell.build is equal exactly;
- the decode_all grid agrees within the MLP tolerance (test_torch_fused_mlp),
  and so does its PSNR against the volume;
- transfer-function classification (LUT and control-point forms) and the
  macrocell's range-max alpha agree at atol 1e-6;
- a frame from the SAME decoded grid agrees with the JAX Pallas compositor
  (interpret mode) at atol 2e-5, for the camera, clipped/scaled and
  custom-TF cases of tests/test_slab_pallas.py; shaded and shadowed frames
  (composite_slabs_ext) at atol 2e-4, the tolerance at which the JAX
  package holds its own shaded kernel (test_slab_pallas.py:99);
- the end-to-end frame (each package decodes its own grid from the same
  weights) agrees at atol 5e-3, in DECODED_SLAB plain and shaded,
  FULL_SHADOW_DECODED and ISOSURFACE_DECODED;
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
from instantvnr_torch.render.slabmarch import SlabSettings
from instantvnr_torch.render.transform import default_transform
from instantvnr_torch.utils import tfn
from instantvnr_torch.utils.tfn import bake_transfer_function

SCHEMA = dict(encoding=dict(n_levels=4, n_features_per_level=2,
                            log2_hashmap_size=12),
              network=dict(n_neurons=16, n_hidden_layers=2))
W = H = 40
FRAME_ATOL = 2e-5
EXT_FRAME_ATOL = 2e-4
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


def _frames(scenes, eye, xform=None, tfc=None, fovy=40, shading="none",
            shadows=False):
    jvol, tvol = scenes
    jtf = j_bake(JTFConfig(**(tfc or {})))
    ttf = bake_transfer_function(TransferFunctionConfig(**(tfc or {})),
                                 device="cpu")
    jr = JDecodedRenderer(W, H, jmc.build(jvol.data, jvol.dims, jtf), jtf,
                          jvol.dims, initial_volume=jvol.data,
                          settings=JSlabSettings(pallas_compositor=True,
                                                 shading=shading))
    tr = DecodedRenderer(W, H, mcmod.build(tvol.data, tvol.dims, ttf), ttf,
                         tvol.dims, initial_volume=tvol.data, device="cpu",
                         settings=SlabSettings(shading=shading))
    jr.set_camera(JCamera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=fovy))
    tr.set_camera(Camera(eye=eye, center=(0, 0, 0), up=(0, 1, 0), fovy=fovy))
    if xform is not None:
        jr.set_transform(j_default_xf(jvol.dims)._replace(
            **{k: jnp.asarray(v, jnp.float32) for k, v in xform.items()}))
        tr.set_transform(default_transform(tvol.dims, "cpu")._replace(
            **{k: torch.tensor(v, dtype=torch.float32)
               for k, v in xform.items()}))
    if shadows:
        jr.enable_shadows()
        tr.enable_shadows()
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


@pytest.mark.parametrize("shading,shadows", [
    ("gradient", False), ("none", True), ("gradient", True)],
    ids=["shaded", "shadowed", "shaded+shadowed"])
def test_ext_frame_from_same_grid(scenes, shading, shadows):
    ref, got = _frames(scenes, (25, -18, -62), fovy=42, shading=shading,
                       shadows=shadows)
    assert np.isfinite(got).all() and ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=EXT_FRAME_ATOL)


def test_ext_frame_from_same_grid_clipped_scaled(scenes):
    xf = dict(clip_lower=[4.0, 0.0, 6.0], clip_upper=[28.0, 25.0, 30.0],
              scale=[1.0, 1.4, 0.8])
    ref, got = _frames(scenes, (8, -6, -75), xform=xf, fovy=38,
                       shading="gradient")
    assert ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=EXT_FRAME_ATOL)


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


E2E_CAM = dict(eye=(12.0, 8.0, -64.0), center=(0, 0, 0), up=(0, 1, 0),
               fovy=45.0)


def _facade_pair(nets, mode):
    jnv, tnv = nets
    jr = japi.VNRenderer(jnv, W, H, japi.RenderMode(int(mode)))
    jr.set_camera(JCamera(**E2E_CAM))
    tr = api.VNRenderer(tnv, W, H, mode)
    tr.set_camera(Camera(**E2E_CAM))
    return jr, tr


def _render_both(jr, tr):
    jr.render()
    tr.render()
    ref, got = jr.mapframe(), tr.mapframe()
    assert got.shape == (H, W, 4) and np.isfinite(got).all()
    return ref, got


def test_end_to_end_slab_shading(nets):
    jr, tr = _facade_pair(nets, api.RenderMode.DECODED_SLAB)
    plain, _ = _render_both(jr, tr)
    jr.set_slab_shading("gradient")
    tr.set_slab_shading("gradient")
    ref, got = _render_both(jr, tr)
    assert ref[..., 3].max() > 0.05
    assert np.abs(ref[..., :3] - plain[..., :3]).max() > 1e-2  # shaded
    np.testing.assert_allclose(got, ref, atol=E2E_ATOL)
    # shadows on top, then the plain look back
    jr.enable_shadows()
    tr.enable_shadows()
    ref, got = _render_both(jr, tr)
    np.testing.assert_allclose(got, ref, atol=E2E_ATOL)
    for r in (jr, tr):
        r.set_slab_shading("none")
        r.disable_shadows()
    ref, got = _render_both(jr, tr)
    np.testing.assert_allclose(got, ref, atol=E2E_ATOL)
    np.testing.assert_allclose(got, plain, atol=E2E_ATOL)


def test_end_to_end_full_shadow(nets):
    jr, tr = _facade_pair(nets, api.RenderMode.FULL_SHADOW_DECODED)
    assert tr._shadow_light_used == jr._shadow_light_used
    assert tr._impl._mode_shadows
    ref, got = _render_both(jr, tr)
    assert ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=E2E_ATOL)
    # a camera move that keeps the flipped light keeps the shadow volume;
    # one that flips it back recomputes the volume
    before = tr._impl.shadow_volume
    tr.set_camera(Camera(**dict(E2E_CAM, eye=(14.0, 8.0, -64.0))))
    assert tr._impl.shadow_volume is before
    cam = dict(E2E_CAM, eye=(40.0, 50.0, 30.0))
    jr.set_camera(JCamera(**cam))
    tr.set_camera(Camera(**cam))
    assert tr._shadow_light_used == jr._shadow_light_used
    assert tr._impl.shadow_volume is not before
    shadowed, got = _render_both(jr, tr)
    np.testing.assert_allclose(got, shadowed, atol=E2E_ATOL)
    # the plain mode drops the mode's shadows: brighter than the shadowed
    tr.set_mode(api.RenderMode.DECODED_SLAB)
    assert tr._impl.shadow_volume is None and not tr._impl._mode_shadows
    assert tr._impl.settings.shadow_ambient == 0.35
    tr.render()
    base = tr.mapframe()
    assert got[..., :3].sum() < base[..., :3].sum()
    assert got[..., :3].max() <= base[..., :3].max() + 1e-4


def test_end_to_end_isosurface(nets):
    jnv, tnv = nets
    iso = float(np.median(tnv.decode_volume().numpy()))
    jr, tr = _facade_pair(nets, api.RenderMode.ISOSURFACE_DECODED)
    for r in (jr, tr):
        r.set_isovalue(iso)
    ref, got = _render_both(jr, tr)
    assert ref[..., 3].mean() > 0.05
    np.testing.assert_allclose(got, ref, atol=E2E_ATOL)
    # refresh_params re-decodes into the iso grid; the same params give the
    # same grid, held by identity in decode_volume's cache
    grid = tr._impl.grid
    tr.refresh_params()
    assert tr._impl.grid is grid


def test_decode_volume_through_render_params():
    """`NeuralVolume.decode_volume` decodes through `render_params` (the
    bf16 table + packed levels of the 2^19 schema), the JAX package's
    (api.py:564) through the raw f32 params: in the port the two paths give
    the same grid bit for bit, since the bf16 compute rounds the gathered
    rows either way, and the grid agrees with the JAX package's within the
    decode tolerance of test_decode_all_matches."""
    from instantvnr_torch.models.metrics import decode_volume

    jsv = japi.SimpleVolume(j_synthetic_volume((16, 16, 16), kind="vorts"))
    jnv = japi.NeuralVolume(JModelConfig(), jsv)
    rng = np.random.default_rng(5)
    p = jnv.state.params
    params_np = {"table": rng.uniform(-1.0, 1.0, p["table"].shape).astype(
        np.float32), "mlp": [(rng.standard_normal(w.shape) * np.sqrt(
            2.0 / w.shape[0])).astype(np.float32) for w in p["mlp"]]}
    jnv.state = jnv.state._replace(params={
        "table": jnp.asarray(params_np["table"]),
        "mlp": [jnp.asarray(w) for w in params_np["mlp"]]})
    tnv = api.NeuralVolume(ModelConfig(), api.SimpleVolume(
        synthetic_volume((16, 16, 16), kind="vorts", device="cpu"),
        device="cpu"), device="cpu")
    tnv.params = params_from_numpy(params_np, "cpu")
    got = tnv.decode_volume()
    assert tnv.decode_volume() is got  # identity-cached on params
    raw = decode_volume(tnv.field, tnv.params, tnv.dims)
    np.testing.assert_array_equal(got.numpy(), raw.numpy())
    ref = np.asarray(jnv.decode_volume())
    assert ref.std() > 0.05
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2, rtol=2e-2)
    assert np.abs(got.numpy() - ref).mean() <= 1e-3


def test_caches_follow_decode_and_tf(nets):
    """The gradient volumes are dropped on every decode (a stale cache would
    shade the old field) and a sticky shadow volume is recomputed on every
    decode and transfer-function edit."""
    _, tnv = nets
    dec = tnv.ensure_decoded(W, H)
    dec.settings = dataclasses.replace(dec.settings, shading="gradient")
    dec.set_camera(Camera(**E2E_CAM))
    dec.enable_shadows((0.2, 0.9, 0.3))
    dec.render()
    grads, shadow = dec._gradients, dec.shadow_volume
    assert grads is not None and shadow is not None
    dec.decode_progressive(1)
    assert dec._gradients is None and dec.shadow_volume is not shadow
    dec.render()
    assert dec._gradients is not grads
    shadow = dec.shadow_volume
    dec.set_transfer_function(bake_transfer_function(
        TransferFunctionConfig(**CUSTOM_TF), device="cpu"))
    assert dec.shadow_volume is not shadow
    assert dec._shadow_light == ((0.2, 0.9, 0.3), 1.0)
    dec.disable_shadows()
    dec.settings = dataclasses.replace(dec.settings, shading="none")
    dec.set_transfer_function(tnv.simple.tf)


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
