"""The facade's remaining surface (ROADMAP Queue 1 item 8) against the JAX
package's, on the CPU: RenderMode.requires_decoding, TransferFunctionObject
and the setters that take it (SimpleVolume / VNRenderer
.set_transfer_function, VNRenderer.set_framebuffer_size), load_json /
save_json, save_inference_volume / save_reference_volume, the camera
handle (Camera.from_scene, set, position, focus, up_vec), set_model,
reset_accumulation, memory_query and free_temporary_memory.

The same weights (numpy, from a seed) go into both packages. A frame after
a setter is compared on the same decoded grid (the JAX decoder's grid put
into the port's decoder), at FRAME_ATOL of tests/test_torch_renderer.py,
2e-5: the setters must leave the slab path as the JAX package leaves it.
The decodes themselves differ by the fused MLP's tolerance (atol 2e-2,
mean 1e-3, tests/test_torch_fused_mlp.py), which also holds the decoded
volume that save_inference_volume writes.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu import api as japi
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_torch import api
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.models.network import params_from_numpy
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.utils.tfn import bake_transfer_function

FRAME_ATOL = 2e-5  # tests/test_torch_renderer.py
DECODE_ATOL, DECODE_MEAN = 2e-2, 1e-3  # tests/test_torch_fused_mlp.py
DIMS = (16, 16, 16)
N = 12
ENC = dict(n_levels=2, n_features_per_level=4, log2_hashmap_size=10)
NET = dict(n_neurons=16, n_hidden_layers=2)
CAM = dict(eye=(3.0, 2.5, -38.0), center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
           fovy=45.0)
RED = ((0.0, 1.0, 0.0, 0.0), (1.0, 1.0, 0.0, 0.0))
ALPHA = ((0.0, 0.0), (0.3, 0.6), (1.0, 0.9))


def _params_np(n_entries, n_features, seed=4):
    rng = np.random.default_rng(seed)
    return {"table": rng.uniform(-0.5, 0.5, (n_entries, n_features)
                                 ).astype(np.float32),
            "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
                np.float32) for s in ((8, 16), (16, 16), (16, 1))]}


def _pair(simple=True):
    """(JAX NeuralVolume, port NeuralVolume) on vorts 16³ with the same
    weights; simple=False: no ground truth (a loaded model's case)."""
    jsv = japi.SimpleVolume(j_synthetic_volume(DIMS, kind="vorts"))
    tsv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cpu")
    jcfg = JModelConfig(encoding=JEnc(**ENC), network=JNet(**NET))
    tcfg = ModelConfig(encoding=EncodingConfig(**ENC),
                       network=NetworkConfig(**NET))
    if simple:
        jnv = japi.NeuralVolume(jcfg, jsv)
        tnv = api.NeuralVolume(tcfg, tsv, device="cpu")
    else:
        jnv = japi.NeuralVolume(jcfg, dims=DIMS)
        tnv = api.NeuralVolume(tcfg, dims=DIMS, device="cpu")
        # the ground truth's macrocell stands in for a checkpoint's
        tnv.macrocell = tsv.macrocell
        jnv.macrocell = jsv.macrocell
    spec = tnv.field.spec
    p = _params_np(spec.n_entries, spec.n_features)
    jnv.state = jnv.state._replace(params={
        "table": jnp.asarray(p["table"]),
        "mlp": [jnp.asarray(w) for w in p["mlp"]]})
    tnv.params = params_from_numpy(p, "cpu")
    return jnv, tnv


@pytest.fixture(scope="module")
def nets():
    return _pair()


def _renderers(jnv, tnv, mode="DECODED_SLAB", size=(N, N)):
    jr = japi.VNRenderer(jnv, *size, mode=japi.RenderMode[mode])
    jr.set_camera(JCamera(**CAM))
    tr = api.VNRenderer(tnv, *size, mode=api.RenderMode[mode])
    tr.set_camera(Camera(**CAM))
    return jr, tr


def _same_grid(jr, tr):
    """The JAX decoder's grid in the port's decoder, so that the frames
    compare the slab path alone."""
    tr._impl.decoded = torch.from_numpy(np.array(jr._impl.decoded))


def _frames(jr, tr):
    jr.render()
    tr.render()
    ref, got = np.asarray(jr.mapframe()), tr.mapframe()
    assert got.shape == ref.shape and np.isfinite(got).all()
    return ref, got


def test_requires_decoding_matches_jax():
    assert len(api.RenderMode) == len(japi.RenderMode) == 14
    for jm in japi.RenderMode:
        tm = api.RenderMode(int(jm))
        assert tm.name == jm.name
        assert tm.requires_decoding == jm.requires_decoding


def test_tf_object_getters_match_jax():
    jtf, ttf = japi.TransferFunctionObject(), api.TransferFunctionObject()
    assert ttf.get_color() == jtf.get_color()
    assert ttf.get_alpha() == jtf.get_alpha()
    assert ttf.get_value_range() == jtf.get_value_range()
    for h in (jtf, ttf):
        h.set_color([(0, 1, 0, 0), (0.5, 0.2, 0.4, 0.6), (1, 1, 0, 0)])
        h.set_alpha(np.asarray(ALPHA))
        h.set_value_range(0.1, 0.9)
    assert ttf.get_color() == jtf.get_color()
    assert ttf.get_color()[1] == (0.5, 0.2, 0.4, 0.6)
    assert ttf.get_alpha() == jtf.get_alpha() == ALPHA
    assert all(type(v) is float for p in ttf.get_alpha() for v in p)
    assert ttf.get_value_range() == jtf.get_value_range() == (0.1, 0.9)
    assert dataclasses.asdict(ttf.cfg) == dataclasses.asdict(jtf.cfg)
    cfg = TransferFunctionConfig(alphas=ALPHA)
    assert api._tf_config(cfg) is cfg
    assert api._tf_config(api.TransferFunctionObject(cfg)) is cfg


@pytest.mark.parametrize("how", ["handle", "config"])
def test_set_transfer_function_frame_matches_jax(nets, how):
    jnv, tnv = nets
    jr, tr = _renderers(jnv, tnv)
    _same_grid(jr, tr)
    f0, g0 = _frames(jr, tr)
    np.testing.assert_allclose(g0, f0, atol=FRAME_ATOL, rtol=0)
    if how == "handle":
        jtf, ttf = japi.TransferFunctionObject(), api.TransferFunctionObject()
        for h in (jtf, ttf):
            h.set_color(RED)
            h.set_alpha(ALPHA)
    else:
        jtf = JTFConfig(colors=RED, alphas=ALPHA)
        ttf = TransferFunctionConfig(colors=RED, alphas=ALPHA)
    jr.set_transfer_function(jtf)
    tr.set_transfer_function(ttf)
    ref, got = _frames(jr, tr)
    assert not np.allclose(ref, f0)
    hit = ref[..., 3] > 0.05
    assert hit.any() and np.abs(ref[..., 1][hit]).max() < 0.15
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL, rtol=0)
    # the SimpleVolume took the TF, its macrocell the new max opacity
    assert tr.simple.tfn_cfg == api._tf_config(ttf)
    np.testing.assert_allclose(tr.simple.macrocell.max_opacity.numpy(),
                               np.asarray(jr.simple.macrocell.max_opacity),
                               atol=1e-6)
    # back to the default TF for the module's other tests
    jr.set_transfer_function(JTFConfig())
    tr.set_transfer_function(TransferFunctionConfig())


def test_renderer_level_tf_reaches_cached_decoder(nets):
    """The twin of tests/test_api.py::
    test_renderer_level_tf_reaches_cached_decoder: a TF edit through the
    renderer reaches the decoder that the neural volume caches, its TF and
    its macrocell's max opacity."""
    jnv, tnv = nets
    jr, tr = _renderers(jnv, tnv)
    dec = tnv.get_decoder()
    tr.render()
    f0 = tr.mapframe()
    red = TransferFunctionConfig(colors=RED)
    tr.set_transfer_function(red)
    assert tr._impl is dec  # the cached decoder, not a new one
    assert dec.tf is tr.simple.tf
    np.testing.assert_array_equal(dec.mc.max_opacity.numpy(),
                                  tr.simple.macrocell.max_opacity.numpy())
    tr.render()
    f1 = tr.mapframe()
    assert not np.allclose(f0, f1)
    hit = f1[..., 3] > 0.05
    assert hit.any() and np.abs(f1[..., 1][hit]).max() < 0.15
    tr.set_transfer_function(TransferFunctionConfig())


def test_renderer_tf_without_ground_truth():
    """Without a SimpleVolume the TF is the renderer's own: the slab
    decoder takes it (frame as JAX's), and the macrocell the wavefront and
    the path tracer read carries its max opacity (the JAX package keeps
    the default TF's there)."""
    jnv, tnv = _pair(simple=False)
    jr, tr = _renderers(jnv, tnv)
    _same_grid(jr, tr)
    cfg = TransferFunctionConfig(colors=RED, alphas=((0.0, 0.4), (1.0, 0.9)))
    jr.set_transfer_function(JTFConfig(colors=RED,
                                       alphas=((0.0, 0.4), (1.0, 0.9))))
    tr.set_transfer_function(api.TransferFunctionObject(cfg))
    ref, got = _frames(jr, tr)
    assert ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL, rtol=0)
    tf = bake_transfer_function(cfg, device="cpu")
    want = mcmod.update_max_opacity(tnv.macrocell, tf).max_opacity
    tr.set_mode(api.RenderMode.PATHTRACE_NEURAL)
    np.testing.assert_array_equal(tr._impl.mc.max_opacity.numpy(),
                                  want.numpy())
    assert not torch.equal(tnv.macrocell.max_opacity, want)


def test_edge_pixel_grazing_ray_is_uncovered():
    """At 10 x 7 the ray through intermediate row 6 meets slab 8 (z = 8.5)
    at y = 16 exactly, on the volume's top face: outside the open interval
    0 < y < 16 where the volume covers a pixel, so nothing there is
    composited. Exact rational arithmetic on the frame's float32 geometry
    says so. The float32 chain of _per_slab_state rounds the point inside
    (15.999998); testing coverage on it gave the screen pixel (6, 5)
    alpha 0.013 where the exact test gives 0."""
    from fractions import Fraction

    from instantvnr_torch.render import slabmarch as sm

    tsv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cpu")
    tnv = api.NeuralVolume(ModelConfig(encoding=EncodingConfig(**ENC),
                                       network=NetworkConfig(**NET)), tsv,
                           device="cpu")
    spec = tnv.field.spec
    tnv.params = params_from_numpy(_params_np(spec.n_entries,
                                              spec.n_features), "cpu")
    tr = api.VNRenderer(tnv, 10, 7, mode=api.RenderMode.DECODED_SLAB)
    cam = Camera(**CAM)
    tr.set_camera(cam)
    axis, flipped = sm.principal_axis(cam)
    assert (axis, flipped) == (2, False)
    dims_w = torch.tensor(DIMS, dtype=torch.float32)
    geo = sm.frame_geometry(dims_w, 16, 16, 16, sm.camera_arrays(cam, "cpu"),
                            tr._impl.transform, (0, 1, 2), False, 1.0, 10, 7)
    e = [Fraction(float(c)) for c in geo.e]
    z_ref = Fraction(float(geo.z_ref))
    y_lo, y_hi = (Fraction(float(b)) for b in geo.bounds[2:])
    z8 = Fraction(17, 2)
    y_row6 = y_lo + Fraction(13, 2) * (y_hi - y_lo) / 7
    assert e[1] + (y_row6 - e[1]) * (z8 - e[2]) / (z_ref - e[2]) == 16
    z_ks, _, _, _, y_src = sm._per_slab_state(geo.e, geo.z_ref, geo.xs,
                                              geo.ys, 16, 16, 16)
    assert float(y_src[8, 6]) < 16.0  # the float32 chain's rounding
    covy, _ = sm._coverage_masks(geo, z_ks, 16, 16,
                                 torch.ones(16, dtype=torch.bool))
    assert covy[8, 6] == 0 and covy[7, 6] == 1
    tr.render()
    frame = tr.mapframe()
    assert frame[..., 3].max() > 0.05
    np.testing.assert_array_equal(frame[5, 6], np.zeros(4, np.float32))


def test_set_framebuffer_size_matches_jax(nets):
    jnv, tnv = nets
    jr, tr = _renderers(jnv, tnv)
    _same_grid(jr, tr)
    # at 10 x 7, pixel (6, 5)'s ray grazes the volume's top face in slab 8
    # (test_edge_pixel_grazing_ray_is_uncovered)
    jr.set_framebuffer_size(10, 7)
    tr.set_framebuffer_size(10, 7)
    assert (tr.width, tr.height) == (10, 7)
    ref, got = _frames(jr, tr)
    assert got.shape == (7, 10, 4) and ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL, rtol=0)
    # the path tracer's accumulation restarts at the new size
    tr.set_mode(api.RenderMode.PATHTRACE_DECODED)
    tr.render()
    tr.render()
    assert tr._impl.frame_index == 2
    tr.set_framebuffer_size(N, N)
    assert tr._impl.frame_index == 0
    tr.render()
    assert tr.mapframe().shape == (N, N, 4)


def test_simple_volume_set_transfer_function_matches_jax():
    dims = (48, 48, 48)  # 27 macrocells
    jsv = japi.SimpleVolume(j_synthetic_volume(dims, kind="vorts"))
    tsv = api.SimpleVolume.synthetic(dims, "vorts", device="cpu")
    jtf, ttf = japi.TransferFunctionObject(), api.TransferFunctionObject()
    for h in (jtf, ttf):
        h.set_alpha(((0.0, 0.0), (0.45, 0.0), (0.5, 0.8), (1.0, 0.1)))
        h.set_value_range(0.0, 1.0)
    jsv.set_transfer_function(jtf)
    tsv.set_transfer_function(ttf)
    assert tsv.tfn_cfg == ttf.cfg
    got = tsv.macrocell.max_opacity.numpy()
    np.testing.assert_allclose(got, np.asarray(jsv.macrocell.max_opacity),
                               atol=1e-6)
    assert got.min() < got.max()  # the TF's step shows per cell
    for name in ("colors", "alphas"):
        np.testing.assert_allclose(getattr(tsv.tf, name).numpy(),
                                   np.asarray(getattr(jsv.tf, name)),
                                   atol=1e-6)


@pytest.mark.parametrize("ext", [".json", ".bson", ".params"])
def test_json_docs_cross_packages(tmp_path, ext):
    doc = {"a": 1, "nested": {"b": [1.5, 2.5], "s": "x", "t": True},
           "f": -0.25}
    for writer, reader in ((api.save_json, japi.load_json),
                           (japi.save_json, api.load_json)):
        path = str(tmp_path / f"d{ext}")
        writer(doc, path)
        assert reader(path) == doc
        assert api.load_json(path) == japi.load_json(path)
    with open(str(tmp_path / f"d{ext}"), "rb") as f:
        head = f.read(1)
    assert (head == b"{") == (ext == ".json")


def test_json_text_with_comments_and_forced_binary(tmp_path):
    path = tmp_path / "c.json"
    path.write_text('{\n  // a comment\n  "k": 2, /* and */ "u": "a//b"\n}')
    assert api.load_json(str(path)) == japi.load_json(str(path)) == {
        "k": 2, "u": "a//b"}
    b = str(tmp_path / "forced.json")
    api.save_json({"k": [1, 2]}, b, binary=True)
    assert japi.load_json(b) == api.load_json(b) == {"k": [1, 2]}


def test_save_volumes_match_jax(nets, tmp_path):
    jnv, tnv = nets
    paths = {k: str(tmp_path / f"{k}.raw")
             for k in ("jref", "tref", "jinf", "tinf")}
    jnv.save_reference_volume(paths["jref"])
    tnv.save_reference_volume(paths["tref"])
    with open(paths["jref"], "rb") as a, open(paths["tref"], "rb") as b:
        assert a.read() == b.read()
    jnv.save_inference_volume(paths["jinf"])
    tnv.save_inference_volume(paths["tinf"])
    ref = np.fromfile(paths["jinf"], np.float32)
    got = np.fromfile(paths["tinf"], np.float32)
    assert got.size == ref.size == np.prod(DIMS)
    np.testing.assert_allclose(got, ref, atol=DECODE_ATOL, rtol=0)
    assert np.abs(got - ref).mean() <= DECODE_MEAN
    # a .vdb path writes an OpenVDB FloatGrid of the same decode
    # (data/vdb.py; tests/test_torch_vdb.py holds its layout)
    from instantvnr_torch.data.vdb import read_vdb

    tnv.save_inference_volume(str(tmp_path / "v.vdb"))
    dense, info = read_vdb(str(tmp_path / "v.vdb"))
    assert info.bbox_min == (0, 0, 0) and dense.shape == DIMS[::-1]
    np.testing.assert_array_equal(dense.reshape(-1), got)
    no_gt = api.NeuralVolume(tnv.cfg, dims=DIMS, device="cpu")
    with pytest.raises(ValueError, match="reference volume"):
        no_gt.save_reference_volume(str(tmp_path / "r.raw"))


def test_camera_handle_matches_jax(tmp_path):
    jc = JCamera.default_for_dims((32, 32, 32))
    tc = Camera.default_for_dims((32, 32, 32))
    kw = dict(eye=np.array([1, 2, 3]), center=(0, 0.5, 0), up=[0, 1, 0])
    j2, t2 = jc.set(**kw), tc.set(**kw)
    assert (t2.position, t2.focus, t2.up_vec, t2.fovy) == (
        j2.position, j2.focus, j2.up_vec, j2.fovy)
    assert t2.position == (1.0, 2.0, 3.0) and t2.fovy == tc.fovy
    assert tc.set(fovy=30).fovy == jc.set(fovy=30).fovy == 30.0
    assert tc.set() == tc
    scene = tmp_path / "scene.json"
    scene.write_text("""{
      "version": "1.0",
      "dataSource": [{"fileName": "missing.raw", "dimensions":
        {"x": 4, "y": 4, "z": 4}, "type": "FLOAT32", "endian": "LITTLE",
        "fileUpperLeft": false, "offset": 0}],
      "view": {"camera": {"eye": {"x": 5, "y": 6, "z": 7},
        "center": {"x": 0, "y": 0, "z": 1}, "up": {"x": 0, "y": 1, "z": 0},
        "fovy": 30}}
    }""")
    j3, t3 = JCamera.from_scene(str(scene)), Camera.from_scene(str(scene))
    assert dataclasses.asdict(t3) == dataclasses.asdict(j3)
    assert t3.position == (5.0, 6.0, 7.0) and t3.focus == (0.0, 0.0, 1.0)


def test_set_model_resets_as_jax():
    """tests/test_api.py::test_set_model_resets on both packages."""
    jnv, tnv = _pair()
    for nv, cfg in ((jnv, JModelConfig(encoding=JEnc(**ENC),
                                       network=JNet(n_neurons=16))),
                    (tnv, ModelConfig(encoding=EncodingConfig(**ENC),
                                      network=NetworkConfig(n_neurons=16)))):
        nv.train_batch = 512
        nv.train(3)
        assert nv.get_training_step() == 3
        nv.set_model(dataclasses.replace(
            cfg, network=dataclasses.replace(cfg.network, n_neurons=32)))
        assert nv.get_training_step() == 0
        assert nv.cfg.network.n_neurons == 32
        nv.train(2)
        assert nv.get_training_step() == 2
    assert [tuple(w.shape) for w in tnv.params["mlp"]] == [
        tuple(w.shape) for w in jnv.state.params["mlp"]]


def test_reset_accumulation_as_jax():
    """tests/test_api.py::test_reset_accumulation on both packages."""
    jsv = japi.SimpleVolume.synthetic(dims=(12, 12, 12), kind="sphere")
    tsv = api.SimpleVolume.synthetic((12, 12, 12), "sphere", device="cpu")
    for r in (japi.VNRenderer(jsv, width=8, height=8,
                              mode=japi.RenderMode.PATHTRACE_REFERENCE),
              api.VNRenderer(tsv, width=8, height=8,
                             mode=api.RenderMode.PATHTRACE_REFERENCE)):
        for _ in range(3):
            r.render()
        assert r._impl.frame_index == 3
        r.reset_accumulation()
        assert r._impl.frame_index == 0
        r.render()
        assert np.isfinite(np.asarray(r.mapframe())).all()


def test_memory_query_and_free_on_cpu():
    got = api.memory_query()
    ref = japi.memory_query()
    # no statistics on the CPU, in either package (JAX lists each of its
    # CPU devices)
    assert got == {"cpu": {}}
    assert ref and all(v == {} for v in ref.values())
    assert api.free_temporary_memory() is None
    json.dumps(got)
