"""The port's frame orchestration (render/renderer.py, render/denoise.py,
the wavefront modes of api.VNRenderer and both degenerate-camera
fallbacks) against the JAX package's, with the JAX package's jitter handed
to the port (torch's generators cannot draw threefry's numbers).

Tolerances:
- ray setup (camera_rays, look_at_rays, _frame_rays, ray_box_intersect):
  rtol = atol = 1e-6, a few float32 ulps (the norm of normalize and tan
  are other libraries' roundings);
- wavefront frames of the ground truth (progressive accumulation, the
  REFERENCE_* modes and FULL_SHADOW_REFERENCE, the slab path's wavefront
  fallback): atol 2e-5, as tests/test_torch_raymarch.py holds the marcher
  (the JAX modes run its compacted path, bit-identical to the masked
  one by its own tests);
- NEURAL_WAVEFRONT*: atol 2e-2, mean ≤ 1e-3, the decode's tolerance
  (bf16 MLPs round in other places);
- atrous_denoise: atol 1e-6;
- the brute-force isosurface fallback: the hit masks agree on all but
  0.5% of the pixels (a crossing within float32 noise of the isovalue may
  flip), and the shaded colors of the pixels both hit within 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu import api as japi
from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_tpu.render.camera import camera_rays as j_camera_rays
from instantvnr_tpu.render.decoded import DecodedRenderer as JDecoded
from instantvnr_tpu.render.denoise import atrous_denoise as j_denoise
from instantvnr_tpu.render.isosurf import IsoRenderer as JIso
from instantvnr_tpu.render.raymarch import RaymarchSettings as JRS
from instantvnr_tpu.render.renderer import Renderer as JRenderer
from instantvnr_tpu.render.renderer import _frame_rays as j_frame_rays
from instantvnr_tpu.render.renderer import reference_sample_fn as j_ref_fn
from instantvnr_tpu.render.slabmarch import SlabSettings as JSlabSettings
from instantvnr_tpu.render.transform import VolumeTransform as JXform
from instantvnr_tpu.utils import math as jmath
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch import api
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.models.network import params_from_numpy
from instantvnr_torch.render.camera import Camera, camera_rays
from instantvnr_torch.render.decoded import DecodedRenderer
from instantvnr_torch.render.denoise import atrous_denoise
from instantvnr_torch.render.isosurf import IsoRenderer
from instantvnr_torch.render.raymarch import RaymarchSettings
from instantvnr_torch.render.renderer import (Renderer, _frame_rays,
                                              reference_sample_fn)
from instantvnr_torch.render.slabmarch import SlabSettings, camera_arrays
from instantvnr_torch.render.transform import VolumeTransform
from instantvnr_torch.utils import math as tmath
from instantvnr_torch.utils.tfn import bake_transfer_function

RAY_ATOL, RAY_RTOL = 1e-6, 1e-6
FRAME_ATOL = 2e-5
DIMS = (24, 24, 24)
N = 24
EYE = (5.0, 4.0, -50.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jcam(eye=EYE, center=(0.0, 0.0, 0.0), fovy=45.0):
    return JCamera(eye=eye, center=center, up=(0.0, 1.0, 0.0), fovy=fovy)


def _cam(eye=EYE, center=(0.0, 0.0, 0.0), fovy=45.0):
    return Camera(eye=eye, center=center, up=(0.0, 1.0, 0.0), fovy=fovy)


def _jcam_arrays(c):
    return (jnp.asarray(c.eye, jnp.float32), jnp.asarray(c.center,
                                                         jnp.float32),
            jnp.asarray(c.up, jnp.float32), jnp.float32(c.fovy))


def _jitters(seed, n_frames, r):
    """The jitter of the JAX Renderer's first frames (seed's key split
    once a frame)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_frames):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (r,), jnp.float32)))
    return out


def _xforms(dims):
    d = np.asarray(dims, np.float32)
    return {
        "default": (np.ones(3), np.zeros(3), d),
        "clip": (np.ones(3), np.array([4.0, 6.0, 8.0]),
                 np.array([20.0, 18.0, 16.0])),
        "scale": (np.array([1.0, 1.6, 0.55]), np.zeros(3), d),
        "clip+scale": (np.array([0.8, 1.3, 1.0]), np.array([2.0, 0.0, 5.0]),
                       np.array([22.0, 24.0, 20.0])),
    }


@pytest.fixture(scope="module")
def volumes():
    jsv = japi.SimpleVolume(j_synthetic_volume(DIMS, kind="vorts"))
    tsv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cpu")
    return jsv, tsv


# -- ray setup ----------------------------------------------------------------


@pytest.mark.parametrize("case", ["default", "clip", "scale", "clip+scale"])
def test_frame_rays_match_jax(case):
    scale, lo, hi = (np.asarray(a, np.float32) for a in _xforms(DIMS)[case])
    jx = JXform(*(jnp.asarray(a) for a in (scale, lo, hi)))
    tx = VolumeTransform(*(_t(a) for a in (scale, lo, hi)))
    light = np.array([0.7, 0.9, 0.4], np.float32)
    ref = j_frame_rays(N, N + 4, _jcam_arrays(_jcam()),
                       jnp.asarray(DIMS, jnp.float32), jnp.asarray(light), jx)
    got = _frame_rays(N, N + 4, camera_arrays(_cam(), "cpu"),
                      torch.tensor(DIMS, dtype=torch.float32), _t(light), tx)
    for name, g, r in zip(("org", "dirn", "t0", "t1", "light", "lo", "hi"),
                          got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=RAY_ATOL,
                                   rtol=RAY_RTOL, err_msg=name)
    assert float(got[3].max()) > 0  # rays hit the box


def test_ray_helpers_match_jax():
    rng = np.random.default_rng(2)
    cam = _jcam(eye=(3.0, -7.0, 40.0), center=(1.0, 2.0, 0.0), fovy=60.0)
    jit = rng.random((20 * 12, 2)).astype(np.float32)
    for jitter in (None, jit):
        ref = j_camera_rays(cam, 20, 12, None if jitter is None
                            else jnp.asarray(jitter))
        got = camera_rays(_cam(eye=cam.eye, center=cam.center, fovy=60.0),
                          20, 12, None if jitter is None else _t(jitter))
        ref2 = jmath.look_at_rays(cam.eye, cam.center, cam.up, 60.0, 20, 12,
                                  None if jitter is None
                                  else jnp.asarray(jitter))
        got2 = tmath.look_at_rays(cam.eye, cam.center, cam.up, 60.0, 20, 12,
                                  None if jitter is None else _t(jitter))
        for g, r in zip(got + got2, ref + ref2):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       atol=RAY_ATOL, rtol=RAY_RTOL)
    org = rng.uniform(-5, 30, (200, 3)).astype(np.float32)
    dirn = rng.standard_normal((200, 3)).astype(np.float32)
    dirn[:10, 0] = 0.0  # axis-parallel rays
    org[:5, 0] = 0.0  # on the slab plane of a parallel axis: a graze
    lo, hi = np.zeros(3, np.float32), np.array([24, 20, 16], np.float32)
    ref = jmath.ray_box_intersect(org, dirn, lo, hi)
    got = tmath.ray_box_intersect(_t(org), _t(dirn), _t(lo), _t(hi))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=RAY_ATOL,
                                   rtol=RAY_RTOL)
    p = rng.uniform(-12, 12, (50, 3)).astype(np.float32)
    for jfn, fn in ((jmath.world_to_object, tmath.world_to_object),
                    (jmath.object_to_world, tmath.object_to_world)):
        np.testing.assert_allclose(fn(_t(p), (24, 20, 16)).numpy(),
                                   np.asarray(jfn(p, (24, 20, 16))),
                                   atol=1e-6, rtol=0)


# -- frames -------------------------------------------------------------------


def test_progressive_accumulation_matches_jax(volumes):
    """Two frames of the Renderer (its masked, uncompacted path), the port
    fed the JAX Renderer's jitter."""
    jsv, tsv = volumes
    jr = JRenderer(N, N, jsv.macrocell, jsv.tf, j_ref_fn,
                   sample_ctx=jsv.volume.data,
                   settings=JRS(shading="gradient"), seed=5)
    jr.set_camera(_jcam())
    tr = Renderer(N, N, tsv.macrocell, tsv.tf, reference_sample_fn,
                  sample_ctx=tsv.volume.data,
                  settings=RaymarchSettings(shading="gradient"), seed=5)
    jit = iter(_jitters(5, 2, N * N))
    tr._next_jitter = lambda: _t(next(jit))
    tr.set_camera(_cam())
    frames = []
    for i in range(2):
        jr.render()
        tr.render()
        ref, got = jr.mapframe(), tr.mapframe()
        np.testing.assert_allclose(got, ref, atol=FRAME_ATOL, rtol=0)
        frames.append(got)
        assert tr.frame_index == i + 1 and tr.last_stats["supersteps"] >= 1
    assert ref[..., 3].max() > 0.3 and not np.array_equal(*frames)
    tr.set_camera(_cam())  # a camera resets the accumulation
    assert tr.frame_index == 0


@pytest.mark.parametrize("mode", ["REFERENCE_RAYMARCH", "REFERENCE_GRADIENT",
                                  "REFERENCE_SSH", "FULL_SHADOW_REFERENCE"])
def test_reference_modes_match_jax(volumes, mode):
    jsv, tsv = volumes
    jr = japi.VNRenderer(jsv, N, N, japi.RenderMode[mode])
    jr.set_camera(_jcam())
    jr.render()
    ref = jr.mapframe()
    tr = api.VNRenderer(tsv, N, N, api.RenderMode[mode])
    jit = _jitters(0, 1, N * N)[0]
    tr._impl._next_jitter = lambda: _t(jit)
    tr.set_camera(_cam())
    tr.render()
    got = tr.mapframe()
    assert ref[..., 3].max() > 0.3
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL, rtol=0)


@pytest.fixture(scope="module")
def neural(volumes):
    jsv, tsv = volumes
    enc = dict(n_levels=2, n_features_per_level=4, log2_hashmap_size=10)
    net = dict(n_neurons=16, n_hidden_layers=2)
    jnv = japi.NeuralVolume(JModelConfig(encoding=JEnc(**enc),
                                         network=JNet(**net)), jsv)
    tnv = api.NeuralVolume(ModelConfig(encoding=EncodingConfig(**enc),
                                       network=NetworkConfig(**net)), tsv,
                           device="cpu")
    rng = np.random.default_rng(4)
    spec = tnv.field.spec
    params_np = {
        "table": rng.uniform(-0.5, 0.5, (spec.n_entries, spec.n_features)
                             ).astype(np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((8, 16), (16, 16), (16, 1))]}
    jnv.state = jnv.state._replace(params={
        "table": jnp.asarray(params_np["table"]),
        "mlp": [jnp.asarray(w) for w in params_np["mlp"]]})
    tnv.params = params_from_numpy(params_np, "cpu")
    return jnv, tnv


@pytest.mark.parametrize("mode", ["NEURAL_WAVEFRONT",
                                  "NEURAL_WAVEFRONT_GRADIENT",
                                  "NEURAL_WAVEFRONT_SSH"])
def test_neural_modes_match_jax(neural, mode):
    jnv, tnv = neural
    jr = japi.VNRenderer(jnv, N, N, japi.RenderMode[mode],
                         streaming_cache="none")
    jr.set_camera(_jcam())
    jr.render()
    ref = jr.mapframe()
    tr = api.VNRenderer(tnv, N, N, api.RenderMode[mode],
                        streaming_cache="none")
    jit = _jitters(0, 1, N * N)[0]
    tr._impl._next_jitter = lambda: _t(jit)
    tr.set_camera(_cam())
    tr.render()
    got = tr.mapframe()
    assert ref[..., 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)
    assert np.abs(got - ref).mean() <= 1e-3


def test_streaming_caches_and_pathtracer_raise(neural, volumes):
    """What still raises around the streaming caches and the path tracer:
    an unknown policy, a mode without its volume, and a budget of events
    that events_per_dispatch does not divide. The schedule knobs of the
    JAX package's compacted tracker run: each gives the masked tracker's
    frame from the same draws (an 8² frame never compacts), and so does
    the facade's NEURAL_WAVEFRONT (the policies and the path tracer
    themselves: tests/test_torch_brickcache.py,
    tests/test_torch_pathtrace.py)."""
    from instantvnr_torch.render.pathtrace import (PathTraceRenderer,
                                                   PathTraceSettings,
                                                   TorchUniforms)

    _, tnv = neural
    with pytest.raises(ValueError, match="streaming_cache"):
        api.VNRenderer(tnv, 8, 8, api.RenderMode.NEURAL_WAVEFRONT,
                       streaming_cache="pool")
    r = api.VNRenderer(tnv, 8, 8, streaming_cache="auto")  # DECODED_SLAB
    with pytest.raises(ValueError, match="streaming_cache"):
        r.set_streaming_cache("bricks")
    no_gt = api.NeuralVolume(tnv.cfg, dims=DIMS, device="cpu")
    for mode in (api.RenderMode.REFERENCE_RAYMARCH,
                 api.RenderMode.PATHTRACE_REFERENCE):
        with pytest.raises(ValueError, match="SimpleVolume"):
            api.VNRenderer(no_gt, 8, 8, mode)
    with pytest.raises(ValueError, match="events_per_dispatch"):
        PathTraceSettings(events_per_dispatch=3)
    _, tsv = volumes

    def pt_frame(**kw):
        pr = PathTraceRenderer(8, 8, tsv.macrocell, tsv.tf, tsv.volume.data,
                               settings=PathTraceSettings(**kw))
        pr._uniforms = lambda: TorchUniforms(torch.Generator().manual_seed(2))
        pr._next_jitter = lambda: torch.full((64, 2), 0.5)
        pr.render()
        return pr.mapframe()

    want = pt_frame()
    for kw in ({}, {"events_per_dispatch": 8}, {"finish_bucket": 0},
               {"speculate": 1}, {"schedule_replay": False},
               {"deferred_validation": False}, {"fused_replay": False}):
        np.testing.assert_array_equal(pt_frame(compact=True, **kw), want,
                                      err_msg=str(kw))
    r.set_streaming_cache("none")
    r.set_mode(api.RenderMode.NEURAL_WAVEFRONT)
    r.render()
    assert r.mapframe().shape == (8, 8, 4)


def test_atrous_denoise_matches_jax():
    rgba = np.random.default_rng(6).random((18, 22, 4)).astype(np.float32)
    ref = np.asarray(j_denoise(jnp.asarray(rgba)))
    got = atrous_denoise(_t(rgba)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_denoiser_applies_at_mapframe(volumes):
    _, tsv = volumes
    r = api.VNRenderer(tsv, N, N, api.RenderMode.REFERENCE_RAYMARCH)
    r.set_camera(_cam())
    r.render()
    raw = r.mapframe()
    r.set_denoiser(True)
    np.testing.assert_allclose(r.mapframe(),
                               atrous_denoise(_t(raw)).numpy(), atol=0,
                               rtol=0)


# -- degenerate cameras -------------------------------------------------------


@pytest.fixture(scope="module")
def sphere():
    jvol = j_synthetic_volume((32, 32, 32), kind="sphere")
    tvol = synthetic_volume((32, 32, 32), kind="sphere", device="cpu")
    jtf = j_bake(JTFConfig())
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    return (jvol, jtf, jmc.build(jvol.data, jvol.dims, jtf), tvol, ttf,
            mcmod.build(tvol.data, tvol.dims, ttf))


@pytest.mark.parametrize("shading", ["none", "gradient"])
def test_decoded_fallback_matches_jax(sphere, shading):
    """tests/test_slabmarch.py:78's camera inside the volume: both
    packages march the grid with the wavefront; the port's jitter is JAX's
    PRNGKey(0) draw."""
    jvol, jtf, jm, tvol, ttf, tm = sphere
    w = h = 12
    jd = JDecoded(w, h, jm, jtf, jvol.dims, initial_volume=jvol.data,
                  settings=JSlabSettings(shading=shading))
    td = DecodedRenderer(w, h, tm, ttf, tvol.dims, initial_volume=tvol.data,
                         settings=SlabSettings(shading=shading),
                         device="cpu")
    jit = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (w * h,),
                                        jnp.float32))
    td._fallback_jitter = lambda: _t(jit)
    eye, center = (1.0, 2.0, 3.0), (14.0, 2.0, 3.0)
    jd.set_camera(JCamera(eye=eye, center=center, up=(0, 1, 0)))
    td.set_camera(Camera(eye=eye, center=center, up=(0, 1, 0)))
    jd.render()
    td.render()
    ref, got = jd.mapframe(), td.mapframe()
    assert ref[..., 3].max() > 0.5  # through the dense centre
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL, rtol=0)


def test_brute_iso_fallback_matches_jax(sphere):
    """tests/test_isosurface.py:253's camera inside the volume, looking
    diagonally with a wide fov: the brute-force first-hit marcher."""
    jvol, jtf, _, tvol, ttf, _ = sphere
    w = h = 32
    eye, center = (2.0, 1.0, 0.0), (14.0, 13.0, 12.0)
    jr = JIso(w, h, jvol.data, jtf, isovalue=0.6)
    tr = IsoRenderer(w, h, tvol.data, ttf, isovalue=0.6, device="cpu")
    jr.set_camera(JCamera(eye=eye, center=center, up=(0, 1, 0), fovy=120))
    tr.set_camera(Camera(eye=eye, center=center, up=(0, 1, 0), fovy=120))
    jr.render()
    tr.render()
    ref, got = jr.mapframe(), tr.mapframe()
    hit_r, hit_g = ref[..., 3] > 0.5, got[..., 3] > 0.5
    assert hit_r.sum() > 20
    assert (hit_r != hit_g).mean() <= 0.005
    both = hit_r & hit_g
    np.testing.assert_allclose(got[both], ref[both], atol=1e-3, rtol=0)


def test_api_fallbacks_render(neural):
    """The facade's degenerate cameras render through the fallbacks (the
    test of the refusal they replace: test_torch_package.py)."""
    _, tnv = neural
    back = Camera(eye=(0.0, 0.0, 2.0), center=(0.0, 0.0, 6.0), up=(0, 1, 0),
                  fovy=179.0)
    for mode in (api.RenderMode.DECODED_SLAB,
                 api.RenderMode.ISOSURFACE_DECODED):
        r = api.VNRenderer(tnv, 8, 8, mode)
        r.set_camera(back)
        r.render()
        f = r.mapframe()
        assert f.shape == (8, 8, 4) and np.isfinite(f).all()
