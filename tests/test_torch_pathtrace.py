"""The port's path tracer (render/pathtrace.py, ops/pathtrace.py) against
the JAX package's on the CPU.

The port draws its uniforms from a torch.Generator; JAX's threefry draws
cannot be matched, so the exact tests hand the port JAX's own draws: the
key chain of `instantvnr_tpu/render/pathtrace.py::pathtrace` (`k_tau,
key = split(k_pt)`, then `key, k1..k5 = split(key, 6)` an event, :194 and
:251) rebuilt here and drawn on the CPU. The facade's frames (the JAX
package runs its compacted schedule there, whose rays draw other numbers)
are compared statistically.

Tolerances:
- one event from random states: the decisions (scatter counts, shadow
  and active flags) equal, org, t, throughput and radiance within 1e-6;
  tau, the scatter directions and the restarted t_far within rtol 1e-5
  (log1p, sin and cos of the two packages' CPU libraries part by ulps);
- a 16² frame on the JAX key chain: at least 99% of the pixels within
  1e-5 (measured: all of them, the largest difference 3.6e-7);
- the facade, PATHTRACE_REFERENCE / _DECODED / _NEURAL: the mean of 48
  progressive frames within rtol 0.15 of JAX's, and each pixel's mean
  within 0.35, the band of tests/test_pathtrace.py:243.
"""
from functools import partial

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
from instantvnr_tpu.render import pathtrace as jpt
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_tpu.render.renderer import reference_sample_fn as j_ref_fn
from instantvnr_tpu.render.transform import default_transform as j_xform
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch import api
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.models.network import params_from_numpy
from instantvnr_torch.render import pathtrace as tpt
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.renderer import _frame_rays, reference_sample_fn
from instantvnr_torch.render.slabmarch import camera_arrays
from instantvnr_torch.render.transform import VolumeTransform
from instantvnr_torch.utils.tfn import bake_transfer_function

DIMS = (32, 32, 32)
EYE = (5.0, 4.0, -60.0)
FRAME_TOL, FRAME_SHARE = 1e-5, 0.99


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxUniforms:
    """The JAX tracker's draws from its key chain, as the port's uniform
    source: tau() the initial τ draw, event() the [6, R] uniforms of the
    next event (u_accept, u_tau, u_sphere (2 rows), u_rr, u_tau2)."""

    def __init__(self, k_pt):
        self.k_tau, self.key = jax.random.split(k_pt)

    def tau(self, r, device):
        return _t(jax.random.uniform(self.k_tau, (r,)))

    def event(self, r, device):
        self.key, *ks = jax.random.split(self.key, 6)
        return _t(event_uniforms(ks, r))


def event_uniforms(ks, r):
    k1, k2, k3, k4, k5 = ks
    u = jax.random.uniform
    return np.stack([np.asarray(u(k1, (r,))), np.asarray(u(k2, (r,))),
                     *np.asarray(u(k3, (r, 2))).T, np.asarray(u(k4, (r,))),
                     np.asarray(u(k5, (r,)))])


@pytest.fixture(scope="module")
def scene():
    jvol = j_synthetic_volume(DIMS, kind="vorts")
    jtf = j_bake(JTFConfig())
    tvol = synthetic_volume(DIMS, kind="vorts", device="cpu")
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    return (jvol, jtf, jmc.build(jvol.data, jvol.dims, jtf), tvol, ttf,
            mcmod.build(tvol.data, tvol.dims, ttf))


def _random_state(r, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(0.0, 32.0, (r, 3))
    d = rng.standard_normal((r, 3))
    d[: r // 40, 1] = 0.0  # axis-parallel rays
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.0, 5.0, r)
    f = np.float32
    return (org.astype(f), d.astype(f), t.astype(f),
            (t + rng.uniform(0.0, 40.0, r)).astype(f),
            rng.exponential(1.0, r).astype(f),
            rng.uniform(0.0, 1.0, (r, 3)).astype(f),
            rng.uniform(0.0, 1.0, (r, 3)).astype(f),
            rng.integers(0, 8, r).astype(np.int32), rng.random(r) < 0.4,
            rng.random(r) < 0.9)


@pytest.mark.parametrize("cell_skips", [0, 2])
def test_pt_event_matches_jax(scene, cell_skips):
    """One tracking event from random states (shadow rays, inactive rays,
    late scatter counts) with JAX's draws handed to the port."""
    jvol, jtf, jm, tvol, ttf, tm = scene
    r = 3000
    state = _random_state(r, cell_skips)
    light = np.array([0.7, 0.9, 0.4], np.float32)
    js = jpt.PathTraceSettings(cell_skips=cell_skips)
    key = jax.random.PRNGKey(3 + cell_skips)
    _, ref = jpt._pt_event(
        partial(j_ref_fn, jvol.data), js, jm, jtf,
        jpt._pt_consts(jm, js, jnp.asarray(light), None, None, None),
        jpt._PTState(*(jnp.asarray(a) for a in state)), key)
    ts = tpt.PathTraceSettings(cell_skips=cell_skips)
    got = tpt._pt_event(
        partial(reference_sample_fn, tvol.data), ts, tm,
        tpt._pt_consts(tm, ttf, ts, _t(light)),
        tpt._PTState(*(_t(a) for a in state)),
        _t(event_uniforms(jax.random.split(key, 6)[1:], r)))
    act = state[-1]
    for name, g, w in zip(tpt._PTState._fields, got, ref):
        g, w = g.numpy(), np.asarray(w)
        if name in ("t", "tau"):  # a dead ray's scratch may differ
            g, w = g[act], w[act]
        if name in ("scatter_index", "shadow", "active"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in ("tau", "dirn", "t_far"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
    # the event did something of each kind
    assert (got.scatter_index.numpy() > state[7]).any()
    assert (got.active.numpy() != act).any()
    assert (got.shadow.numpy() != state[8]).any()


def _jax_rays(n, seed, xform=None):
    cam = JCamera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=45)
    cam_arrays = (jnp.asarray(cam.eye, jnp.float32),
                  jnp.asarray(cam.center, jnp.float32),
                  jnp.asarray(cam.up, jnp.float32), jnp.float32(cam.fovy))
    return jpt._pt_rays(n, n, jpt.PathTraceSettings(max_events=160),
                        cam_arrays, DIMS, jax.random.PRNGKey(seed), xform)


_XFORMS = {"default": None,
           "clip": ((1.0, 1.0, 1.0), (2.0, 4.0, 0.0), (30.0, 20.0, 24.0)),
           "clip+scale": ((1.4, 0.8, 1.0), (0.0, 3.0, 5.0),
                          (32.0, 32.0, 27.0))}


def _xform_pair(case):
    if _XFORMS[case] is None:
        return None, None
    scale, lo, hi = (np.asarray(a, np.float32) for a in _XFORMS[case])
    jx = j_xform(DIMS)._replace(scale=jnp.asarray(scale),
                                clip_lower=jnp.asarray(lo),
                                clip_upper=jnp.asarray(hi))
    return jx, VolumeTransform(_t(scale), _t(lo), _t(hi))


@pytest.mark.parametrize("case", ["default", "clip+scale"])
def test_pt_rays_match_jax(case):
    """The path tracer's jittered rays (render/renderer.py::_frame_rays
    with JAX's jitter) against JAX's _pt_rays: a few float32 ulps."""
    jx, tx = _xform_pair(case)
    key = jax.random.PRNGKey(2)
    ref = _jax_rays(12, 2, jx)
    k_jit, _ = jax.random.split(key)
    jit2 = _t(jax.random.uniform(k_jit, (12 * 12, 2)))
    if tx is None:
        from instantvnr_torch.render.transform import default_transform

        tx = default_transform(DIMS, "cpu")
    cam = Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=45)
    got = _frame_rays(12, 12, camera_arrays(cam, "cpu"),
                      torch.tensor(DIMS, dtype=torch.float32),
                      torch.tensor([0.7, 0.9, 0.4]), tx, jitter=jit2)
    for g, w in zip(got, ref[:7]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case,seed", [("default", 0), ("default", 1),
                                       ("clip", 2), ("clip+scale", 3)])
def test_pathtrace_matches_jax_key_chain(scene, case, seed):
    """`pathtrace` on the same rays with JAX's key chain handed in: a 16²
    frame within FRAME_TOL on at least FRAME_SHARE of the pixels."""
    jvol, jtf, jm, tvol, ttf, tm = scene
    jx, _ = _xform_pair(case)
    org, dirn, t0, t1, light, lo, hi, k_pt, scale = _jax_rays(16, seed, jx)
    settings = jpt.PathTraceSettings(max_events=160)
    ref = np.asarray(jpt.pathtrace(
        partial(j_ref_fn, jvol.data), org, dirn, t0, t1, jm, jtf, k_pt,
        settings, light, scale=scale, clip_lower=lo, clip_upper=hi))
    stats = {}
    got = tpt.pathtrace(
        partial(reference_sample_fn, tvol.data), _t(org), _t(dirn), _t(t0),
        _t(t1), tm, ttf, JaxUniforms(k_pt),
        tpt.PathTraceSettings(max_events=160), _t(light), scale=_t(scale),
        clip_lower=_t(lo), clip_upper=_t(hi), stats=stats).numpy()
    share = float((np.abs(got - ref).max(-1) <= FRAME_TOL).mean())
    assert share >= FRAME_SHARE, share
    assert ref[:, 3].mean() > 0.05 and 8 <= stats["events"] <= 160


def test_active_check_stride_is_frame_neutral(scene, monkeypatch):
    """Testing any(active) every _ACTIVE_CHECK_EVERY events gives the frame
    of a test after every event, bit for bit, in no more events than the
    stride adds."""
    _, _, _, tvol, ttf, tm = scene
    org, dirn, t0, t1, light, lo, hi, k_pt, scale = _jax_rays(16, 4)
    frames, events = [], []
    for every in (1, tpt._ACTIVE_CHECK_EVERY):
        monkeypatch.setattr(tpt, "_ACTIVE_CHECK_EVERY", every)
        stats = {}
        frames.append(tpt.pathtrace(
            partial(reference_sample_fn, tvol.data), _t(org), _t(dirn),
            _t(t0), _t(t1), tm, ttf, JaxUniforms(k_pt),
            tpt.PathTraceSettings(), _t(light), scale=_t(scale),
            clip_lower=_t(lo), clip_upper=_t(hi), stats=stats))
        events.append(stats["events"])
    assert torch.equal(frames[0], frames[1])
    assert events[0] <= events[1] < events[0] + 8
    assert frames[0][:, 3].max() > 0


def test_grid_bricks_match_the_grid(scene):
    """The grid → brick pool policy: the pool (brick_sample_fn) and the
    grid (sample_volume) trace the same frame from the same draws, up to
    the trilinear sum's order (FRAME_TOL on FRAME_SHARE of the pixels)."""
    from instantvnr_torch.render.brickcache import brick_sample_fn

    _, _, _, tvol, ttf, tm = scene
    frames = []
    for grid_bricks in (False, True):
        r = tpt.PathTraceRenderer(16, 16, tm, ttf, tvol.data,
                                  settings=tpt.PathTraceSettings(
                                      grid_bricks=grid_bricks))
        assert (r.sample_fn is brick_sample_fn) == grid_bricks
        r.set_camera(Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0),
                            fovy=45))
        r._uniforms = lambda: tpt.TorchUniforms(
            torch.Generator().manual_seed(9))
        r._next_jitter = lambda: torch.full((256, 2), 0.5)
        r.render()
        frames.append(r.mapframe())
    share = float((np.abs(frames[0] - frames[1]).max(-1)
                   <= FRAME_TOL).mean())
    assert share >= FRAME_SHARE and frames[0][..., 3].max() > 0


def test_renderer_surface(scene):
    """Progressive accumulation, warmup, the camera's reset and the
    denoiser at mapframe."""
    from instantvnr_torch.render.denoise import atrous_denoise

    _, _, _, tvol, ttf, tm = scene
    r = tpt.PathTraceRenderer(16, 16, tm, ttf, tvol.data, seed=1)
    assert r.warmup() == 1 and r.frame_index == 0
    r.set_camera(Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=45))
    f1 = r.render().clone()
    for _ in range(3):
        r.render()
    assert r.frame_index == 4 and not torch.equal(f1, r._frame)
    assert r.last_stats["events"] > 0
    raw = r.mapframe()
    np.testing.assert_array_equal(
        r.mapframe(denoise=True),
        atrous_denoise(torch.from_numpy(raw)).numpy())
    r.set_camera(r.camera)
    assert r.frame_index == 0


@pytest.fixture(scope="module")
def volumes():
    """A JAX and a port NeuralVolume on vorts 32³ holding the same weights
    (params_from_numpy, a 3-level 2^12 layout), each with its
    SimpleVolume."""
    jsv = japi.SimpleVolume(j_synthetic_volume(DIMS, kind="vorts"))
    tsv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cpu")
    enc = dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=12,
               base_resolution=4)
    net = dict(n_neurons=16, n_hidden_layers=2)
    jnv = japi.NeuralVolume(JModelConfig(encoding=JEnc(**enc),
                                         network=JNet(**net)), jsv)
    tnv = api.NeuralVolume(ModelConfig(encoding=EncodingConfig(**enc),
                                       network=NetworkConfig(**net)), tsv,
                           device="cpu")
    rng = np.random.default_rng(4)
    spec = tnv.field.spec
    params_np = {
        "table": rng.uniform(-1.0, 1.0, (spec.n_entries, spec.n_features)
                             ).astype(np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((12, 16), (16, 16), (16, 1))]}
    jnv.state = jnv.state._replace(params={
        "table": jnp.asarray(params_np["table"]),
        "mlp": [jnp.asarray(w) for w in params_np["mlp"]]})
    tnv.params = params_from_numpy(params_np, "cpu")
    return jnv, tnv


@pytest.mark.parametrize("mode", ["PATHTRACE_REFERENCE", "PATHTRACE_DECODED",
                                  "PATHTRACE_NEURAL"])
def test_facade_modes_match_jax_statistically(volumes, mode):
    jnv, tnv = volumes
    n_frames = 48
    jr = japi.VNRenderer(jnv, 16, 16, japi.RenderMode[mode])
    jr.set_camera(JCamera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=45))
    tr = api.VNRenderer(tnv, 16, 16, api.RenderMode[mode])
    tr.set_camera(Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=45))
    for _ in range(n_frames):
        jr.render()
        tr.render()
    ref, got = jr.mapframe(), tr.mapframe()
    assert np.isfinite(got).all() and ref[..., 3].mean() > 0.05
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=0.15)
    np.testing.assert_allclose(got, ref, atol=0.35)
    assert tr._impl.frame_index == n_frames


def test_facade_clip_scale_and_refresh(volumes):
    """set_clipping_box / set_scaling on the three facade classes reach the
    path tracer (less opacity in a clipped box, another image scaled), and
    refresh_params re-derives PATHTRACE_DECODED's brick pool and
    PATHTRACE_NEURAL's inference params."""
    from instantvnr_torch.render.brickcache import brick_sample_fn

    _, tnv = volumes
    sv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cpu")
    cam = Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0), fovy=45)

    def frames(r, n=6):
        r.set_camera(cam)
        for _ in range(n):
            r.render()
        return r.mapframe()

    r = api.VNRenderer(sv, 16, 16, api.RenderMode.PATHTRACE_REFERENCE)
    full = frames(r)
    r.set_clipping_box((0, 0, 0), (16, 32, 32))
    assert torch.equal(sv.transform.clip_upper, torch.tensor([16.0, 32, 32]))
    half = frames(r)
    assert 0 < half[..., 3].sum() < full[..., 3].sum()
    r.set_scaling((1.5, 1.0, 1.0))
    assert np.isfinite(frames(r)).all()
    np.testing.assert_array_equal(sv.transform.scale.numpy(), [1.5, 1, 1])
    sv.set_scaling((2.0, 1.0, 1.0))
    np.testing.assert_array_equal(sv.transform.scale.numpy(), [3.0, 1, 1])

    old = tnv.transform
    try:
        rn = api.VNRenderer(tnv, 16, 16, api.RenderMode.PATHTRACE_DECODED)
        assert rn._impl.sample_fn is brick_sample_fn
        before = frames(rn, 2)
        rn.set_scaling((1.0, 1.0, 0.6))
        assert rn._impl.transform is tnv.transform
        assert not np.allclose(frames(rn, 2), before)
        ctx = rn._impl.sample_ctx
        rn.refresh_params()
        assert rn._impl.sample_ctx is not ctx
        assert rn._impl.sample_fn is brick_sample_fn
        rn.set_mode(api.RenderMode.PATHTRACE_NEURAL)
        rn.set_clipping_box((4, 0, 0), (32, 32, 28))
        assert np.isfinite(frames(rn, 2)).all()
        params = rn._impl.sample_ctx
        rn.refresh_params()
        assert rn._impl.sample_ctx is not params
        assert rn._impl.frame_index == 0
    finally:
        tnv.transform = old


# -- the compacted tracker (render/pathtrace.py::pathtrace_compacted) --------

jcomp = __import__("instantvnr_tpu.render.compaction", fromlist=["_bucket"])


@pytest.fixture
def pt_buckets(monkeypatch):
    """Buckets small enough that a 24² frame compacts, in both packages."""
    from instantvnr_torch.render import compaction as comp

    for mod in (comp, jcomp):
        monkeypatch.setattr(mod, "_MIN_BUCKET", 128)


@pytest.mark.parametrize("case,seed", [("default", 0), ("clip+scale", 3)])
def test_pathtrace_compacted_matches_jax_key_chain(scene, pt_buckets, case,
                                                   seed):
    """pathtrace_compacted against JAX's on the same rays, with JAX's key
    chain handed in (an event draws [6, m] at the prefix size m, as JAX's
    split(key, 6) does): the same recorded schedule, compactions
    included, and the frame within FRAME_TOL on FRAME_SHARE of the pixels
    (test_pathtrace_matches_jax_key_chain's band)."""
    jvol, jtf, jm, tvol, ttf, tm = scene
    jx, _ = _xform_pair(case)
    org, dirn, t0, t1, light, lo, hi, k_pt, scale = _jax_rays(24, seed, jx)
    kw = dict(max_events=160, finish_bucket=128)
    jcache, tcache = {}, {}
    ref = np.asarray(jpt.pathtrace_compacted(
        j_ref_fn, org, dirn, t0, t1, jm, jtf, k_pt,
        jpt.PathTraceSettings(**kw), light, sample_ctx=jvol.data,
        scale=scale, clip_lower=lo, clip_upper=hi, schedule_cache=jcache))
    got = tpt.pathtrace_compacted(
        reference_sample_fn, _t(org), _t(dirn), _t(t0), _t(t1), tm, ttf,
        JaxUniforms(k_pt), tpt.PathTraceSettings(**kw), _t(light),
        sample_ctx=tvol.data, scale=_t(scale), clip_lower=_t(lo),
        clip_upper=_t(hi), schedule_cache=tcache).numpy()
    assert any(op[0] == "C" for op in jcache["ops"])
    assert tcache["ops"] == jcache["ops"]
    share = float((np.abs(got - ref).max(-1) <= FRAME_TOL).mean())
    assert share >= FRAME_SHARE, share
    assert ref[:, 3].mean() > 0.05


@pytest.mark.parametrize("finish_bucket", [8192, 0])
def test_compacted_bit_parity_without_compaction(scene, finish_bucket):
    """While nothing compacts (16² rays, under the 8192 bucket floor) the
    compacted tracker draws what the masked one does: the same frame bit
    for bit, through the finisher and through per-dispatch event chunks
    (JAX's test_uncompacted_bit_parity and its _chunked twin)."""
    jvol, jtf, jm, tvol, ttf, tm = scene
    org, dirn, t0, t1, light, lo, hi, k_pt, scale = _jax_rays(16, 1)
    args = [_t(a) for a in (org, dirn, t0, t1)]
    kw = dict(scale=_t(scale), clip_lower=_t(lo), clip_upper=_t(hi))
    settings = tpt.PathTraceSettings(max_events=160,
                                     finish_bucket=finish_bucket)
    masked = tpt.pathtrace(partial(reference_sample_fn, tvol.data), *args,
                           tm, ttf, JaxUniforms(k_pt), settings, _t(light),
                           **kw)
    cache = {}
    got = tpt.pathtrace_compacted(reference_sample_fn, *args, tm, ttf,
                                  JaxUniforms(k_pt), settings, _t(light),
                                  sample_ctx=tvol.data, schedule_cache=cache,
                                  **kw)
    assert not any(op[0] == "C" for op in cache["ops"])
    assert torch.equal(got, masked) and float(got[:, 3].max()) > 0


def test_compacted_statistical_parity(scene, monkeypatch):
    """Twin of JAX's test_compacted_statistical_parity: the mean of 48
    progressive frames of a renderer whose schedule compacts (and replays,
    and fuses) against the masked tracker's, in JAX's band (rtol 0.15 on
    the mean, atol 0.35 a pixel)."""
    from instantvnr_torch.render import compaction as comp

    monkeypatch.setattr(comp, "_MIN_BUCKET", 32)
    _, _, _, tvol, ttf, tm = scene
    means = {}
    for compact in (False, True):
        r = tpt.PathTraceRenderer(
            16, 16, tm, ttf, tvol.data, seed=11,
            settings=tpt.PathTraceSettings(max_events=160, compact=compact,
                                           finish_bucket=32))
        r.set_camera(Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0),
                            fovy=45))
        compacted = False
        for _ in range(48):
            r.render()
            compacted |= any(op[0] == "C"
                             for op in r._sched_cache.get("ops", ()))
        means[compact] = r.mapframe()
        if compact:
            cache = r._sched_cache
            assert compacted and cache.get("replays", 0) >= 8
            assert cache.get("fused_frames", 0) >= 1
    assert np.isfinite(means[True]).all()
    np.testing.assert_allclose(means[True].mean(), means[False].mean(),
                               rtol=0.15)
    np.testing.assert_allclose(means[True], means[False], atol=0.35)


def test_facade_pathtrace_uses_compaction(volumes):
    """Twin of test_pathtrace.py:149: the facade's PT modes run the
    compacted tracker, which records its schedule."""
    _, tnv = volumes
    r = api.VNRenderer(tnv, 16, 16, api.RenderMode.PATHTRACE_REFERENCE)
    assert r._impl.settings.compact
    r.render()
    assert r._impl._sched_cache.get("ops") is not None


def test_compacted_warmup_leaves_the_draws(scene):
    """warmup() of a compacted tracker runs its bucket family and leaves
    the generator and the accumulation as they were: the first frame is an
    unwarmed renderer's."""
    _, _, _, tvol, ttf, tm = scene
    frames = []
    for warm in (True, False):
        r = tpt.PathTraceRenderer(16, 16, tm, ttf, tvol.data, seed=4,
                                  settings=tpt.PathTraceSettings(
                                      compact=True, max_events=160))
        r.set_camera(Camera(eye=EYE, center=(0, 0, 0), up=(0, 1, 0),
                            fovy=45))
        if warm:
            assert r.warmup() == 1 and r.frame_index == 0
        r.render()
        frames.append(r.mapframe())
    np.testing.assert_array_equal(frames[0], frames[1])
