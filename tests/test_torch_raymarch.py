"""The port's masked wavefront (render/raymarch.py) against the JAX
package's, on the same rays and jitter, and against the NumPy oracle of
tests/test_oracle.py.

Tolerances:
- `_emit_samples` (t_x, t_y, valid and the carried t, t_cell_end, ss):
  equal bit for bit; the DDA decisions (floor of p/16, the probe past a
  wall, floor((t1 − t0)/ss)) are the same float32 operations in the same
  order in both packages;
- `_compose`: atol 1e-6 (pow in another libm);
- `raymarch` frames for none, gradient, ssh and shadow shading under the
  four transforms of tests/test_oracle.py: atol 2e-5 (the float32 sums of
  the gradient and the shading in another order; the emission is exact);
- against the oracle, rtol = atol = 5e-4, as tests/test_oracle.py holds
  the JAX package's marcher;
- the neural wavefront (make_neural_sample_fn on render_params) against
  JAX's: atol 2e-2, mean ≤ 1e-3, the decode's tolerance (the two
  packages' bf16 MLPs round activations in other places,
  tests/test_torch_slice.py);
- the port's DECODED_SLAB frame against the oracle's wavefront: the slab
  compositor discretizes otherwise, so mean |diff| < 0.02 and an alpha
  correlation > 0.99, as tests/test_oracle.py::test_slab_near_oracle holds
  the JAX package's.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_oracle import _rays_for, _transforms, oracle_march

from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import EncodingConfig as JEnc
from instantvnr_tpu.config import ModelConfig as JModelConfig
from instantvnr_tpu.config import NetworkConfig as JNet
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.models.network import NeuralField as JNeuralField
from instantvnr_tpu.models.network import render_params as j_render_params
from instantvnr_tpu.render.renderer import \
    make_neural_sample_fn as j_make_neural
from instantvnr_tpu.render.renderer import reference_sample_fn as j_ref_fn
from instantvnr_tpu.render.shadow import shadow_volume_for as j_shadow_for
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import EncodingConfig, ModelConfig, NetworkConfig
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.models.network import NeuralField, params_from_numpy
from instantvnr_torch.models.network import render_params
from instantvnr_torch.render import raymarch as rm
from instantvnr_torch.render.renderer import (make_neural_sample_fn,
                                              reference_sample_fn)
from instantvnr_torch.utils.tfn import bake_transfer_function

# the module (the package's __init__ binds `raymarch` to the function)
jrm = importlib.import_module("instantvnr_tpu.render.raymarch")
DIMS = (24, 20, 16)
N = 24  # frame side
FRAME_ATOL = 2e-5
SHADINGS = ("none", "gradient", "ssh", "shadow")
TRANSFORMS = ("default", "clip", "scale", "clip+scale")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """vorts at DIMS in both packages, the default TF, each package's own
    macrocell (equal: tests/test_torch_slice.py), and a shadow volume."""
    jvol = j_synthetic_volume(DIMS, kind="vorts")
    tvol = synthetic_volume(DIMS, kind="vorts", device="cpu")
    jtf = j_bake(JTFConfig())
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    jm = jmc.build(jvol.data, jvol.dims, jtf)
    tm = mcmod.build(tvol.data, tvol.dims, ttf)
    shadow = np.asarray(j_shadow_for(jvol.data, jtf, (0.7, 0.9, 0.4)))
    return jvol, tvol, jtf, ttf, jm, tm, shadow


def _rays(case):
    xform = _transforms(DIMS)[case]
    org, dirn, t0, t1, jitter, lo, hi = _rays_for(xform, DIMS, n=N)
    return xform, org, dirn, t0, t1, jitter, lo, hi


@pytest.mark.parametrize("case", TRANSFORMS)
@pytest.mark.parametrize("k,skips", [(8, 8), (16, 1), (1, 8), (32, 8)])
def test_emit_samples_equal_jax(scene, case, k, skips):
    _, _, _, _, jm, tm, _ = scene
    _, org, dirn, t0, t1, _, _, _ = _rays(case)
    jst = jrm.init_ray_state(t0, t1)
    tst = rm.init_ray_state(_t(t0), _t(t1))
    emitted = 0
    for _ in range(3):  # three supersteps, each from the carried state
        (jt, jce, jss, *_), *jout = jrm._emit_samples(
            org, dirn, t1, jst, jm, 1.0, k, skips)
        (tt, tce, tss), *tout = rm._emit_samples(
            _t(org), _t(dirn), _t(t1), tst, tm, 1.0, k, skips)
        for got, ref in zip([tt, tce, tss] + tout, [jt, jce, jss]
                            + jout[:3]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        emitted += int(tout[2].sum())
        jst = jst._replace(t=jt, t_cell_end=jce, ss=jss)
        tst = tst._replace(t=tt, t_cell_end=tce, ss=tss)
    assert emitted > 100  # the rays hit the volume


def test_compose_matches_jax(scene):
    _, _, jtf, ttf, _, _, _ = scene
    rng = np.random.default_rng(3)
    r, k = 300, 8
    values = rng.random((r, k)).astype(np.float32)
    t_x = rng.random((r, k)).astype(np.float32) * 10
    t_y = t_x + rng.random((r, k)).astype(np.float32)
    valid = rng.random((r, k)) > 0.2
    alpha0 = rng.random(r).astype(np.float32) * 0.5
    color0 = rng.random((r, 3)).astype(np.float32) * 0.3
    rgb = rng.random((r, k, 3)).astype(np.float32)
    pos = rng.random((r, k, 3)).astype(np.float32)
    best = (np.zeros(r, np.float32), np.zeros((r, 3), np.float32),
            np.zeros((r, 3), np.float32))
    ja, jc, jb = jrm._compose(values, t_x, t_y, valid, alpha0, color0, jtf,
                              1.0, 1.3, rgb_override=rgb, track_best=best,
                              pos_obj=pos)
    ta, tc, tb = rm._compose(_t(values), _t(t_x), _t(t_y), _t(valid),
                             _t(alpha0), _t(color0), ttf, 1.0, 1.3,
                             rgb_override=_t(rgb),
                             track_best=tuple(_t(b) for b in best),
                             pos_obj=_t(pos))
    for got, ref in zip((ta, tc) + tuple(tb), (ja, jc) + tuple(jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("case", TRANSFORMS)
@pytest.mark.parametrize("shading", SHADINGS)
def test_raymarch_matches_jax(scene, shading, case):
    jvol, tvol, jtf, ttf, jm, tm, shadow = scene
    xform, org, dirn, t0, t1, jitter, lo, hi = _rays(case)
    light = jnp.asarray([-0.7, 0.9, -0.4], jnp.float32)
    js = jrm.RaymarchSettings(shading=shading)
    ts = rm.RaymarchSettings(shading=shading)
    ref = np.asarray(jrm.raymarch(
        lambda p: j_ref_fn(jvol.data, p), org, dirn, t0, t1, jm, jtf, jitter,
        js, light_dir=light, scale=xform.scale, clip_lower=lo, clip_upper=hi,
        shadow_vol=jnp.asarray(shadow)))
    stats = {}
    got = rm.raymarch(
        lambda p: reference_sample_fn(tvol.data, p), _t(org), _t(dirn),
        _t(t0), _t(t1), tm, ttf, _t(jitter), ts, light_dir=_t(light),
        scale=_t(xform.scale), clip_lower=_t(lo), clip_upper=_t(hi),
        shadow_vol=_t(shadow), stats=stats).numpy()
    assert got.shape == ref.shape == (N * N, 4) and ref[:, 3].max() > 0.3
    assert stats["supersteps"] >= 1
    np.testing.assert_allclose(got, ref, atol=FRAME_ATOL, rtol=0)


@pytest.mark.parametrize("case", TRANSFORMS)
def test_wavefront_matches_oracle(case):
    """tests/test_oracle.py's scene (sphere 32³) and rays, through the
    port's marcher."""
    from test_oracle import _transforms as oracle_transforms

    jvol = j_synthetic_volume((32, 32, 32), kind="sphere")
    tvol = synthetic_volume((32, 32, 32), kind="sphere", device="cpu")
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    tm = mcmod.build(tvol.data, tvol.dims, ttf)
    tf_np = (ttf.colors.double().numpy(), ttf.alphas.double().numpy(),
             float(ttf.range_lo), float(ttf.range_hi))
    xform = oracle_transforms(jvol.dims)[case]
    org, dirn, t0, t1, jitter, lo, hi = _rays_for(xform, jvol.dims)
    settings = rm.RaymarchSettings(shading="none")
    got = rm.raymarch(lambda p: reference_sample_fn(tvol.data, p), _t(org),
                      _t(dirn), _t(t0), _t(t1), tm, ttf, _t(jitter),
                      settings, scale=_t(xform.scale), clip_lower=_t(lo),
                      clip_upper=_t(hi)).numpy()
    want = oracle_march(tvol.data.double().numpy(),
                        tm.max_opacity.double().numpy(), tf_np,
                        np.asarray(org), np.asarray(dirn), np.asarray(t0),
                        np.asarray(t1), np.asarray(jitter), settings)
    assert want[:, 3].max() > 0.5
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_slab_frame_near_oracle():
    """The port's DECODED_SLAB frame of the oracle scene (clip+scale, an
    axis-aligned far camera) against the oracle's wavefront, as
    tests/test_oracle.py::test_slab_near_oracle holds the JAX package's."""
    from test_oracle import _transforms as oracle_transforms

    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.render.renderer import _frame_rays
    from instantvnr_torch.render.slabmarch import (SlabSettings,
                                                   camera_arrays,
                                                   principal_axis,
                                                   slab_render)
    from instantvnr_torch.render.transform import VolumeTransform

    tvol = synthetic_volume((32, 32, 32), kind="sphere", device="cpu")
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    tm = mcmod.build(tvol.data, tvol.dims, ttf)
    tf_np = (ttf.colors.double().numpy(), ttf.alphas.double().numpy(),
             float(ttf.range_lo), float(ttf.range_hi))
    jx = oracle_transforms((32, 32, 32))["clip+scale"]
    xform = VolumeTransform(*(_t(a) for a in jx))
    n = 24
    cam = Camera(eye=(3.0, 2.0, -90.0), center=(0.0, 0.0, 0.0),
                 up=(0.0, 1.0, 0.0), fovy=30.0)
    cams = camera_arrays(cam, "cpu")
    axis, flipped = principal_axis(cam, xform.scale.numpy())
    got = slab_render(tvol.data, ttf, cams, n, n, SlabSettings(), axis,
                      flipped, None, xform).numpy()
    org, dirn, t0, t1, _, _, _ = _frame_rays(
        n, n, cams, torch.tensor([32.0, 32.0, 32.0]),
        torch.tensor([0.7, 0.9, 0.4]), xform)
    want = oracle_march(tvol.data.double().numpy(),
                        tm.max_opacity.double().numpy(), tf_np,
                        org.numpy(), dirn.numpy(), t0.numpy(), t1.numpy(),
                        0.5 * np.ones(n * n), rm.RaymarchSettings())
    diff = np.abs(got - want)
    assert want[:, 3].max() > 0.5
    assert diff.mean() < 0.02, diff.mean()
    assert np.corrcoef(got[:, 3], want[:, 3])[0, 1] > 0.99


@pytest.mark.parametrize("shading", ["none", "gradient", "ssh"])
def test_neural_wavefront_matches_jax(scene, shading):
    """make_neural_sample_fn on render_params, each package's own, with the
    same weights (a 2-level model, its table scaled to ±0.5 so the field
    is not constant), rays and jitter; the ground truth's macrocell."""
    _, _, jtf, ttf, jm, tm, _ = scene
    enc = dict(n_levels=2, n_features_per_level=4, log2_hashmap_size=10)
    net = dict(n_neurons=16, n_hidden_layers=2)
    jfield = JNeuralField.from_config(JModelConfig(encoding=JEnc(**enc),
                                                   network=JNet(**net)))
    field = NeuralField.from_config(ModelConfig(
        encoding=EncodingConfig(**enc), network=NetworkConfig(**net)))
    rng = np.random.default_rng(7)
    spec = field.spec
    params_np = {
        "table": rng.uniform(-0.5, 0.5, (spec.n_entries, spec.n_features)
                             ).astype(np.float32),
        "mlp": [(rng.standard_normal(s) * np.sqrt(2.0 / s[0])).astype(
            np.float32) for s in ((8, 16), (16, 16), (16, 1))]}
    jp = j_render_params({"table": jnp.asarray(params_np["table"]),
                          "mlp": [jnp.asarray(w) for w in params_np["mlp"]]},
                         jfield)
    tp = render_params(params_from_numpy(params_np, "cpu"), field)
    _, org, dirn, t0, t1, jitter, _, _ = _rays("default")
    js = jrm.RaymarchSettings(shading=shading, n_iters=8)
    ts = rm.RaymarchSettings(shading=shading, n_iters=8)
    jfn = j_make_neural(jfield)
    ref = np.asarray(jrm.raymarch(lambda p: jfn(jp, p), org, dirn, t0, t1,
                                  jm, jtf, jitter, js))
    fn = make_neural_sample_fn(field)
    got = rm.raymarch(lambda p: fn(tp, p), _t(org), _t(dirn), _t(t0), _t(t1),
                      tm, ttf, _t(jitter), ts).numpy()
    assert ref[:, 3].max() > 0.05
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)
    assert np.abs(got - ref).mean() <= 1e-3


def test_network_apply_chunked_matches_whole():
    field = NeuralField.from_config(ModelConfig(
        encoding=EncodingConfig(n_levels=2, n_features_per_level=2,
                                log2_hashmap_size=8),
        network=NetworkConfig(n_neurons=16, n_hidden_layers=1)))
    from instantvnr_torch.models.network import (init_params, network_apply,
                                                 network_apply_chunked)

    params = init_params(torch.Generator().manual_seed(0), field, "cpu")
    coords = torch.rand((1000, 3), generator=torch.Generator().manual_seed(1))
    whole = network_apply(params, coords, field)
    got = network_apply_chunked(params, coords, field, chunk=300)
    assert got.shape == (1000, 1)
    torch.testing.assert_close(got, whole, rtol=0, atol=0)


def test_schedule_knobs_raise_naming_roadmap(scene, monkeypatch):
    """The JAX package's schedule knobs of RaymarchSettings run in the
    port (the compacted path, render/compaction.py; samples_per_slot in
    the emission): each gives the masked march's frame bit for bit, from
    the same jitter, on buckets small enough that a 24² frame compacts.
    Invalid settings still raise."""
    from instantvnr_torch.render import compaction as comp
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.render.renderer import Renderer

    monkeypatch.setattr(comp, "_MIN_BUCKET", 64)
    monkeypatch.setattr(comp, "_FINISH_BUCKET", 128)
    _, tvol, _, ttf, _, tm, _ = scene
    jit = [torch.rand(N * N, generator=torch.Generator().manual_seed(i))
           for i in range(3)]

    def frames(**kw):
        r = Renderer(N, N, tm, ttf, reference_sample_fn, sample_ctx=tvol.data,
                     settings=rm.RaymarchSettings(max_supersteps=64, **kw))
        r.set_camera(Camera(eye=(20.0, 10.0, -50.0), center=(0, 0, 0),
                            up=(0, 1, 0), fovy=50))
        it = iter(jit)
        r._next_jitter = lambda: next(it)
        out = []
        for _ in jit:
            r.render()
            out.append(r.mapframe())
        return out, r

    want, _ = frames()
    assert want[0][..., 3].max() > 0.05
    for kw in ({}, {"tiles": 2}, {"tiles": 3}, {"speculate": 1},
               {"samples_per_slot": 2}, {"schedule_replay": False},
               {"deferred_validation": False}, {"fused_replay": False},
               {"finish_bucket": 64}):
        got, r = frames(compact=True, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=str(kw))
        caches = [r._sched_cache] + [c for c in r._sched_cache.values()
                                     if isinstance(c, dict)]
        replays = sum(c.get("replays", 0) for c in caches)
        assert replays >= (kw.get("schedule_replay", True)), kw
        assert any(op[0] == "C" for c in caches for op in c.get("ops", ())) \
            or not kw.get("schedule_replay", True), kw
    with pytest.raises(ValueError, match="shading"):
        rm.RaymarchSettings(shading="pathtrace")
    for kw in ({"tiles": 0}, {"samples_per_slot": 0}):
        with pytest.raises(ValueError, match="at least 1"):
            rm.RaymarchSettings(**kw)


def test_stuck_rays_stop_at_max_supersteps(scene):
    """A ray whose interval to t_far is under 1e-6 in an occupied cell can
    never emit and stays active, as in the JAX package (and the
    reference): the march ends at max_supersteps, not before. The SSH
    shadow rays of real frames have such rays."""
    _, tvol, _, ttf, _, tm, _ = scene
    occ = tm.max_opacity
    cz, cy, cx = np.unravel_index(int(occ.argmax()), tuple(occ.shape))
    assert float(occ.max()) > 0
    r = 64
    centre = torch.tensor([cx, cy, cz], dtype=torch.float32) * 16 + 4.0
    org = centre.expand(r, 3).contiguous()
    dirn = torch.nn.functional.normalize(
        torch.randn((r, 3), generator=torch.Generator().manual_seed(0)),
        dim=-1)
    t0 = torch.full((r,), 0.5)
    t1 = torch.nextafter(t0, torch.full_like(t0, 1.0))  # one ulp, 6e-8
    stats = {}
    out = rm.raymarch(lambda p: reference_sample_fn(tvol.data, p), org, dirn,
                      t0, t1, tm, ttf, torch.rand(r),
                      rm.RaymarchSettings(max_supersteps=7), stats=stats)
    assert stats["supersteps"] == 7 and float(out.abs().max()) == 0.0
