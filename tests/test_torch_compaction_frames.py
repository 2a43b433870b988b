"""The port's compacted frames (render/compaction.py::raymarch_compacted,
the Renderer with compact=True) against JAX's and against the port's own
masked march, on the CPU.

- raymarch_compacted equals JAX's in each shading on JAX's test scene
  (sphere 32³, 40² rays, buckets shrunk so that the frame compacts): the
  recorded ops are equal and the frame within FRAME_ATOL of JAX's (the two
  packages' CPU arithmetic parts by ulps, tests/test_torch_raymarch.py);
  the port's compacted frame equals its masked frame bit for bit (on the
  CPU each superstep samples the same rows in the same order).
- Twins of tests/test_compaction.py (tiles, the bump into tile bands, the
  midpoint ladder, the compact flag, samples_per_slot, warmup): each frame
  bit for bit the masked march's or the untiled one's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_compaction_scene import (DIMS, _jax_rays, _renderer, _t, jcomp,
                                    jrm, scene, small_buckets)

from instantvnr_tpu.render.renderer import reference_sample_fn as j_ref_fn
from instantvnr_torch.render import compaction as comp
from instantvnr_torch.render import raymarch as rm
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.renderer import reference_sample_fn

FRAME_ATOL = 2e-5
SHADINGS = ("none", "gradient", "ssh", "shadow")


# -- raymarch_compacted against JAX's ----------------------------------------


@pytest.mark.parametrize("shading", SHADINGS)
def test_compacted_matches_jax_and_masked(scene, small_buckets, shading):
    jvol, tvol, jtf, ttf, jm, tm, shadow = scene
    org, dirn, t0, t1, jitter = _jax_rays(40)
    # the SSH shadow march runs to max_supersteps (rays stuck within 1e-6
    # of t_far, tests/test_torch_raymarch.py): a short budget keeps it fast
    settings_kw = dict(shading=shading,
                       max_supersteps=24 if shading == "ssh" else 64)
    light = np.array([0.7, 0.9, 0.4], np.float32)
    light = light / np.linalg.norm(light)
    jshadow = jnp.asarray(shadow) if shading == "shadow" else None
    tshadow = _t(shadow) if shading == "shadow" else None
    jcache, tcache = {}, {}
    jout = jcomp.raymarch_compacted(
        j_ref_fn, org, dirn, t0, t1, jm, jtf, jitter,
        jrm.RaymarchSettings(**settings_kw), light_dir=jnp.asarray(light),
        sample_ctx=jvol.data, shadow_vol=jshadow, schedule_cache=jcache)
    tin = [_t(a) for a in (org, dirn, t0, t1)]
    settings = rm.RaymarchSettings(**settings_kw)
    tout = comp.raymarch_compacted(
        reference_sample_fn, *tin, tm, ttf, _t(jitter), settings,
        light_dir=_t(light), sample_ctx=tvol.data, shadow_vol=tshadow,
        schedule_cache=tcache)
    masked = rm.raymarch(lambda p: reference_sample_fn(tvol.data, p), *tin,
                         tm, ttf, _t(jitter), settings, light_dir=_t(light),
                         shadow_vol=tshadow)
    assert tcache["ops"] == jcache["ops"]
    assert any(op[0] == "C" for op in tcache["ops"])
    torch.testing.assert_close(tout, masked, rtol=0, atol=0)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=FRAME_ATOL)
    assert float(tout[:, 3].max()) > 0.1


# -- twins of tests/test_compaction.py ----------------------------------------


@pytest.mark.parametrize("tiles", [2, 4, 3])
def test_tiled_matches_untiled(scene, small_buckets, tiles):
    frames = {}
    for t_ in (1, tiles):
        r = _renderer(scene, tiles=t_)
        fs = []
        for _ in range(3):
            r.render()
            fs.append(r.mapframe())
        frames[t_] = fs
        if t_ > 1:
            assert r._sched_cache["tile0"].get("replays", 0) >= 1
    for a, b in zip(frames[1], frames[tiles]):
        np.testing.assert_array_equal(a, b)


def test_tiled_ssh_matches_untiled(scene, small_buckets):
    frames = {}
    for t_ in (1, 2):
        r = _renderer(scene, size=32, seed=2, tiles=t_, shading="ssh",
                      max_supersteps=24)
        r.render()
        frames[t_] = r.mapframe()
    np.testing.assert_array_equal(frames[1], frames[2])


def test_bump_propagates_to_tile_bands(scene, monkeypatch):
    monkeypatch.setattr(comp, "_MIN_BUCKET", 64)
    monkeypatch.setattr(comp, "_FINISH_BUCKET", 128)
    cam2 = Camera(eye=(1.2 * DIMS[0], 10, 6), center=(0, 0, 0), up=(0, 1, 0),
                  fovy=55)
    frames = {}
    for replay in (False, True):
        r = _renderer(scene, size=32, seed=13, tiles=2,
                      schedule_replay=replay)
        r.render()
        r.render()
        r.set_camera(cam2)
        if replay:
            assert r._sched_cache.get("bump_next") is True
        r.render()
        if replay:
            assert "bump_next" not in r._sched_cache
            for i in range(2):
                assert "bump_next" not in r._sched_cache.get(f"tile{i}", {})
        frames[replay] = r.mapframe()
    np.testing.assert_array_equal(frames[True], frames[False])


def test_midpoint_buckets_bit_identical(scene, monkeypatch):
    monkeypatch.setattr(comp, "_MIN_BUCKET", 256)
    monkeypatch.setattr(comp, "_FINISH_BUCKET", 384)
    frames = {}
    for mid in (False, True):
        monkeypatch.setattr(comp, "_MIDPOINT_BUCKETS", mid)
        r = _renderer(scene, seed=7)
        for _ in range(3):
            r.render()
        frames[mid] = r.mapframe()
    np.testing.assert_array_equal(frames[True], frames[False])


def test_renderer_compact_flag(scene):
    """compact=True gives compact=False's frames (the same jitter)."""
    frames = []
    for compact in (False, True):
        r = _renderer(scene, seed=3)
        r.settings = rm.RaymarchSettings(compact=compact)
        r.render()
        frames.append(r.mapframe())
    np.testing.assert_array_equal(frames[1], frames[0])


def test_samples_per_slot_bit_identical(scene):
    """Twin of test_compaction.py:503: S samples a slot re-chunk the march
    only."""
    frames = {}
    for k, s in ((8, 1), (4, 2), (2, 4), (8, 2)):
        r = _renderer(scene, size=32, seed=4, n_iters=k, samples_per_slot=s)
        r.render()
        frames[(k, s)] = r.mapframe()
    assert frames[(8, 1)][..., 3].max() > 0.1
    for key in ((4, 2), (2, 4), (8, 2)):
        np.testing.assert_array_equal(frames[key], frames[(8, 1)])


def test_warmup_precompiles_and_matches(scene, small_buckets):
    """warmup() runs the bucket family without disturbing the output."""
    kw = dict(n_iters=4)
    r1 = _renderer(scene, size=40, seed=0, **kw)
    n = r1.warmup()
    assert n == len(comp.bucket_sizes(40 * 40)) >= 2
    assert r1.frame_index == 0
    f1 = r1.render().clone()
    r2 = _renderer(scene, size=40, seed=0, **kw)
    torch.testing.assert_close(f1, r2.render(), rtol=0, atol=0)
