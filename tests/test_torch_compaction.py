"""The port's compacted wavefront (render/compaction.py, ops/compaction.py)
against the JAX package's (instantvnr_tpu/render/compaction.py) and against
the port's own masked march, on the CPU.

- The schedule functions (_bucket, _next_bucket, bucket_sizes,
  bump_schedule, strip_counts) equal JAX's, with the midpoint ladder on
  and off.
- The plain compact_rows equals JAX's _compact_body exactly (it moves
  values, computes none), and scatter_rows JAX's _unpermute, on seeded
  numpy state at m = 2^16.
- raymarch_compacted equals JAX's in each shading on JAX's test scene
  (sphere 32³, 40² rays, buckets shrunk so that the frame compacts): the
  recorded ops are equal and the frame within FRAME_ATOL of JAX's (the two
  packages' CPU arithmetic parts by ulps, tests/test_torch_raymarch.py);
  the port's compacted frame equals its masked frame bit for bit (on the
  CPU each superstep samples the same rows in the same order).
- Twins of tests/test_compaction.py:68-500 on the port (tiles, bump,
  replay, deferred validation, an invalid replay's rollback, fused
  against replay, a camera change, a resize with a pending frame, an
  all-miss frame, samples_per_slot, warmup): each frame bit for bit the
  masked march's or the serialized path's, except the rolled-back frame
  (within 1e-5: the accumulation's subtract and re-add, as in JAX).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantvnr_tpu.accel import macrocell as jmc
from instantvnr_tpu.config import TransferFunctionConfig as JTFConfig
from instantvnr_tpu.data import synthetic_volume as j_synthetic_volume
from instantvnr_tpu.render import camera_rays as j_camera_rays
from instantvnr_tpu.render.camera import Camera as JCamera
from instantvnr_tpu.render.renderer import reference_sample_fn as j_ref_fn
from instantvnr_tpu.render.shadow import shadow_volume_for as j_shadow_for
from instantvnr_tpu.utils.math import ray_box_intersect as j_box
from instantvnr_tpu.utils.tfn import bake_transfer_function as j_bake
from instantvnr_torch.accel import macrocell as mcmod
from instantvnr_torch.config import TransferFunctionConfig
from instantvnr_torch.data.volume import synthetic_volume
from instantvnr_torch.ops import compaction as ops
from instantvnr_torch.render import compaction as comp
from instantvnr_torch.render import raymarch as rm
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.renderer import Renderer, reference_sample_fn
from instantvnr_torch.utils.tfn import bake_transfer_function

jcomp = __import__("instantvnr_tpu.render.compaction",
                   fromlist=["_bucket"])
jrm = __import__("instantvnr_tpu.render.raymarch", fromlist=["raymarch"])

DIMS = (32, 32, 32)
FRAME_ATOL = 2e-5
SHADINGS = ("none", "gradient", "ssh", "shadow")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """JAX's test scene (tests/test_compaction.py:27) in both packages."""
    jvol = j_synthetic_volume(DIMS, kind="sphere")
    tvol = synthetic_volume(DIMS, kind="sphere", device="cpu")
    jtf = j_bake(JTFConfig())
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    jm = jmc.build(jvol.data, jvol.dims, jtf)
    tm = mcmod.build(tvol.data, tvol.dims, ttf)
    shadow = np.asarray(j_shadow_for(jvol.data, jtf, (0.7, 0.9, 0.4)))
    return jvol, tvol, jtf, ttf, jm, tm, shadow


def _jax_rays(n=64):
    """tests/test_compaction.py::_rays."""
    cam = JCamera.default_for_dims(DIMS)
    org_w, dirn = j_camera_rays(cam, n, n)
    d = jnp.array(DIMS, jnp.float32)
    org = org_w + 0.5 * d
    t0, t1, hit = j_box(org, dirn, jnp.zeros(3), d)
    t0 = jnp.where(hit, jnp.maximum(t0, 0.0), 1.0)
    t1 = jnp.where(hit, t1, 0.0)
    jitter = jax.random.uniform(jax.random.PRNGKey(7), (org.shape[0],))
    return org, dirn, t0, t1, jitter


@pytest.fixture
def small_buckets(monkeypatch):
    """Buckets small enough that a 48² frame compacts (JAX's tests use the
    same), in both packages."""
    for mod in (comp, jcomp):
        monkeypatch.setattr(mod, "_MIN_BUCKET", 256)
        monkeypatch.setattr(mod, "_FINISH_BUCKET", 512)


# -- the schedule functions --------------------------------------------------

COUNTS = (1, 8191, 8192, 8193, 12288, 12289, 20000, 24577, 65535, 65536,
          100000, 196608, 196609, 262143, 262144)


@pytest.mark.parametrize("midpoints", [False, True])
@pytest.mark.parametrize("r", [65536, 262144, 589824 // 3, 1 << 20])
def test_bucket_ladder_equals_jax(monkeypatch, midpoints, r):
    for mod in (comp, jcomp):
        monkeypatch.setattr(mod, "_MIDPOINT_BUCKETS", midpoints)
    for c in COUNTS:
        assert comp._bucket(c, r) == jcomp._bucket(c, r), c
        assert comp._next_bucket(c, r) == jcomp._next_bucket(c, r), c
    assert comp.bucket_sizes(r) == jcomp.bucket_sizes(r)


def test_ladder_at_512_squared():
    """The midpoint ladder at R = 512²: 11 sizes."""
    assert comp.bucket_sizes(512 * 512) == [
        262144, 196608, 131072, 98304, 65536, 49152, 32768, 24576, 16384,
        12288, 8192]
    assert comp._MIN_BUCKET == 8192 and comp._FINISH_BUCKET == 32768


@pytest.mark.parametrize("midpoints", [False, True])
def test_bump_and_strip_equal_jax(monkeypatch, midpoints):
    for mod in (comp, jcomp):
        monkeypatch.setattr(mod, "_MIDPOINT_BUCKETS", midpoints)
    r = 1 << 20
    recorded = [("S", r), ("C", 98304, 90000), ("S", 98304),
                ("C", 12288, 9000), ("S", 12288), ("F", 8192)]
    assert comp.strip_counts(recorded) == jcomp.strip_counts(recorded)
    for ops_ in (comp.strip_counts(recorded),
                 (("C", 98304), ("C", 131072), ("F", 131072)),
                 (("C", 8192), ("S", 8192), ("F", 8192))):
        got = comp.bump_schedule(ops_, r)
        assert got == jcomp.bump_schedule(ops_, r)
        assert comp.bump_schedule(got, r) == jcomp.bump_schedule(got, r)
    assert comp._fusable(recorded) and not comp._fusable(recorded[:-1])


def test_motion_bump_is_one_rung(monkeypatch):
    """Under motion a replayed compaction runs one rung above its recorded
    bucket, as bump_schedule (the fused path) does, also where the count
    sat within the headroom (JAX stacks the two bumps, two rungs: a
    reference fault the port does not copy, ROADMAP Queue 3)."""

    class Frame:
        finish_steps = 0

        def __init__(self):
            self.compactions = []

        def initial(self):
            pass

        def count_handle(self):
            return 10 ** 6

        def superstep(self, m):
            return 10 ** 6

        def finish(self, m, budget):
            pass

        def compact(self, m):
            self.compactions.append(m)

    monkeypatch.setattr(comp, "_MIDPOINT_BUCKETS", True)
    r = 1 << 20
    # the count 98000 sits within the headroom of its bucket 98304
    recorded = [("S", r), ("C", 98304, 98000), ("S", 98304), ("F", 98304)]
    for bump, want in ((False, 131072), (True, 131072)):
        cache = {"ops": list(recorded)}
        frame = Frame()
        comp._replay(r, frame, 192, 1, 1 << 17, 0, cache, defer=True,
                     bump=bump)
        assert cache["pending"][0][1] == want
    assert comp.bump_schedule(comp.strip_counts(recorded), r)[1] == (
        "C", 131072)
    # JAX's _replay of the same record under motion goes two rungs up
    assert jcomp._next_bucket(jcomp._next_bucket(98304, r), r) == 196608


def test_bucket_schedule(monkeypatch):
    """Twin of test_compaction.py::test_bucket_schedule."""
    monkeypatch.setattr(comp, "_MIDPOINT_BUCKETS", False)
    assert comp._bucket(1, 1 << 20) == 8192
    assert comp._bucket(8193, 1 << 20) == 16384
    assert comp._bucket(1 << 20, 1 << 18) == 1 << 18


# -- the kernels' plain versions ----------------------------------------------


def _state(m, seed):
    rng = np.random.default_rng(seed)
    return {"org": rng.uniform(0, 32, (m, 3)).astype(np.float32),
            "dirn": rng.standard_normal((m, 3)).astype(np.float32),
            "t_far": rng.uniform(0, 50, m).astype(np.float32),
            "jitter": rng.random(m).astype(np.float32),
            "t": rng.uniform(0, 9, m).astype(np.float32),
            "alpha": rng.random(m).astype(np.float32),
            "color": rng.random((m, 3)).astype(np.float32),
            "active": rng.random(m) < 0.37,
            "best_pos": rng.random((m, 3)).astype(np.float32),
            "si": rng.integers(0, 9, m).astype(np.int32)}


@pytest.mark.parametrize("prefix", [1 << 16, 40000])
def test_compact_rows_equals_jax_compact_body(prefix):
    """The plain compact_rows on the prefix [0:prefix] of m = 2^16 rows
    against JAX's _compact_body on the same numpy state: every leaf equal
    bit for bit, the rows past the prefix untouched, the count."""
    from collections import namedtuple

    m = 1 << 16
    st = _state(m, 5)
    names = sorted(st)
    perm = np.arange(m, dtype=np.int32)
    jst = namedtuple("State", names)(*(jnp.asarray(st[n]) for n in names))
    _, jout, jperm = jcomp._compact_body(prefix, (), jst, jnp.asarray(perm))
    jstate = jout._asdict()
    leaves = [_t(st[n]) for n in names] + [_t(perm)]
    views = [x[:prefix] for x in leaves]
    scratch = [torch.empty_like(x) for x in views]
    count = torch.zeros(1, dtype=torch.int32)
    order = torch.zeros(prefix, dtype=torch.int32)
    ops.compact_rows(_t(st["active"])[:prefix].contiguous(), views, scratch,
                     count=count, order=order, copy_back=True)
    for n, got in zip(names, leaves):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jstate[n]),
                                      err_msg=n)
    np.testing.assert_array_equal(leaves[-1].numpy(), np.asarray(jperm))
    assert int(count) == int(st["active"][:prefix].sum())
    live = st["active"][:prefix]
    np.testing.assert_array_equal(
        order.numpy(), np.concatenate([np.nonzero(live)[0],
                                       np.nonzero(~live)[0]]))


def test_scatter_rows_equals_jax_unpermute():
    m = 1 << 16
    rng = np.random.default_rng(2)
    perm = rng.permutation(m).astype(np.int32)
    st = _state(m, 3)
    want = jcomp._unpermute(jnp.asarray(perm), st["color"], st["alpha"],
                            st["t"], st["best_pos"], st["org"])
    leaves = [_t(st[n]) for n in ("color", "alpha", "t", "best_pos", "org")]
    outs = [torch.empty_like(x) for x in leaves]
    ops.scatter_rows(_t(perm), leaves, outs)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_count_forms_on_the_cpu():
    """The wrappers' device-side row count on CPU tensors (their plain
    versions): the rows under the count equal the call without one, the
    rows past it are 0; a count is refused under autograd."""
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig)
    from instantvnr_torch.models.network import (NeuralField, init_params,
                                                 network_apply_chunked)
    from instantvnr_torch.ops.brick_sample import brick_sample
    from instantvnr_torch.render.brickcache import build_brick_cache_from_grid

    field = NeuralField.from_config(ModelConfig(
        encoding=EncodingConfig(n_levels=2, n_features_per_level=2,
                                log2_hashmap_size=8),
        network=NetworkConfig(n_neurons=16, n_hidden_layers=1),
        compute_dtype="bfloat16"))
    params = init_params(torch.Generator().manual_seed(0), field, "cpu")
    p = torch.rand((1000, 3), generator=torch.Generator().manual_seed(1))
    count = torch.tensor([613], dtype=torch.int32)
    whole = network_apply_chunked(params, p, field, chunk=300)
    part = network_apply_chunked(params, p, field, chunk=300, count=count)
    torch.testing.assert_close(part[:613], whole[:613], rtol=0, atol=0)
    assert not part[613:].any()
    vol = synthetic_volume(DIMS, kind="sphere", device="cpu")
    ttf = bake_transfer_function(TransferFunctionConfig(), device="cpu")
    ctx = build_brick_cache_from_grid(vol.data,
                                      mcmod.build(vol.data, vol.dims, ttf))
    args = (ctx["lut"], ctx["packed"], p, ctx["dims"], ctx["mcdims"])
    whole = brick_sample(*args)
    part = brick_sample(*args, count=count)
    torch.testing.assert_close(part[:613], whole[:613], rtol=0, atol=0)
    assert not part[613:].any()
    params["table"].requires_grad_(True)
    with pytest.raises(ValueError, match="inference only"):
        network_apply_chunked(params, p, field, count=count)


def test_select_rows_is_the_masked_selection():
    """select_rows (the compacted superstep's valid slots) is the masked
    march's nonzero selection, in its order, with the count."""
    rng = np.random.default_rng(4)
    mask = _t(rng.random(5000) < 0.2)
    rows = _t(rng.random((5000, 3)).astype(np.float32))
    out, order, count = ops.select_rows(mask, rows)
    n = int(count)
    idx = torch.nonzero(mask).squeeze(1)
    assert n == idx.numel()
    torch.testing.assert_close(order[:n].long(), idx, rtol=0, atol=0)
    torch.testing.assert_close(out[:n], rows[idx], rtol=0, atol=0)


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


def _renderer(scene, size=48, seed=5, **kw):
    _, tvol, _, ttf, _, tm, _ = scene
    r = Renderer(size, size, tm, ttf, reference_sample_fn,
                 sample_ctx=tvol.data,
                 settings=rm.RaymarchSettings(compact=True, **kw), seed=seed)
    r.set_camera(Camera.default_for_dims(DIMS))
    return r


CAM2 = Camera(eye=(1.5 * DIMS[0], 8, 4), center=(0, 0, 0), up=(0, 1, 0),
              fovy=60)


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


def test_bump_next_consumed_and_record_kept(scene, small_buckets):
    r = _renderer(scene, seed=11)
    r.render()
    r.render()
    assert r._sched_cache.get("ops")
    r.set_camera(Camera(eye=(1.2 * DIMS[0], 10, 6), center=(0, 0, 0),
                        up=(0, 1, 0), fovy=55))
    assert r._sched_cache.get("bump_next") is True
    r.render()
    assert "bump_next" not in r._sched_cache
    for op in r._sched_cache.get("ops") or []:
        if op[0] == "C":
            assert op[2] <= op[1]
    r.mapframe()


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


class TestScheduleReplay:
    def test_progressive_frames_bit_identical(self, scene, small_buckets):
        frames = {}
        for replay in (False, True):
            r = _renderer(scene, schedule_replay=replay)
            fs = []
            for _ in range(4):
                r.render()
                fs.append(r.mapframe())
            frames[replay] = fs
            if replay:
                assert r._sched_cache.get("replays", 0) >= 2
        for a, b in zip(frames[True], frames[False]):
            np.testing.assert_array_equal(a, b)

    def test_camera_change_mid_accumulation(self, scene, small_buckets):
        frames = {}
        for replay in (False, True):
            r = _renderer(scene, seed=9, schedule_replay=replay)
            r.render()
            r.render()
            r.set_camera(CAM2)
            r.render()
            frames[replay] = r.mapframe()
        np.testing.assert_array_equal(frames[True], frames[False])

    def test_deferred_validation_bit_identical(self, scene, small_buckets):
        frames = {}
        for deferred in (False, True):
            r = _renderer(scene, deferred_validation=deferred)
            for _ in range(4):
                r.render()
            frames[deferred] = r.mapframe()
            assert "pending" not in r._sched_cache
            assert r._pending_frame is None and not r._pending_fused
        np.testing.assert_array_equal(frames[True], frames[False])

    def test_invalid_deferred_replay_rolls_back(self, scene, small_buckets,
                                                monkeypatch):
        """A corrupted record whose compaction drops live rays: the settle
        detects it, rolls the provisional frame out and renders it again
        serialized (JAX's tolerance: the accumulation's subtract and
        re-add)."""
        monkeypatch.setattr(comp, "FUSED_AUTOCOMPILE", False)
        ref = _renderer(scene, schedule_replay=False)
        for _ in range(4):
            ref.render()
        want = ref.mapframe()
        r = _renderer(scene)
        for _ in range(3):
            r.render()
        r._settle()
        assert r._sched_cache.get("ops")
        r._sched_cache["ops"] = [("C", 256, 100)] + [
            op for op in r._sched_cache["ops"] if op[0] != "C"]
        r.render()
        got = r.mapframe()
        assert r._sched_cache.get("invalidated", 0) >= 1
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_fused_schedule_matches_replay(self, scene, small_buckets):
        """The recorded frame as one program (fused_frame): every frame
        equal to a no-replay renderer's, and the fused path engaged."""
        ref = _renderer(scene, schedule_replay=False)
        r = _renderer(scene)
        for i in range(6):
            ref.render()
            r.render()
            assert comp.wait_fused_compiles(1)
            np.testing.assert_array_equal(r.mapframe(), ref.mapframe())
        assert r._sched_cache.get("fused_frames", 0) >= 1

    def test_fused_camera_change_falls_back(self, scene, small_buckets):
        frames = {}
        for replay in (False, True):
            r = _renderer(scene, seed=9, schedule_replay=replay)
            for _ in range(5):
                r.render()
            if replay:
                r._settle()
                assert r._sched_cache.get("fused_frames", 0) >= 1
            r.set_camera(CAM2)
            r.render()
            frames[replay] = r.mapframe()
        np.testing.assert_array_equal(frames[True], frames[False])

    def test_fused_invalid_frame_rolls_back(self, scene, small_buckets):
        """A fused frame whose recorded compaction drops live rays (a
        corrupted record, fused before the first check): rolled back,
        rendered again serialized, its fused programs dropped."""
        ref = _renderer(scene, schedule_replay=False)
        r = _renderer(scene)
        for _ in range(3):
            ref.render()
            r.render()
        r._settle_fused(keep=0)
        r._settle()
        r._sched_cache["ops"] = [("C", 256, 100)] + [
            op for op in r._sched_cache["ops"] if op[0] != "C"]
        for _ in range(3):
            ref.render()
            r.render()
        got = r.mapframe()
        assert r._sched_cache.get("invalidated", 0) >= 1
        np.testing.assert_allclose(got, ref.mapframe(), rtol=0, atol=1e-5)

    def test_resize_with_pending_frame(self, scene, small_buckets):
        r = _renderer(scene, seed=2)
        r.render()
        r.render()
        r.resize(32, 32)
        assert r._pending_frame is None and not r._pending_fused
        assert "ops" not in r._sched_cache
        r.reset_accumulation()
        r.render()
        f = r.mapframe()
        assert f.shape == (32, 32, 4) and np.isfinite(f).all()

    def test_all_miss_frame(self, scene, small_buckets):
        r = _renderer(scene, size=32, seed=1)
        r.set_camera(Camera(eye=(0, 0, -5.0 * DIMS[2]),
                            center=(0, 0, -9999), up=(0, 1, 0), fovy=30))
        for _ in range(3):
            r.render()
        assert np.abs(r.mapframe()).max() < 1e-6
        assert r._sched_cache.get("replays", 0) == 0


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


@pytest.mark.parametrize("k,s", [(4, 2), (8, 3)])
def test_samples_per_slot_emission_equals_jax(scene, k, s):
    """The plain emission with S samples a slot equals JAX's bit for bit."""
    _, _, _, _, jm, tm, _ = scene
    org, dirn, t0, t1, _ = _jax_rays(24)
    jst = jrm.init_ray_state(t0, t1)
    (jt, jce, jss, *_), jtx, jty, jv, *_ = jrm._emit_samples(
        org, dirn, t1, jst, jm, 1.0, k, 8, samples_per_slot=s)
    (tt, tce, tss), ttx, tty, tv = rm._emit_samples(
        _t(org), _t(dirn), _t(t1), rm.init_ray_state(_t(t0), _t(t1)), tm,
        1.0, k, 8, samples_per_slot=s)
    for got, ref in ((tt, jt), (tce, jce), (tss, jss), (ttx, jtx),
                     (tty, jty), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ttx.shape == (24 * 24, k * s) and int(tv.sum()) > 100


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


def test_programs_capture_once_per_key():
    """_Programs runs a key eagerly at its first use (on the CPU always);
    on the card the second use is captured."""
    calls = []
    p = comp._Programs(torch.device("cpu"))
    for _ in range(3):
        p.run(("S", 8), lambda: calls.append(1))
    assert len(calls) == 3 and not p.graphs


def test_finisher_chunks_honor_the_budget():
    """A finisher chunk is cut to the budget left as powers of two."""
    assert comp._chunks(8) == [8]
    assert comp._chunks(7) == [4, 2, 1]
    assert comp._chunks(5) == [4, 1]
    assert sum(comp._chunks(3)) == 3
