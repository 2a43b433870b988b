"""The port's schedule replay and fused frames (render/compaction.py:
drive_compacted, the deferred validation, fused_frame) on the CPU, twins
of tests/test_compaction.py: the bump consumed and the record kept,
progressive frames, a camera change, deferred validation, an invalid
replay's rollback, fused against replay, a resize with a pending frame, an
all-miss frame. Each frame bit for bit the masked march's or the
serialized path's, except a rolled-back frame (within 1e-5: the
accumulation's subtract and re-add, as in JAX).
"""
import numpy as np
from torch_compaction_scene import (CAM2, DIMS, _renderer, scene,
                                    small_buckets)

from instantvnr_torch.render import compaction as comp
from instantvnr_torch.render.camera import Camera


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
