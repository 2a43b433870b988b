"""Main renderer (counterpart of `instantvnr_tpu/render/renderer.py`; the
reference's `MainRenderer`, renderer.h:55-237).

Owns the scene (a sample function and its context, the macrocell, the
transfer function), the camera and the progressive accumulation buffer. A
frame is ray generation → clip-box intersection → the masked wavefront
(render/raymarch.py) → a blend into the accumulation buffer
(writePixelColor, raytracing.h:196-207). The jitter of a frame comes from a
`torch.Generator` on the frame's device, seeded by the renderer's seed; the
JAX package draws it from its threefry key, so the two packages' frames
part by their jitter, and the tests hand both the same jitter.

With `RaymarchSettings.compact` (the facade's wavefront modes) a frame
goes through the compacted path (render/compaction.py): bucketed ray
compaction, the previous frame's schedule replayed and checked afterwards
(at the next frame under `deferred_validation`: the frame is provisional
until then, and an invalid one is rolled out of the accumulation and
rendered again serialized), and, once a schedule is stable, the whole frame
as one CUDA graph (`FusedPipelineMixin`, shared with the path tracer,
settles those frames with a lag of `_fused_depth`). Every schedule gives
the masked march's frame.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch

from instantvnr_torch.accel.macrocell import MacroCell
from instantvnr_torch.render.camera import Camera, camera_rays
from instantvnr_torch.render.raymarch import RaymarchSettings, raymarch
from instantvnr_torch.utils.device import device_constant
from instantvnr_torch.utils.math import normalize, ray_box_intersect
from instantvnr_torch.utils.tfn import TransferFunction


def _frame_rays(width: int, height: int, cam_arrays, dims, light_dir, xform,
                jitter=None):
    """Ray generation, clip-box intersection and the view-flipped light.
    cam_arrays: (eye, center, up, fovy) tensors on the frame's device;
    dims [3] float tensor; jitter: optional [H·W, 2] pixel offsets in
    [0,1) (the path tracer's), else pixel centres. Applies the volume
    transform: scaling through the world → voxel ray map, clipping through
    the box (api.cpp:322-351). Returns (org, dirn, t0, t1, light, lo,
    hi)."""
    from instantvnr_torch.render.transform import clip_bounds, rays_to_voxel

    dev = cam_arrays[0].device
    cam = Camera(eye=cam_arrays[0], center=cam_arrays[1], up=cam_arrays[2],
                 fovy=cam_arrays[3])
    org_w, dirn_w = camera_rays(cam, width, height, jitter=jitter, device=dev)
    org, dirn = rays_to_voxel(xform, dims, org_w, dirn_w)
    lo, hi = clip_bounds(xform, dims)
    t0, t1, hit = ray_box_intersect(org, dirn, lo, hi)
    t0 = torch.where(hit, torch.clamp(t0, min=0.0), 1.0)
    t1 = torch.where(hit, t1, 0.0)
    view = normalize(cam_arrays[1] - cam_arrays[0])
    light = torch.where(torch.dot(view, light_dir) > 0, -light_dir, light_dir)
    return org, dirn, t0, t1, light, lo, hi


def _accumulate(rgba, accum, frame_index: int):
    """Progressive accumulation (writePixelColor, raytracing.h:196-207) →
    (accum, frame)."""
    accum = rgba if frame_index == 1 else accum + rgba
    return accum, accum / float(frame_index)


def _accum_fix(accum, bad, good, frame_index: int):
    """Swap a rolled-back provisional frame's contribution for the
    serialized redo's (JAX's `_accum_fix`): exact when that frame was the
    accumulation's first, within an ulp otherwise."""
    accum = accum - bad + good
    return accum, accum / float(frame_index)


def settle_provisional(sched_cache, pending, redo_fn, accum):
    """Resolve a provisional frame of deferred validation (one rollback
    protocol for the wavefront and the path tracer). pending = (rgba, sub,
    frame_index) or None; redo_fn(sub) renders that frame again serialized
    from the same draws. → None when nothing needs fixing, else the
    repaired (accum, frame)."""
    if pending is None:
        return None
    from instantvnr_torch.render.compaction import settle_pending

    if settle_pending(sched_cache):
        return None
    rgba_bad, sub, fidx = pending
    return _accum_fix(accum, rgba_bad, redo_fn(sub), fidx)


def discard_provisional(sched_cache, pending):
    """Drop a provisional frame with the accumulation it belongs to; its
    checks are still resolved, so an unsafe schedule is cleared."""
    if pending is not None:
        from instantvnr_torch.render.compaction import settle_pending

        settle_pending(sched_cache)


def _render_frame(sample_fn, width: int, height: int,
                  settings: RaymarchSettings, sample_ctx, cam_arrays,
                  mc: MacroCell, tf: TransferFunction, jitter: torch.Tensor,
                  accum, frame_index: int, xform=None, shadow_vol=None,
                  stats: dict | None = None):
    """One wavefront frame blended into `accum` → (accum, frame), each
    [H·W, 4]. jitter [H·W] in [0,1): the per-ray sample offset. Under
    settings.fixed_steps the frame is differentiable with respect to
    `sample_ctx` (render/raymarch.py::raymarch)."""
    from instantvnr_torch.render.transform import default_transform

    dev = cam_arrays[0].device
    dims = device_constant(tuple(float(d) for d in mc.volume_dims),
                           torch.float32, dev)
    if xform is None:
        xform = default_transform(mc.volume_dims, dev)
    org, dirn, t0, t1, light, lo, hi = _frame_rays(
        width, height, cam_arrays, dims,
        device_constant(tuple(settings.light_dir), torch.float32, dev), xform)
    rgba = raymarch(partial(sample_fn, sample_ctx), org, dirn, t0, t1, mc, tf,
                    jitter, settings, light_dir=light, scale=xform.scale,
                    clip_lower=lo, clip_upper=hi, shadow_vol=shadow_vol,
                    stats=stats)
    return _accumulate(rgba, accum, frame_index)


def _drop_schedules(subs, top: dict):
    """An invalid fused frame: its bands record anew, and its fused
    programs go (the next one is made from the new record, whose finisher
    steps may be more)."""
    for c in subs:
        c.pop("ops", None)
    top.pop("_fused", None)


class FusedPipelineMixin:
    """The fused whole-frame machinery shared by the wavefront and path
    tracer renderers (JAX's `FusedPipelineMixin`): fused frames are always
    provisional, their counts read with a lag of `_fused_depth` frames (a
    frame waits on none of its own); an invalid one rolls back through
    `_accum_fix` and a serialized redo from the same draws."""

    def _init_fused_pipeline(self):
        self._sched_cache: dict = {}
        # the supersteps (events) of the serialized redos of rolled-back
        # frames, over the renderer's life
        self.redo_stats: dict = {}
        # provisional frame of a deferred replay: (rgba, sub, frame_index)
        self._pending_frame = None
        # fused provisional frames: (rgba, sub, frame_index, pend, subs)
        self._pending_fused = []
        self._fused_depth = 3

    def _settle_fused(self, keep: int = 0):
        """Settle fused provisional frames until at most `keep` remain."""
        while len(self._pending_fused) > keep:
            rgba_bad, sub, _fidx, pend, subs = self._pending_fused.pop(0)
            if all(int(h) <= bound for h, bound in pend):
                continue
            self._sched_cache["invalidated"] = (
                self._sched_cache.get("invalidated", 0) + 1)
            _drop_schedules(subs, self._sched_cache)
            good = self._redo(sub)
            self._accum, self._frame = _accum_fix(
                self._accum, rgba_bad, good, self.frame_index)

    def _discard_fused(self):
        """Drop fused provisional frames with their accumulation, still
        clearing an unsafe schedule."""
        pendings, self._pending_fused = self._pending_fused, []
        for _rgba, _sub, _fidx, pend, subs in pendings:
            if not all(int(h) <= bound for h, bound in pend):
                self._sched_cache["invalidated"] = (
                    self._sched_cache.get("invalidated", 0) + 1)
                _drop_schedules(subs, self._sched_cache)

    def _settle(self):
        """Resolve the previous frame's deferred check and the fused frames
        past the pipeline's depth."""
        pf, self._pending_frame = self._pending_frame, None
        out = settle_provisional(self._sched_cache, pf, self._redo,
                                 self._accum)
        if out is not None:
            self._accum, self._frame = out
        self._settle_fused(keep=self._fused_depth - 1)

    def _drop_provisional(self):
        pf, self._pending_frame = self._pending_frame, None
        discard_provisional(self._sched_cache, pf)
        self._discard_fused()

    def _mark_bump(self):
        """A camera, TF or weights change: the recorded schedule is a hint
        for the next frame, replayed one rung relaxed
        (compaction.bump_schedule)."""
        if self._sched_cache.get("ops") or any(
                isinstance(v, dict) and v.get("ops")
                for v in self._sched_cache.values()):
            self._sched_cache["bump_next"] = True


class Renderer(FusedPipelineMixin):
    """Stateful frame orchestrator: host-side state, device-side frames."""

    def __init__(self, width: int, height: int, mc: MacroCell,
                 tf: TransferFunction,
                 sample_fn: Callable[..., torch.Tensor], sample_ctx=None,
                 settings: RaymarchSettings | None = None, seed: int = 0,
                 transform=None):
        from instantvnr_torch.render.transform import default_transform

        self.device = mc.max_opacity.device
        self.width, self.height = width, height
        self.mc = mc
        self.tf = tf
        self.sample_fn = sample_fn
        self.sample_ctx = sample_ctx
        self.settings = settings or RaymarchSettings()
        self.transform = transform or default_transform(mc.volume_dims,
                                                        self.device)
        self.camera = Camera.default_for_dims(mc.volume_dims)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._accum = None
        self._frame = torch.zeros((width * height, 4), dtype=torch.float32,
                                  device=self.device)
        self.frame_index = 0
        self.shadow_volume = None  # [dz,dy,dx] for shading == "shadow"
        self.last_stats: dict = {}  # the last frame's supersteps
        # the frame's rays per (camera, size, transform, light): a
        # progressive accumulation reuses them
        self._rays_cache = None
        self._init_fused_pipeline()

    # -- updates (reference MainRenderer::set_*) ----------------------------

    def set_camera(self, cam: Camera):
        self.camera = cam
        self.reset_accumulation()

    def set_transfer_function(self, tf: TransferFunction):
        self.tf = tf
        self.reset_accumulation()

    def set_sample_fn(self, sample_fn, sample_ctx=None):
        self.sample_fn = sample_fn
        self.sample_ctx = sample_ctx
        self.reset_accumulation()

    def set_sample_ctx(self, sample_ctx):
        """Swap the sample context (new network params during online
        training)."""
        self.sample_ctx = sample_ctx
        self.reset_accumulation()

    def set_settings(self, settings: RaymarchSettings):
        self.settings = settings
        self.reset_accumulation()

    def set_shadow_volume(self, shadow_vol):
        """The directional light's transmittance grid for shading ==
        "shadow" (render/shadow.py::shadow_volume_for)."""
        self.shadow_volume = shadow_vol
        self.reset_accumulation()

    def set_transform(self, transform):
        """Clipping box / scaling (vnrVolumeSetClippingBox /
        vnrVolumeSetScaling, api.cpp:322-351)."""
        self.transform = transform
        self.reset_accumulation()

    def resize(self, width: int, height: int):
        self._drop_provisional()
        self._sched_cache.pop("ops", None)  # schedules are size-specific
        self.width, self.height = width, height
        self._rays_cache = None
        self._frame = torch.zeros((width * height, 4), dtype=torch.float32,
                                  device=self.device)
        self.frame_index = 0
        self._accum = None

    def reset_accumulation(self):
        self._drop_provisional()
        self.frame_index = 0
        self._accum = None
        self._mark_bump()

    def warmup(self) -> int:
        """Before the first timed frame: for the compacted wavefront the
        bucket family of every band (compaction.warmup_programs, which on
        the card captures their CUDA graphs); else one frame. The
        accumulation is left as it was."""
        if self.settings.compact and not self.settings.fixed_steps:
            from instantvnr_torch.render.compaction import (_band_layout,
                                                            warmup_programs)

            r = self.width * self.height
            n = 0
            sizes = set()
            for a, b, sub_settings, cache_key, _ in _band_layout(
                    r, self.settings, self.transform.scale,
                    self.shadow_volume):
                cache = (self._sched_cache if cache_key is None
                         else self._sched_cache.setdefault(cache_key, {}))
                if b - a in sizes:
                    continue  # a band of a size already warmed
                sizes.add(b - a)
                n += warmup_programs(
                    self.sample_fn, sub_settings, self.mc, self.tf, b - a,
                    sample_ctx=self.sample_ctx, scale=self.transform.scale,
                    shadow_vol=self.shadow_volume, schedule_cache=cache)
            return n
        self.render()
        self.reset_accumulation()
        return 1

    # -- frame loop ---------------------------------------------------------

    def _next_jitter(self) -> torch.Tensor:
        """The next frame's per-ray jitter [H·W] in [0,1)."""
        return torch.rand((self.width * self.height,),
                          generator=self._generator, dtype=torch.float32,
                          device=self.device)

    def _cached_frame_rays(self):
        """The frame's rays (`_frame_rays`), kept per camera, size,
        transform and light."""
        from instantvnr_torch.render.slabmarch import camera_arrays

        key = (self.camera, self.width, self.height, id(self.transform),
               self.settings.light_dir)
        if self._rays_cache is None or self._rays_cache[0] != key:
            dims = device_constant(tuple(float(d) for d in
                                         self.mc.volume_dims),
                                   torch.float32, self.device)
            self._rays_cache = (key, _frame_rays(
                self.width, self.height,
                camera_arrays(self.camera, self.device), dims,
                device_constant(tuple(self.settings.light_dir),
                                torch.float32, self.device), self.transform))
        return self._rays_cache[1]

    def _compacted_rgba(self, jitter, schedule_cache, defer, stats=None):
        """One compacted frame's rgba (before the accumulation)."""
        from instantvnr_torch.render.compaction import raymarch_compacted

        org, dirn, t0, t1, light, lo, hi = self._cached_frame_rays()
        return raymarch_compacted(
            self.sample_fn, org, dirn, t0, t1, self.mc, self.tf, jitter,
            self.settings, light_dir=light, sample_ctx=self.sample_ctx,
            scale=self.transform.scale, clip_lower=lo, clip_upper=hi,
            shadow_vol=self.shadow_volume, schedule_cache=schedule_cache,
            defer=defer, stats=stats)

    def _redo(self, jitter):
        """A provisional frame rendered again, serialized, from its jitter."""
        return self._compacted_rgba(jitter, None, False, self.redo_stats)

    def _fused_frame_try(self, jitter, stats):
        """The frame as one program (compaction.fused_frame), or None."""
        from instantvnr_torch.render.compaction import fused_frame

        org, dirn, t0, t1, light, _, _ = self._cached_frame_rays()
        return fused_frame(
            self.sample_fn, self.settings, self._sched_cache, self.mc,
            self.tf, light, (org, dirn, t0, t1), jitter, self._accum,
            self.frame_index, sample_ctx=self.sample_ctx,
            scale=self.transform.scale, shadow_vol=self.shadow_volume,
            stats=stats)

    def _render_compacted(self) -> torch.Tensor:
        deferred = self.settings.deferred_validation
        stats: dict = {}
        jitter = self._next_jitter()
        out = self._fused_frame_try(jitter, stats)
        if out is not None:
            self._accum, self._frame, rgba, pend, subs = out
            self.frame_index += 1
            if pend:
                self._pending_fused.append((rgba, jitter, self.frame_index,
                                            pend, subs))
            if not deferred:
                self._settle_fused(keep=0)
            self.last_stats = stats
            return self._frame
        self.frame_index += 1
        rgba = self._compacted_rgba(jitter, self._sched_cache, deferred,
                                    stats)
        if "pending" in self._sched_cache:
            self._pending_frame = (rgba, jitter, self.frame_index)
        self._accum, self._frame = _accumulate(rgba, self._accum,
                                               self.frame_index)
        self.last_stats = stats
        return self._frame

    def render(self) -> torch.Tensor:
        """Render one frame and blend it into the accumulation; returns the
        accumulated frame [H·W, 4] on the device."""
        from instantvnr_torch.render.slabmarch import camera_arrays

        self._settle()
        if self.settings.compact and not self.settings.fixed_steps:
            return self._render_compacted()
        self.frame_index += 1
        stats: dict = {}
        self._accum, self._frame = _render_frame(
            self.sample_fn, self.width, self.height, self.settings,
            self.sample_ctx, camera_arrays(self.camera, self.device),
            self.mc, self.tf, self._next_jitter(), self._accum,
            self.frame_index, self.transform, self.shadow_volume,
            stats=stats)
        self.last_stats = stats
        return self._frame

    def mapframe(self) -> np.ndarray:
        """Blocking device → host readback as [H, W, 4] float32
        (FrameBuffer::mapframe, framebuffer.h:84-94); a displayed frame is
        never provisional."""
        self._settle()
        self._settle_fused(keep=0)
        return self._frame.detach().cpu().numpy().reshape(self.height,
                                                          self.width, 4)


def reference_sample_fn(volume: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Ground-truth sample function: the cell-centred trilinear texture
    lookup (sampleVolume, raytracing.h:105-110); ctx = the volume."""
    from instantvnr_torch.ops.trilinear import sample_volume

    return sample_volume(volume, p)


def make_neural_sample_fn(field, chunk: int = 1 << 18):
    """Neural sample function: batched network inference, the reference's
    sample-streaming mode (`NeuralVolume::inference`, network.cu:1043); ctx
    = the params of models.network.render_params (on the card each chunk is
    one hash_encode_forward launch on the table and one fused_mlp launch).
    Evaluated `chunk` samples at a time (network_apply_chunked).

    Under autograd, which only a `fixed_steps` march turns on, ctx must be
    the f32 training params, and a tensor of them or the sample positions
    (rays that require grad: camera or pose refinement, the weights
    frozen) must require grad: the sample then runs through the training
    forms (on the card K3, the fused MLP's training forward and backward,
    and the backwards asked for: K4 for the table,
    `hash_encode_coords_backward` for the positions), as the JAX package's
    differentiable frame samples `nv.state.params`. The inference K1 and a
    bf16 decode table have no backward, so such a ctx raises there."""
    from instantvnr_torch.models.network import network_apply_chunked

    def fn(params, p, count=None):
        if torch.is_grad_enabled():
            _check_differentiable(params, p)
        return network_apply_chunked(params, p, field, chunk=chunk,
                                     count=count)[:, 0]

    # the compacted wavefront hands a device-side count of valid rows
    # (render/raymarch.py::_Slots)
    fn.takes_count = True
    return fn


def _check_differentiable(params, p):
    table = params["table"]
    if "packed" in params or table.dtype != torch.float32 or not (
            p.requires_grad
            or any(t.requires_grad for t in [table, *params["mlp"]])):
        raise NotImplementedError(
            "a fixed_steps frame samples the network through its training "
            "forms (ROADMAP Queue 1 item 9): pass the f32 training params "
            "with a tensor that requires grad, or rays that require grad, "
            "not render_params, whose bf16 table and inference MLP have no "
            "backward")
