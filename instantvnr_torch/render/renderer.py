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

The JAX package's compaction and replay machinery (`FusedPipelineMixin`,
provisional frames and their settling) shapes its TPU's schedule and never
changes a frame; it has no counterpart here.
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


class Renderer:
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
        self.width, self.height = width, height
        self._frame = torch.zeros((width * height, 4), dtype=torch.float32,
                                  device=self.device)
        self.reset_accumulation()

    def reset_accumulation(self):
        self.frame_index = 0
        self._accum = None

    # -- frame loop ---------------------------------------------------------

    def _next_jitter(self) -> torch.Tensor:
        """The next frame's per-ray jitter [H·W] in [0,1)."""
        return torch.rand((self.width * self.height,),
                          generator=self._generator, dtype=torch.float32,
                          device=self.device)

    def render(self) -> torch.Tensor:
        """Render one frame and blend it into the accumulation; returns the
        accumulated frame [H·W, 4] on the device."""
        from instantvnr_torch.render.slabmarch import camera_arrays

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
        (FrameBuffer::mapframe, framebuffer.h:84-94)."""
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
    the f32 training params with a tensor that requires grad: the sample
    then runs through the training forms (on the card K3 and K4 of
    hash_encode, the fused MLP's training forward and backward), as the
    JAX package's differentiable frame samples `nv.state.params`. The
    inference K1 and a bf16 decode table have no backward, so such a ctx
    raises there."""
    from instantvnr_torch.models.network import network_apply_chunked

    def fn(params, p):
        if torch.is_grad_enabled():
            _check_differentiable(params)
        return network_apply_chunked(params, p, field, chunk=chunk)[:, 0]

    return fn


def _check_differentiable(params):
    table = params["table"]
    if "packed" in params or table.dtype != torch.float32 or not any(
            t.requires_grad for t in [table, *params["mlp"]]):
        raise NotImplementedError(
            "a fixed_steps frame samples the network through its training "
            "forms (ROADMAP Queue 1 item 9): pass the f32 training params "
            "with a tensor that requires grad, not render_params, whose bf16 "
            "table and inference MLP have no backward")
