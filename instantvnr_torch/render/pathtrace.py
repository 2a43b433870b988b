"""Volumetric path tracer: delta tracking with per-macrocell majorants
(counterpart of `instantvnr_tpu/render/pathtrace.py`, the reference's
`core/renderer/method_pathtracing.cu`).

Every ray advances ONE tracking event a step of a masked loop:

  event = consume the remaining optical depth τ through up to
  cell_skips + 1 macrocells (majorant = the cell's max opacity × density
  scale), which yields a cell exit (τ partly consumed), a volume exit
  (escape lighting / shadow-ray resolution) or a collision candidate (one
  volume sample and the TF classification, accepted with probability
  σ(x)/majorant);

and the per-ray state machine is the reference's (path_tracing_traceray,
:424-476): a hit → russian roulette (after 4 scatters, q = min(.95,
max(throughput))) → move the origin, throughput ×= 0.6·albedo → a SHADOW
ray toward the light; a resolved shadow ray (escape adds the light) →
a uniform-sphere scatter direction; a scatter ray's escape adds
throughput·light_ambient.

An event is two kernels on the card (ops/pathtrace.py: `pt_track`, then
the volume sample, then `pt_resolve`). The loop tests any(active) once
every `_ACTIVE_CHECK_EVERY` events, not after each: every change an event
makes to the radiance and scatter count is masked by the active flag, and
a ray never becomes active again, so the events after the last path died
change nothing of the frame.

The uniforms come from a source (`TorchUniforms`: the renderer's
`torch.Generator` on the frame's device); tests hand in the JAX package's
own draws. The JAX package's compacted tracker, its schedule replay and
its fused whole-frame programs shape the TPU's schedule and have no
counterpart here: their frames are the masked loop's
(`tests/test_pathtrace.py::test_uncompacted_bit_parity`); `compact` is
accepted and ignored.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from instantvnr_torch.accel.macrocell import MacroCell
from instantvnr_torch.ops.pathtrace import (PHASE_FACTOR,
                                            RUSSIAN_ROULETTE_LENGTH,
                                            pt_resolve, pt_track)
from instantvnr_torch.render.camera import Camera
from instantvnr_torch.utils.device import device_constant
from instantvnr_torch.utils.math import normalize
from instantvnr_torch.utils.tfn import TransferFunction

__all__ = ["PHASE_FACTOR", "RUSSIAN_ROULETTE_LENGTH", "PathTraceSettings",
           "PathTraceRenderer", "TorchUniforms", "pathtrace"]

# events between two any(active) tests (one host sync each)
_ACTIVE_CHECK_EVERY = 8
# PathTraceSettings knobs that shape only the JAX package's TPU schedule:
# name → the one value the port takes
_SCHEDULE_KNOBS = {"events_per_dispatch": 4, "finish_bucket": 8192,
                   "speculate": 0, "schedule_replay": True,
                   "deferred_validation": True, "fused_replay": True}


@dataclass(frozen=True)
class PathTraceSettings:
    density_scale: float = 1.0
    max_events: int = 512  # tracking events per frame sample, at most
    light_ambient: float = 1.5  # instantvnr_types.h:146
    light_rgb: tuple = (1.0, 1.0, 1.0)
    light_dir: tuple = (0.7, 0.9, 0.4)  # flipped against the view
    # the JAX package's compacted schedule: its frames equal the masked
    # tracker's, so the port accepts it and traces masked
    compact: bool = False
    events_per_dispatch: int = 4
    finish_bucket: int = 8192
    # τ-surviving cell crossings folded into each event (no draw, no sample)
    cell_skips: int = 2
    # wrap a plain grid into a corner-packed brick pool
    # (render/brickcache.build_brick_cache_from_grid) — tracker samples
    # only land in occupied cells, where it is exact: None = when the pool
    # fits grid_bricks_max_bytes, True / False = force
    grid_bricks: bool | None = None
    grid_bricks_max_bytes: int = 2 << 30
    speculate: int = 0
    schedule_replay: bool = True
    deferred_validation: bool = True
    fused_replay: bool = True

    def __post_init__(self):
        for name, value in _SCHEDULE_KNOBS.items():
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f"PathTraceSettings.{name}={getattr(self, name)!r} shapes "
                    "the JAX package's TPU schedule (render/compaction.py) "
                    "and has no counterpart in the port")


class _PTState(NamedTuple):
    org: torch.Tensor  # [R, 3] current segment origin (voxel space)
    dirn: torch.Tensor  # [R, 3]
    t: torch.Tensor  # [R] position along the segment
    t_far: torch.Tensor  # [R]
    tau: torch.Tensor  # [R] optical depth left to the next candidate
    throughput: torch.Tensor  # [R, 3]
    radiance: torch.Tensor  # [R, 3]
    scatter_index: torch.Tensor  # [R] int32
    shadow: torch.Tensor  # [R] bool
    active: torch.Tensor  # [R] bool


class _PTConsts(NamedTuple):
    """A frame's constants, shared by every event."""

    vec: torch.Tensor  # [15]: light_v, light_rgb, s_inv, box_lo, box_hi
    ctrl: torch.Tensor  # [Kc, 8] the TF's control rows
    lut: torch.Tensor | None  # [n, 4] the TF's LUT past 64 segments


class TorchUniforms:
    """The tracker's uniforms from a `torch.Generator` on the rays'
    device: the initial τ draw [R], then one [6, R] draw an event."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def tau(self, r: int, device) -> torch.Tensor:
        return torch.rand((r,), generator=self.generator, device=device)

    def event(self, r: int, device) -> torch.Tensor:
        return torch.rand((6, r), generator=self.generator, device=device)


def _pt_consts(mc: MacroCell, tf: TransferFunction, settings, light_dir_world,
               scale=None, clip_lower=None, clip_upper=None) -> _PTConsts:
    from instantvnr_torch.ops.slab_composite import pack_controls, pack_lut

    dev = mc.max_opacity.device
    f32 = torch.float32
    dims = device_constant(tuple(float(d) for d in mc.volume_dims), f32, dev)
    light_dir = normalize(light_dir_world)
    s_inv = (torch.ones(3, dtype=f32, device=dev) if scale is None
             else 1.0 / scale)
    vec = torch.cat([
        light_dir * s_inv,  # world light → the voxel marching direction
        device_constant(tuple(settings.light_rgb), f32, dev), s_inv,
        torch.zeros(3, dtype=f32, device=dev) if clip_lower is None
        else clip_lower, dims if clip_upper is None else clip_upper])
    return _PTConsts(vec=vec, ctrl=pack_controls(tf), lut=pack_lut(tf))


def _pt_event(sample_fn, settings: PathTraceSettings, mc: MacroCell,
              consts: _PTConsts, st: _PTState, u: torch.Tensor,
              select: bool = False) -> _PTState:
    """ONE delta-tracking event for every ray of `st` (masked): `pt_track`,
    the volume sample of the collision candidates, `pt_resolve`. u [6, R]:
    the event's uniforms. select: sample only the active candidates (one
    index selection, a host sync: worth it where a sample is a network
    evaluation); otherwise every ray's position is sampled and the
    non-candidates' values go unread."""
    new_t, new_tau, majorant, crosses, exited, pos_obj = pt_track(
        st.org, st.dirn, st.t, st.t_far, st.tau, mc.max_opacity,
        mc.volume_dims, settings.density_scale, settings.cell_skips)
    if select:
        idx = torch.nonzero(st.active & ~crosses).squeeze(1)
        values = pos_obj.new_zeros(pos_obj.shape[0])
        if idx.numel():
            values[idx] = sample_fn(pos_obj[idx])
    else:
        values = sample_fn(pos_obj)
    return _PTState(*pt_resolve(
        st.org, st.dirn, st.t_far, st.throughput, st.radiance,
        st.scatter_index, st.shadow, st.active, new_t, new_tau, majorant,
        crosses, exited, values, u, consts.ctrl, consts.lut, consts.vec,
        settings.density_scale, settings.light_ambient))


def init_pt_state(org, dirn, t_near, t_far, tau) -> _PTState:
    r = org.shape[0]
    dev = org.device
    return _PTState(
        org=org, dirn=dirn, t=t_near, t_far=t_far, tau=tau,
        throughput=torch.ones((r, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((r, 3), dtype=torch.float32, device=dev),
        scatter_index=torch.zeros((r,), dtype=torch.int32, device=dev),
        shadow=torch.zeros((r,), dtype=torch.bool, device=dev),
        active=t_near < t_far)


@torch.no_grad()
def pathtrace(sample_fn: Callable[[torch.Tensor], torch.Tensor],
              org: torch.Tensor, dirn: torch.Tensor, t_near: torch.Tensor,
              t_far: torch.Tensor, mc: MacroCell, tf: TransferFunction,
              uniforms, settings: PathTraceSettings,
              light_dir_world: torch.Tensor, scale=None, clip_lower=None,
              clip_upper=None, select: bool = False,
              stats: dict | None = None) -> torch.Tensor:
    """One progressive sample a ray → radiance rgba [R, 4].

    org [R, 3] voxel-space origins; under anisotropic scaling the caller
    hands unnormalized voxel-space directions (t stays world-metric), and
    the scatter and shadow directions drawn here are mapped through S⁻¹ the
    same way. uniforms: `TorchUniforms` or a test's source of the same
    draws. stats: an optional dict whose "events" this sample adds to."""
    r = org.shape[0]
    consts = _pt_consts(mc, tf, settings, light_dir_world, scale, clip_lower,
                        clip_upper)
    state = init_pt_state(org, dirn, t_near, t_far,
                          -torch.log1p(-uniforms.tau(r, org.device)))
    n = 0
    while n < settings.max_events:
        if n % _ACTIVE_CHECK_EVERY == 0 and not bool(state.active.any()):
            break
        state = _pt_event(sample_fn, settings, mc, consts, state,
                          uniforms.event(r, org.device), select)
        n += 1
    if stats is not None:
        stats["events"] = stats.get("events", 0) + n
    alpha = torch.where(state.scatter_index > 0, 1.0, 0.0)
    return torch.cat([state.radiance, alpha[:, None]], dim=-1)


class PathTraceRenderer:
    """Progressive path-tracing frames (the surface of
    render.renderer.Renderer): one sample a pixel a frame, averaged in the
    accumulation buffer."""

    def __init__(self, width: int, height: int, mc: MacroCell,
                 tf: TransferFunction, volume_or_ctx, sample_fn=None,
                 settings: PathTraceSettings | None = None, seed: int = 0,
                 transform=None):
        from instantvnr_torch.render.renderer import reference_sample_fn
        from instantvnr_torch.render.transform import default_transform

        self.device = mc.max_opacity.device
        self.width, self.height = width, height
        self.mc, self.tf = mc, tf
        self.settings = settings or PathTraceSettings()
        # a network sample is worth its candidates' index selection
        self._select = sample_fn is not None
        self.sample_fn = sample_fn or reference_sample_fn
        self.sample_ctx = volume_or_ctx
        self._grid_bricks = (
            sample_fn is None and self.settings.grid_bricks is not False
            and getattr(volume_or_ctx, "ndim", 0) == 3
            and (self.settings.grid_bricks or self._pool_fits()))
        if self._grid_bricks:
            self.set_grid(volume_or_ctx)
        self.transform = transform or default_transform(mc.volume_dims,
                                                        self.device)
        self.camera = Camera.default_for_dims(mc.volume_dims)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._accum = None
        self._frame = torch.zeros((width * height, 4), dtype=torch.float32,
                                  device=self.device)
        self.frame_index = 0
        self.last_stats: dict = {}  # the last frame's events

    def _pool_fits(self) -> bool:
        from instantvnr_torch.render.brickcache import brick_cache_bytes

        return (brick_cache_bytes(self.mc)
                <= self.settings.grid_bricks_max_bytes)

    def reset_accumulation(self):
        self.frame_index = 0
        self._accum = None

    def set_camera(self, cam: Camera):
        self.camera = cam
        self.reset_accumulation()

    def set_grid(self, volume):
        """Swap the decoded or ground-truth grid (the online-training
        refresh), re-applying the construction's grid → brick-pool policy
        so the sample fn and its ctx stay consistent."""
        if self._grid_bricks:
            from instantvnr_torch.render.brickcache import (
                brick_sample_fn, build_brick_cache_from_grid)

            self.sample_ctx = build_brick_cache_from_grid(volume, self.mc)
            self.sample_fn = brick_sample_fn
        else:
            self.sample_ctx = volume
        self.reset_accumulation()

    def set_transform(self, transform):
        """Clipping box / scaling (vnrVolumeSetClippingBox /
        vnrVolumeSetScaling through the facade)."""
        self.transform = transform
        self.reset_accumulation()

    def warmup(self) -> int:
        """Render one frame (the kernels' first launches) and restart the
        accumulation."""
        self.render()
        self.reset_accumulation()
        return 1

    def _next_jitter(self) -> torch.Tensor:
        """The next frame's pixel offsets [H·W, 2] in [0,1)."""
        return torch.rand((self.width * self.height, 2),
                          generator=self._generator, dtype=torch.float32,
                          device=self.device)

    def _uniforms(self) -> TorchUniforms:
        """The next frame's uniform source."""
        return TorchUniforms(self._generator)

    def render(self) -> torch.Tensor:
        from instantvnr_torch.render.renderer import _accumulate, _frame_rays
        from instantvnr_torch.render.slabmarch import camera_arrays

        self.frame_index += 1
        dev = self.device
        org, dirn, t0, t1, light, lo, hi = _frame_rays(
            self.width, self.height, camera_arrays(self.camera, dev),
            device_constant(tuple(float(d) for d in self.mc.volume_dims),
                            torch.float32, dev),
            device_constant(tuple(self.settings.light_dir), torch.float32,
                            dev), self.transform, jitter=self._next_jitter())
        stats: dict = {}
        rgba = pathtrace(partial(self.sample_fn, self.sample_ctx), org, dirn,
                         t0, t1, self.mc, self.tf, self._uniforms(),
                         self.settings,
                         light, scale=self.transform.scale, clip_lower=lo,
                         clip_upper=hi, select=self._select, stats=stats)
        self.last_stats = stats
        self._accum, self._frame = _accumulate(rgba, self._accum,
                                               self.frame_index)
        return self._frame

    def mapframe(self, denoise: bool = False) -> np.ndarray:
        """[H, W, 4] float32 on the host; denoise=True applies the à-trous
        filter (the reference's optional denoiser, renderer.cpp:117-121)."""
        frame = self._frame.reshape(self.height, self.width, 4)
        if denoise:
            from instantvnr_torch.render.denoise import atrous_denoise

            frame = atrous_denoise(frame)
        return frame.detach().cpu().numpy()
