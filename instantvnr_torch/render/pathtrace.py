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
own draws.

`PathTraceSettings.compact` (the facade's modes) runs the compacted
tracker (`pathtrace_compacted`, through render/compaction.py): paths die
exponentially (escape, and russian roulette after 4 scatters), so the
live rays are kept in a shrinking prefix, `events_per_dispatch` events a
dispatch, the tail at or below `finish_bucket` run to completion, the
schedule replayed from frame to frame and, once stable, the whole frame
one CUDA graph with the generator registered. Its draws are the masked
tracker's while nothing compacts (an event draws [6, m] at the prefix
size m, as JAX's key chain does); once a compaction reassigns slots, a ray
draws other numbers than in the masked tracker, so the frames are
statistically the same, not equal (JAX's render/pathtrace.py:518-527).
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
# PathTraceSettings knobs the port does not take: name → the one value it
# takes (none left: the compacted tracker takes them all)
_SCHEDULE_KNOBS: dict = {}


@dataclass(frozen=True)
class PathTraceSettings:
    density_scale: float = 1.0
    max_events: int = 512  # tracking events per frame sample, at most
    light_ambient: float = 1.5  # instantvnr_types.h:146
    light_rgb: tuple = (1.0, 1.0, 1.0)
    light_dir: tuple = (0.7, 0.9, 0.4)  # flipped against the view
    # the compacted tracker (pathtrace_compacted, through
    # PathTraceRenderer.render): live rays in a shrinking prefix
    compact: bool = False
    events_per_dispatch: int = 4  # tracking events a dispatch
    finish_bucket: int = 8192  # prefixes at or below run to completion
    # τ-surviving cell crossings folded into each event (no draw, no sample)
    cell_skips: int = 2
    # wrap a plain grid into a corner-packed brick pool
    # (render/brickcache.build_brick_cache_from_grid) — tracker samples
    # only land in occupied cells, where it is exact: None = when the pool
    # fits grid_bricks_max_bytes, True / False = force
    grid_bricks: bool | None = None
    grid_bricks_max_bytes: int = 2 << 30
    # the compacted path's knobs, as RaymarchSettings'
    speculate: int = 0
    schedule_replay: bool = True
    deferred_validation: bool = True
    fused_replay: bool = True

    def __post_init__(self):
        # the loop advances whole events_per_dispatch chunks: a budget
        # they do not divide would overshoot max_events (JAX's assert)
        if (self.events_per_dispatch < 1
                or self.max_events % self.events_per_dispatch):
            raise ValueError(
                f"max_events={self.max_events} must be a multiple of "
                f"events_per_dispatch={self.events_per_dispatch}")


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
    device: the initial τ draw [R], then one [6, R] draw an event (R the
    rays the event advances: a prefix in the compacted tracker).
    mark()/rewind() let a frame start again from the same draws."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._mark = None

    def mark(self):
        self._mark = self.generator.get_state()

    def rewind(self):
        self.generator.set_state(self._mark)

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
              select: bool = False, counted: bool = False) -> _PTState:
    """ONE delta-tracking event for every ray of `st` (masked): `pt_track`,
    the volume sample of the collision candidates, `pt_resolve`. u [6, R]:
    the event's uniforms. select: sample only the active candidates (an
    index selection: worth it where a sample is a network evaluation; a
    host sync, or with `counted` the device-side selection of
    render/raymarch.py::_Slots); otherwise every ray's position is sampled
    and the non-candidates' values go unread."""
    new_t, new_tau, majorant, crosses, exited, pos_obj = pt_track(
        st.org, st.dirn, st.t, st.t_far, st.tau, mc.max_opacity,
        mc.volume_dims, settings.density_scale, settings.cell_skips)
    if select:
        from instantvnr_torch.render.raymarch import _Slots

        sel = _Slots(st.active & ~crosses, pos_obj, counted)
        values = (pos_obj.new_zeros(pos_obj.shape[0]) if sel.empty
                  else sel.scatter(sel.sample(sample_fn), (-1,)))
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


# -- the compacted tracker (render/compaction.py) ---------------------------

_I32 = torch.int32
PT_LEAVES = {"org": ((3,), torch.float32), "dirn": ((3,), torch.float32),
             "t": ((), torch.float32), "t_far": ((), torch.float32),
             "tau": ((), torch.float32),
             "throughput": ((3,), torch.float32),
             "radiance": ((3,), torch.float32), "scatter_index": ((), _I32),
             "shadow": ((), torch.bool), "active": ((), torch.bool),
             "perm": ((), _I32)}


def _graph_generator(uniforms):
    """The generator a CUDA graph of the tracker draws from (registered
    with each graph), or None where the source is not a card's generator
    (a test's draws: the programs then run eagerly)."""
    if (isinstance(uniforms, TorchUniforms)
            and uniforms.generator.device.type == "cuda"):
        return uniforms.generator
    return None


def _pt_frame(band, sample_fn, sample_ctx, settings: PathTraceSettings,
              mc: MacroCell, consts: _PTConsts, source: list, inputs,
              select: bool, stats):
    """A BandFrame of the tracker (compaction.BandFrame): inputs = (org,
    dirn, t_near, t_far) of the rays; source[0] the uniform source (read
    at each step, so a fused frame on the CPU draws from the current
    frame's). The frame's constants land in static buffers of the band."""
    from instantvnr_torch.render.compaction import BandFrame, fingerprint

    gen = _graph_generator(source[0])
    band.use((fingerprint(sample_fn), fingerprint(sample_ctx),
              fingerprint(mc), settings, select, consts.ctrl.shape,
              None if consts.lut is None else consts.lut.shape, id(gen)),
             generators=() if gen is None else (gen,),
             graphs=gen is not None)
    cs = _PTConsts(vec=band.static("vec", consts.vec),
                   ctrl=band.static("ctrl", consts.ctrl),
                   lut=None if consts.lut is None
                   else band.static("lut", consts.lut))
    fn = partial(sample_fn, sample_ctx)
    h = band.home
    dev = band.device
    fields = _PTState._fields

    def load():
        src = source[0]
        org, dirn, t_near, t_far = inputs
        h["org"].copy_(org)
        h["dirn"].copy_(dirn)
        h["t"].copy_(t_near)
        h["t_far"].copy_(t_far)
        h["tau"].copy_(-torch.log1p(-src.tau(band.r, dev)))
        h["throughput"].fill_(1.0)
        for n in ("radiance", "scatter_index", "shadow"):
            h[n].zero_()
        torch.lt(t_near, t_far, out=h["active"])
        torch.arange(band.r, dtype=_I32, device=dev, out=h["perm"])

    def step(m: int, n: int, finishing: bool = False):
        """n dispatches of events_per_dispatch events on [0:m], or n single
        events of a finisher (each count left in band.fcounts)."""
        for i in range(n if finishing else n * settings.events_per_dispatch):
            st = _PTState(*(h[k][:m] for k in fields))
            new = _pt_event(fn, settings, mc, cs, st,
                            source[0].event(m, dev), select, counted=True)
            for k, val in zip(fields, new):
                h[k][:m].copy_(val)
            if finishing:
                band.fcounts[i:i + 1].copy_(
                    h["active"][:m].sum(dtype=_I32).reshape(1))
        band.count.copy_(h["active"][:m].sum(dtype=_I32).reshape(1))

    # a frame started again (a replay that failed its checks) draws the
    # same numbers, as JAX's rerun keeps its key chain
    restart = (source[0].mark, source[0].rewind) if hasattr(
        source[0], "mark") else None
    return BandFrame(band, step, load, unit=settings.events_per_dispatch,
                     stats=stats, stat_name="events", restart=restart)


def _pt_unpermute(band) -> torch.Tensor:
    """Slot → pixel order (scatter_rows) → rgba [R, 4]."""
    from instantvnr_torch.ops.compaction import scatter_rows

    h = band.home
    rad = torch.empty_like(h["radiance"])
    si = torch.empty_like(h["scatter_index"])
    scatter_rows(h["perm"], [h["radiance"], h["scatter_index"]], [rad, si])
    alpha = torch.where(si > 0, 1.0, 0.0)
    return torch.cat([rad, alpha[:, None]], dim=-1)


def _pt_sched_key(r, settings, scale, clip_lower):
    import dataclasses

    return (r, dataclasses.astuple(settings), scale is None,
            clip_lower is None)


@torch.no_grad()
def pathtrace_compacted(sample_fn, org, dirn, t_near, t_far, mc: MacroCell,
                        tf: TransferFunction, uniforms,
                        settings: PathTraceSettings, light_dir_world,
                        sample_ctx=None, scale=None, clip_lower=None,
                        clip_upper=None, schedule_cache: dict | None = None,
                        defer: bool = False, select: bool = False,
                        stats: dict | None = None) -> torch.Tensor:
    """`pathtrace` with bucketed ray compaction (JAX's
    `pathtrace_compacted`): one progressive sample a ray → rgba [R, 4].
    sample_fn is called as sample_fn(sample_ctx, positions). The draws are
    `pathtrace`'s while nothing compacts; after a compaction they reach
    other rays (the same estimator). schedule_cache: the caller's dict for
    replay and the band's buffers and programs; defer: leave the replay's
    checks pending for `settle_pending`; stats: "events" added to."""
    from instantvnr_torch.render.compaction import band_of, drive_compacted

    r = org.shape[0]
    consts = _pt_consts(mc, tf, settings, light_dir_world, scale, clip_lower,
                        clip_upper)
    band = band_of(schedule_cache, r, org.device, PT_LEAVES)
    frame = _pt_frame(band, sample_fn, sample_ctx, settings, mc, consts,
                      [uniforms], (org, dirn, t_near, t_far), select, stats)
    drive_compacted(
        r, frame, settings.max_events, settings.events_per_dispatch,
        settings.finish_bucket, speculate=settings.speculate,
        schedule_cache=schedule_cache if settings.schedule_replay else None,
        sched_key=_pt_sched_key(r, settings, scale, clip_lower), defer=defer)
    return _pt_unpermute(band)


@torch.no_grad()
def warmup_pt_programs(sample_fn, settings: PathTraceSettings, mc, tf,
                       r: int, uniforms, sample_ctx=None, select=False,
                       schedule_cache=None) -> int:
    """Run the tracker's bucket family of frame size r twice on rays that
    all miss (JAX's warmup_pt_programs), so that on the card every
    bucket's dispatch, finisher chunk and compaction is captured before
    the first timed frame. Returns the number of bucket sizes."""
    from instantvnr_torch.render.compaction import (_FINISH_CHUNK, _chunks,
                                                    band_of, bucket_sizes)

    dev = mc.max_opacity.device
    zeros = torch.zeros(r, dtype=torch.float32, device=dev)
    dirz = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    dirz[:, 2] = 1.0
    consts = _pt_consts(mc, tf, settings,
                        torch.tensor(settings.light_dir, device=dev))
    cache = {} if schedule_cache is None else schedule_cache
    band = band_of(cache, r, dev, PT_LEAVES)
    frame = _pt_frame(band, sample_fn, sample_ctx, settings, mc, consts,
                      [uniforms], (torch.zeros_like(dirz), dirz, zeros,
                                   zeros), select, None)
    sizes = bucket_sizes(r)
    for _ in range(2):
        frame.initial()
        for m in sizes:
            if m <= settings.finish_bucket:
                for p in _chunks(_FINISH_CHUNK):
                    band.programs.run(("F", m, p),
                                      lambda m=m, p=p: frame.step(m, p, True))
            else:
                band.programs.run(("S", m), lambda m=m: frame.step(m, 1))
            band.compact(m)
    return len(sizes)


@torch.no_grad()
def pt_fused_frame(sample_fn, settings: PathTraceSettings,
                   schedule_cache: dict, mc: MacroCell, tf, consts_args,
                   rays, uniforms, accum, frame_index: int, sample_ctx=None,
                   select=False, stats=None):
    """compaction.fused_frame for the tracker (one band): rays = (org,
    dirn, t_near, t_far) of this frame's jittered rays, consts_args the
    arguments of `_pt_consts` after (mc, tf, settings). Returns None or
    (accum, frame, rgba, pend), always provisional. On the card only a
    card generator's draws can be captured (else None)."""
    from instantvnr_torch.render import compaction as comp

    if not (settings.fused_replay and settings.schedule_replay):
        return None
    org = rays[0]
    r, dev = org.shape[0], org.device
    gen = _graph_generator(uniforms)
    if dev.type == "cuda" and gen is None:
        return None
    scale, clip_lower = consts_args[1], consts_args[2]
    layout = [(0, r, settings, None,
               _pt_sched_key(r, settings, scale, clip_lower))]
    bands, _, f_steps = comp.stable_bands(schedule_cache, layout)
    if bands is None:
        schedule_cache.pop("_fused_prev", None)
        return None
    consts = _pt_consts(mc, tf, settings, *consts_args)
    key = (bands, comp.fingerprint(sample_fn), comp.fingerprint(sample_ctx),
           comp.fingerprint(mc), settings, select, consts.ctrl.shape,
           None if consts.lut is None else consts.lut.shape, id(gen), r,
           str(dev))
    source = schedule_cache.setdefault("_pt_source", [uniforms])
    source[0] = uniforms

    def build():
        exe = comp.FusedFrame(dev, r, {"org": (3,), "dirn": (3,),
                                       "t_near": (), "t_far": ()})
        band = comp.band_of(schedule_cache, r, dev, PT_LEAVES)
        fin = exe.inputs
        frame = _pt_frame(band, sample_fn, sample_ctx, settings, mc, consts,
                          source, tuple(fin[n] for n in ("org", "dirn",
                                                         "t_near", "t_far")),
                          select, None)
        exe.frames = [frame]
        return comp.make_fused(
            exe, [frame], [bands[0][2]], f_steps, settings.max_events,
            settings.events_per_dispatch, lambda f: _pt_unpermute(f.band),
            generators=() if gen is None else (gen,), stats=stats,
            stat_name="events")

    exe = comp.fused_lookup(schedule_cache, key, build)
    if exe is None:
        return None
    band = exe.frames[0].band
    band.static("vec", consts.vec)
    band.static("ctrl", consts.ctrl)
    if consts.lut is not None:
        band.static("lut", consts.lut)
    for name, t in zip(("org", "dirn", "t_near", "t_far"), rays):
        exe.inputs[name].copy_(t)
    return comp.fused_run(exe, accum, frame_index, schedule_cache, stats,
                          "events")


def _mixin():
    from instantvnr_torch.render.renderer import FusedPipelineMixin

    return FusedPipelineMixin


class PathTraceRenderer(_mixin()):
    """Progressive path-tracing frames (the surface of
    render.renderer.Renderer): one sample a pixel a frame, averaged in the
    accumulation buffer; with settings.compact through the compacted
    tracker, its replayed schedules and fused frames (FusedPipelineMixin)."""

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
        self._init_fused_pipeline()
        self._cam_cache = None  # (camera, its arrays on the device)
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
        self._drop_provisional()
        self.frame_index = 0
        self._accum = None
        self._mark_bump()

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
        """Before the first timed frame: for the compacted tracker its
        bucket family (warmup_pt_programs: on the card their CUDA graphs),
        else one frame; the accumulation and the generator are left as
        they were."""
        if self.settings.compact:
            state = self._generator.get_state()
            n = warmup_pt_programs(
                self.sample_fn, self.settings, self.mc, self.tf,
                self.width * self.height, self._uniforms(),
                sample_ctx=self.sample_ctx, select=self._select,
                schedule_cache=self._sched_cache)
            self._generator.set_state(state)
            return n
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

    def _rays(self):
        """This frame's jittered rays (`_frame_rays`; the camera's arrays
        kept per camera)."""
        from instantvnr_torch.render.renderer import _frame_rays
        from instantvnr_torch.render.slabmarch import camera_arrays

        dev = self.device
        if self._cam_cache is None or self._cam_cache[0] != self.camera:
            self._cam_cache = (self.camera, camera_arrays(self.camera, dev))
        return _frame_rays(
            self.width, self.height, self._cam_cache[1],
            device_constant(tuple(float(d) for d in self.mc.volume_dims),
                            torch.float32, dev),
            device_constant(tuple(self.settings.light_dir), torch.float32,
                            dev), self.transform, jitter=self._next_jitter())

    def _compacted_rgba(self, schedule_cache, defer, stats=None):
        """One compacted frame's rgba (before the accumulation)."""
        org, dirn, t0, t1, light, lo, hi = self._rays()
        return pathtrace_compacted(
            self.sample_fn, org, dirn, t0, t1, self.mc, self.tf,
            self._uniforms(), self.settings, light,
            sample_ctx=self.sample_ctx, scale=self.transform.scale,
            clip_lower=lo, clip_upper=hi, schedule_cache=schedule_cache,
            defer=defer, select=self._select, stats=stats)

    def _redo(self, state):
        """A provisional frame rendered again, serialized, from the
        generator state it started from; the generator then goes on as
        before."""
        now = self._generator.get_state()
        self._generator.set_state(state)
        rgba = self._compacted_rgba(None, False, self.redo_stats)
        self._generator.set_state(now)
        return rgba

    def _render_compacted(self) -> torch.Tensor:
        from instantvnr_torch.render.renderer import _accumulate

        deferred = self.settings.deferred_validation
        stats: dict = {}
        start = self._generator.get_state()
        out = None
        if self._sched_cache.get("ops"):
            org, dirn, t0, t1, light, lo, hi = self._rays()
            out = pt_fused_frame(
                self.sample_fn, self.settings, self._sched_cache, self.mc,
                self.tf, (light, self.transform.scale, lo, hi),
                (org, dirn, t0, t1), self._uniforms(), self._accum,
                self.frame_index, sample_ctx=self.sample_ctx,
                select=self._select, stats=stats)
            if out is None:
                # the per-dispatch frame draws its rays again
                self._generator.set_state(start)
        if out is not None:
            self._accum, self._frame, rgba, pend = out
            self.frame_index += 1
            if pend:
                self._pending_fused.append((rgba, start, self.frame_index,
                                            pend, [self._sched_cache]))
            if not deferred:
                self._settle_fused(keep=0)
            self.last_stats = stats
            return self._frame
        self.frame_index += 1
        rgba = self._compacted_rgba(self._sched_cache, deferred, stats)
        if "pending" in self._sched_cache:
            self._pending_frame = (rgba, start, self.frame_index)
        self._accum, self._frame = _accumulate(rgba, self._accum,
                                               self.frame_index)
        self.last_stats = stats
        return self._frame

    def render(self) -> torch.Tensor:
        from instantvnr_torch.render.renderer import _accumulate

        self._settle()
        if self.settings.compact:
            return self._render_compacted()
        self.frame_index += 1
        org, dirn, t0, t1, light, lo, hi = self._rays()
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
        filter (the reference's optional denoiser, renderer.cpp:117-121). A
        displayed frame is never provisional."""
        self._settle()
        self._settle_fused(keep=0)
        frame = self._frame.reshape(self.height, self.width, 4)
        if denoise:
            from instantvnr_torch.render.denoise import atrous_denoise

            frame = atrous_denoise(frame)
        return frame.detach().cpu().numpy()
