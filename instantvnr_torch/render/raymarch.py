"""Ray-marching volume renderer: the bulk-synchronous masked wavefront
(counterpart of `instantvnr_tpu/render/raymarch.py`, itself the redesign of
the reference's `core/renderer/method_raymarching.cu`).

    superstep loop over ALL rays, masked:
      1. EMIT    a K-slot scan per ray: macrocell DDA with empty-space
                 skipping and per-cell quantized adaptive steps emits ≤ K
                 sample intervals (K = n_iters). On the card one thread a
                 ray in `csrc/raymarch_emit.cu` (`raymarch_emit`); on the
                 CPU the plain `_emit_samples`.
      2. SAMPLE  one batched sample_fn call on the valid ones of the R·K
                 slots (the neural path: hash-grid gather and fused MLP,
                 in chunks); an invalid slot blends with opacity 0, so
                 its value never reaches the frame.
      3. COMPOSE a scan over the K slots: classification, opacity
                 correction, front-to-back blending, early termination at
                 alpha ≥ NEARLY_ONE (plain PyTorch on both devices).

The loop runs while any ray is active: one host sync a superstep, the
condition of the JAX package's while_loop; selecting the valid slots is a
second one. Marching semantics are the reference's
(method_raymarching.cu:263-306; see the JAX module's docstring). This
masked march is what `fixed_steps` (the differentiable frame) and
`compact=False` run; `Renderer.render` runs `compact=True` through the
compacted path (render/compaction.py), whose supersteps are this
module's `_superstep` on a shrinking prefix of live rays with the valid
slots selected on the device (`_Slots`), and whose frames are this
march's.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, NamedTuple

import torch

from instantvnr_torch.accel.macrocell import MACROCELL_SIZE, MacroCell
from instantvnr_torch.config import (DEFAULT_WAVEFRONT_ITERS, NEARLY_ONE,
                                     env_int)
from instantvnr_torch.ops.cuda_lib import LaunchCounter
from instantvnr_torch.utils.device import device_constant
from instantvnr_torch.utils.math import (axis_quotient, normalize,
                                         ray_box_intersect)
from instantvnr_torch.utils.tfn import (TransferFunction, classify_controls,
                                        clip_ties)

_EPS = 1e-6
# step past a cell boundary when probing the next cell, in t units
_PROBE_EPS = 1e-3
# default directional light (instantvnr_types.h:148); it points toward the
# light
DEFAULT_LIGHT = (0.7, 0.9, 0.4)
# RaymarchSettings knobs the port does not take: name → the one value it
# takes (none left: the compacted path, render/compaction.py, takes them
# all)
_SCHEDULE_KNOBS: dict = {}

emit_counter = LaunchCounter()
emit_backward_counter = LaunchCounter()


@dataclass(frozen=True)
class RaymarchSettings:
    sampling_rate: float = 1.0  # samples per voxel
    density_scale: float = 1.0
    # sample slots per ray per superstep (the reference's VNR_RM_N_ITERS,
    # method_raymarching.cu:30-40), read when the settings are made
    n_iters: int = field(
        default_factory=lambda: env_int("VNR_RM_N_ITERS",
                                        DEFAULT_WAVEFRONT_ITERS))
    max_skips: int = 8  # empty-cell DDA skips per slot
    max_supersteps: int = 192
    shading: str = "none"  # "none" | "gradient" | "ssh" | "shadow"
    shading_scale: float = 0.95  # scivis_shading_scale
    gradient_step_frac: float = 1.0  # grad_step = frac/dims (object.cpp:305)
    light_dir: tuple = DEFAULT_LIGHT
    ssh_shadow_sampling_scale: float = 2.0  # shadow-pass rate scale
    # the SSH shadow pass marches at sampling_rate/scale but corrects with
    # the primary rate (method_raymarching.cu:365-399); None → sampling_rate
    correction_sampling_rate: float | None = None
    # exactly max_supersteps supersteps with autograd on (the JAX package's
    # lax.scan, instantvnr_tpu/render/raymarch.py:544-549): the frame is
    # differentiable with respect to what sample_fn reads
    fixed_steps: bool = False
    # the compacted path (render/compaction.py, through Renderer.render):
    # live rays in a shrinking prefix, the same frame; ignored under
    # fixed_steps
    compact: bool = False
    # samples emitted a slot from its cell (no probe between them): the
    # same march in other superstep chunks (JAX raymarch.py:216-287)
    samples_per_slot: int = 1
    # counts kept in flight by the compacted path, acted on stale
    speculate: int = 0
    # replay the last frame's schedule without waiting on counts, checked
    # afterwards (compaction._replay)
    schedule_replay: bool = True
    # check a replayed frame at the next frame (compaction.settle_pending)
    deferred_validation: bool = True
    # contiguous bands of rays, each through its own schedule
    tiles: int = 1
    # the finisher's threshold (None → compaction._FINISH_BUCKET)
    finish_bucket: int | None = None
    # a stable schedule as one whole-frame program (a CUDA graph on the
    # card; compaction.fused_frame)
    fused_replay: bool = True

    def __post_init__(self):
        if self.shading not in ("none", "gradient", "ssh", "shadow"):
            raise ValueError(f"shading={self.shading!r}")
        if self.tiles < 1 or self.samples_per_slot < 1:
            raise ValueError(f"tiles={self.tiles}, samples_per_slot="
                             f"{self.samples_per_slot}: each at least 1")
        for name, value in _SCHEDULE_KNOBS.items():
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f"RaymarchSettings.{name}={getattr(self, name)!r} shapes "
                    "the JAX package's TPU schedule (render/compaction.py) "
                    "and has no counterpart in the port")


class _RayState(NamedTuple):
    t: torch.Tensor  # [R] current position (t.x)
    t_cell_end: torch.Tensor  # [R] exit t of the current cell
    ss: torch.Tensor  # [R] step size within the current cell
    alpha: torch.Tensor  # [R]
    color: torch.Tensor  # [R, 3]
    active: torch.Tensor  # [R] bool
    # SINGLE_SHADE_HEURISTIC bookkeeping (method_raymarching.cu:455-467):
    # the highest-contribution sample along the ray, for deferred shading
    best_w: torch.Tensor  # [R]
    best_pos: torch.Tensor  # [R, 3] object-space position of that sample
    best_rgb: torch.Tensor  # [R, 3] its TF color


def _cell_exit_t(org, dirn, cell, w: float):
    """t at which the ray leaves `cell` (cells of w voxels). org/dirn [R,3]
    voxel space, cell [R,3] integer. Axis-parallel directions give ±inf or
    NaN there and drop out of the min; they send 0 to the gradient
    (`axis_quotient`; JAX's where gives NaN there, ROADMAP
    Queue 3)."""
    step_pos = (dirn > 0).to(torch.float32)
    boundary = (cell.to(torch.float32) + step_pos) * w
    t_ax, finite = axis_quotient(boundary - org, dirn)
    t_ax = torch.where(finite, t_ax, torch.inf)
    return t_ax.amin(dim=-1)


def _cell_flat(mc: MacroCell, cell: torch.Tensor) -> torch.Tensor:
    """Clamped flat macrocell id (t_far bounds the march, so clamping at the
    grid's edge is equivalent to the reference's DDA staying inside)."""
    mx, my, mz = mc.dims
    c = torch.minimum(torch.clamp(cell, min=0), device_constant(
        (mx - 1, my - 1, mz - 1), cell.dtype, cell.device))
    return (c[..., 2] * my + c[..., 1]) * mx + c[..., 0]


def _adaptive_rate(step, max_opacity):
    """adaptiveSamplingRate (raytracing.h:188-194)."""
    scale = 15.0 * step
    r = torch.abs(torch.clamp(max_opacity, 0.1, 1.0) - 1.0)
    return torch.clamp(step + scale * r * r, min=step)


def _quantized_step(ss, t0, t1):
    """sample_size_scaler (method_raymarching.cu:263-267): shrink ss so the
    interval divides into an integer number of steps."""
    n = torch.floor((t1 - t0) / ss).to(torch.int32) + 1
    return (t1 - t0) / torch.clamp(n.to(torch.float32), min=1.0)


def _emit_samples(org, dirn, t_far, state: _RayState, mc: MacroCell,
                  base_step, n_iters: int, max_skips: int,
                  samples_per_slot: int = 1, count_probes: bool = False):
    """Phase 1, plain PyTorch: the per-ray K-slot emission scan. Each slot
    first advances through up to `max_skips` empty cells (an occupancy
    gather and boundary math per probe), then emits `samples_per_slot`
    consecutive sample intervals [t_x, t_y) from the current cell (the JAX
    package's emission, instantvnr_tpu/render/raymarch.py:216-287).
    Returns ((t, t_cell_end, ss), t_x [R,K·S], t_y [R,K·S], valid
    [R,K·S]), slot-major; with count_probes also the number of probes
    made.

    The JAX package runs all max_skips probe bodies of a slot masked. A
    body changes nothing for a ray that needs no new cell or has left its
    range (every later body sees the same state), nor for one that has
    entered a cell in this slot (a later body could only enter it again
    from the same t, with the same values); so a ray probes only until one
    of those holds, and the slot's loop stops when no ray probes. The
    outputs are the masked scan's; the kernel (`raymarch_emit`) probes the
    same way."""
    w = float(MACROCELL_SIZE)
    occ_flat = mc.max_opacity.reshape(-1)
    t, t_cell_end, ss = state.t, state.t_cell_end, state.ss
    txs, tys, vs = [], [], []
    probes = 0
    for _ in range(n_iters):
        entered = torch.zeros_like(t, dtype=torch.bool)
        for _ in range(max_skips):
            need_new = t >= t_cell_end - _EPS
            in_range = t < t_far
            work = need_new & in_range & ~entered
            n_work = int(work.sum())  # one host sync a probe
            if n_work == 0:
                break
            probes += n_work
            # probe the cell just past the current position
            p = org + (t + _PROBE_EPS)[:, None] * dirn
            cell = torch.floor(p / w).to(torch.int64)
            occ = occ_flat[_cell_flat(mc, cell)]
            t_exit = torch.maximum(_cell_exit_t(org, dirn, cell, w),
                                   t + _PROBE_EPS)
            empty = occ <= _EPS
            # empty cell → jump to its exit; occupied → set up stepping over
            # the cell interval clamped at the march end (dda.h:84)
            enter = work & ~empty
            skip = work & empty
            entered = entered | enter
            t_exit_c = torch.minimum(t_exit, t_far)
            new_ss = _quantized_step(_adaptive_rate(base_step, occ), t,
                                     t_exit_c)
            t = torch.where(skip, t_exit, t)
            ss = torch.where(enter, new_ss, ss)
            t_cell_end = torch.where(enter, t_exit_c, t_cell_end)
        # emit S intervals within the current cell (t_cell_end is already
        # clamped at t_far); past the cell exit they are invalid and the
        # next slot's probe re-emits
        for _ in range(samples_per_slot):
            t_y = torch.minimum(t + ss, t_cell_end)
            valid = (t_y > t + _EPS) & (t < t_far) & (t_cell_end > t)
            txs.append(t)
            tys.append(t_y)
            vs.append(valid)
            t = torch.where(valid, t_y, t)
    out = ((t, t_cell_end, ss), torch.stack(txs, dim=1),
           torch.stack(tys, dim=1), torch.stack(vs, dim=1))
    return out + (probes,) if count_probes else out


def raymarch_emit(org, dirn, t_far, state: _RayState, mc: MacroCell,
                  base_step: float, n_iters: int, max_skips: int,
                  samples_per_slot: int = 1):
    """Phase 1: `_emit_samples` for CPU tensors, the `raymarch_emit` CUDA
    kernel (csrc/raymarch_emit.cu, one thread a ray) for CUDA tensors, with
    the same results bit for bit (IEEE division, floorf, no FMA, the same
    order of operations). Under autograd with rays or a marching state
    that require grad (a fixed_steps frame differentiated in its rays) the
    kernel's outputs carry their gradient through `_Emit`."""
    args = (mc, base_step, n_iters, max_skips, samples_per_slot)
    if org.device.type == "cpu":
        return _emit_samples(org, dirn, t_far, state, *args)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    ins = (org, dirn, t_far, state.t, state.t_cell_end, state.ss)
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        t, tce, ss, t_x, t_y, valid = _Emit.apply(*ins, *args)
        return (t, tce, ss), t_x, t_y, valid
    return _kernel_emit(*ins, *args)


def _emit_inputs(name, org, dirn, t_far, t, t_cell_end, ss, mc: MacroCell):
    """The emission kernels' inputs, checked (float32, shape, the device of
    org) → {name: contiguous detached tensor}."""
    r = org.shape[0]
    mx, my, mz = mc.dims
    args = {"org": (org, (r, 3)), "dirn": (dirn, (r, 3)),
            "t_far": (t_far, (r,)), "t": (t, (r,)),
            "t_cell_end": (t_cell_end, (r,)), "ss": (ss, (r,)),
            "max_opacity": (mc.max_opacity, (mz, my, mx))}
    ins = {}
    for key, (a, shape) in args.items():
        if (a.device != org.device or a.dtype != torch.float32
                or tuple(a.shape) != shape):
            raise ValueError(f"{name}: expected {key} float32 {shape} on "
                             f"{org.device}, got {a.dtype} {tuple(a.shape)} "
                             f"on {a.device}")
        ins[key] = a.detach().contiguous()
    return ins


def _emit_scalars(mc: MacroCell, base_step: float, r: int, n_iters: int,
                  max_skips: int, samples_per_slot: int):
    """The C entries' scalars after max_opacity, through samples_per_slot:
    base_step and 15 · base_step are rounded to float once each, as the
    plain version's Python scalars are."""
    mx, my, mz = mc.dims
    base_step = float(base_step)
    return (mx, my, mz, base_step, 15.0 * base_step, r, int(n_iters),
            int(max_skips), int(samples_per_slot))


_EMIT_INPUTS = ("org", "dirn", "t_far", "t", "t_cell_end", "ss",
                "max_opacity")


def _kernel_emit(org, dirn, t_far, t, t_cell_end, ss, mc: MacroCell,
                 base_step: float, n_iters: int, max_skips: int,
                 samples_per_slot: int):
    """The `raymarch_emit` kernel on CUDA tensors → `_emit_samples`'s
    outputs."""
    ins = _emit_inputs("raymarch_emit", org, dirn, t_far, t, t_cell_end, ss,
                       mc)
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    r = org.shape[0]
    f32 = torch.float32
    k = int(n_iters) * int(samples_per_slot)
    t_out, tce_out, ss_out = (torch.empty(r, dtype=f32, device=org.device)
                              for _ in range(3))
    t_x = torch.empty((r, k), dtype=f32, device=org.device)
    t_y = torch.empty((r, k), dtype=f32, device=org.device)
    valid = torch.empty((r, k), dtype=torch.bool, device=org.device)
    lib.call("raymarch_emit", *(ins[n].data_ptr() for n in _EMIT_INPUTS),
             *_emit_scalars(mc, base_step, r, n_iters, max_skips,
                            samples_per_slot),
             t_out.data_ptr(), tce_out.data_ptr(), ss_out.data_ptr(),
             t_x.data_ptr(), t_y.data_ptr(), valid.data_ptr(),
             torch.cuda.current_stream(org.device).cuda_stream)
    emit_counter.launches += 1
    return (t_out, tce_out, ss_out), t_x, t_y, valid


def _kernel_emit_backward(org, dirn, t_far, t, t_cell_end, ss, grads, need,
                          mc: MacroCell, base_step: float, n_iters: int,
                          max_skips: int, samples_per_slot: int):
    """The `raymarch_emit_backward` kernel on CUDA tensors: the
    vector-Jacobian product of the emission with the cotangents `grads` of
    (t, t_cell_end, ss, t_x, t_y), each a tensor or None (zero) → the
    gradients of (org, dirn, t_far, t, t_cell_end, ss), None where `need`
    is false. One launch, no host sync."""
    if org.device.type != "cuda":
        raise ValueError(f"raymarch_emit_backward: CUDA tensors only, got "
                         f"{org.device}")
    ins = _emit_inputs("raymarch_emit_backward", org, dirn, t_far, t,
                       t_cell_end, ss, mc)
    from instantvnr_torch.ops.cuda_lib import load_library

    r = org.shape[0]
    k = int(n_iters) * int(samples_per_slot)
    cts = []
    for g, shape in zip(grads, ((r,),) * 3 + ((r, k),) * 2):
        if g is not None:
            if tuple(g.shape) != shape or g.device != org.device:
                raise ValueError(f"raymarch_emit_backward: a cotangent of "
                                 f"{shape} on {org.device}, got "
                                 f"{tuple(g.shape)} on {g.device}")
            g = g.detach().to(torch.float32).contiguous()
        cts.append(g)
    outs = [torch.empty(shape, dtype=torch.float32, device=org.device)
            if n else None
            for n, shape in zip(need, ((r, 3), (r, 3)) + ((r,),) * 4)]
    lib = load_library()
    lib.call("raymarch_emit_backward",
             *(ins[n].data_ptr() for n in _EMIT_INPUTS),
             *_emit_scalars(mc, base_step, r, n_iters, max_skips,
                            samples_per_slot),
             *(None if x is None else x.data_ptr() for x in cts + outs),
             torch.cuda.current_stream(org.device).cuda_stream)
    emit_backward_counter.launches += 1
    return tuple(outs)


def _plain_emit_backward(org, dirn, t_far, t, t_cell_end, ss, grads, need,
                         *args):
    """`_kernel_emit_backward`'s plain version: autograd of `_emit_samples`
    recomputed on the same tensors, which makes the kernel's choices of
    cells and slots bit for bit. The tests and chip_smoke.py hold the
    kernel to it; no card path runs it."""
    ins = [x.detach().requires_grad_(n)
           for x, n in zip((org, dirn, t_far, t, t_cell_end, ss), need)]
    with torch.enable_grad():
        state = _RayState(t=ins[3], t_cell_end=ins[4], ss=ins[5], alpha=None,
                          color=None, active=None, best_w=None,
                          best_pos=None, best_rgb=None)
        (t, tce, ss), t_x, t_y, _ = _emit_samples(ins[0], ins[1], ins[2],
                                                  state, *args)
    outs = [(o, g) for o, g in zip((t, tce, ss, t_x, t_y), grads)
            if g is not None and o.requires_grad]
    wanted = [x for x in ins if x.requires_grad]
    got = iter(torch.autograd.grad(
        [o for o, _ in outs], wanted, [g for _, g in outs],
        allow_unused=True) if outs and wanted else ())
    return tuple((next(got) if outs else None) if n else None for n in need)


class _Emit(torch.autograd.Function):
    """The emission kernel, differentiable in the rays (org, dirn, t_far)
    and the marching state (t, t_cell_end, ss), as the JAX package's XLA
    scan is: a slot's interval ends and a ray's next t are the cell exits
    and quantized steps of its origin and direction. The forward is
    `raymarch_emit`, the backward `raymarch_emit_backward` (one launch,
    no host sync): the vector-Jacobian product of the plain emission
    (`_plain_emit_backward`), which its forward-mode re-run of the scan
    gives within float32 rounding. A card path runs no plain emission."""

    @staticmethod
    def forward(ctx, org, dirn, t_far, t, t_cell_end, ss, *args):
        ctx.save_for_backward(org, dirn, t_far, t, t_cell_end, ss)
        ctx.args = args
        ctx.set_materialize_grads(False)
        (t_o, tce_o, ss_o), t_x, t_y, valid = _kernel_emit(
            org, dirn, t_far, t, t_cell_end, ss, *args)
        ctx.mark_non_differentiable(valid)
        return t_o, tce_o, ss_o, t_x, t_y, valid

    @staticmethod
    def backward(ctx, *grads):
        got = _kernel_emit_backward(*ctx.saved_tensors, grads[:5],
                                    ctx.needs_input_grad[:6], *ctx.args)
        return (*got, *(None for _ in ctx.args))


def _compose(values, t_x, t_y, valid, state_alpha, state_color,
             tf: TransferFunction, sampling_rate, density_scale,
             rgb_override=None, track_best=None, pos_obj=None):
    """Phase 3: front-to-back blend over the K slots. values [R,K];
    rgb_override: optional [R,K,3] shaded colors in place of the TF color;
    track_best: optional (best_w, best_pos, best_rgb) for SSH (needs pos_obj
    [R,K,3]), returned updated."""
    rgb_tf, alpha_s = classify_controls(tf, values)  # [R,K,3], [R,K]
    rgb = rgb_tf if rgb_override is None else rgb_override
    dt = t_y - t_x
    # opacity correction (raytracing.h:166-170) and density scale
    alpha_s = 1.0 - torch.pow(clip_ties(1.0 - alpha_s, 0.0, math.inf),
                              sampling_rate * dt * density_scale)
    alpha_s = torch.where(valid, alpha_s, 0.0)
    r = values.shape[0]
    if track_best is None:
        z = values.new_zeros
        bw, bp, bc = z((r,)), z((r, 3)), z((r, 3))
    else:
        bw, bp, bc = track_best
    acc_a, acc_c = state_alpha, state_color
    for k in range(values.shape[1]):
        a_k = alpha_s[:, k]
        live = acc_a < NEARLY_ONE
        tr = torch.where(live, 1.0 - acc_a, 0.0)
        if track_best is not None:
            w = tr * a_k  # contribution (method_raymarching.cu:462)
            better = w > bw
            bw = torch.where(better, w, bw)
            bp = torch.where(better[:, None], pos_obj[:, k], bp)
            bc = torch.where(better[:, None], rgb_tf[:, k], bc)
        acc_c = acc_c + tr[:, None] * rgb[:, k] * a_k[:, None]
        acc_a = acc_a + tr * a_k
    return acc_a, acc_c, (bw, bp, bc)


def init_ray_state(t_near: torch.Tensor, t_far: torch.Tensor) -> _RayState:
    """Fresh marching state for a batch of rays ([R] t ranges)."""
    r = t_near.shape[0]
    z = t_near.new_zeros
    return _RayState(
        t=t_near,
        t_cell_end=t_near.clone(),  # forces cell entry on the first slot
        ss=torch.full((r,), torch.inf, dtype=torch.float32,
                      device=t_near.device),
        alpha=z((r,)), color=z((r, 3)), active=t_near < t_far,
        best_w=z((r,)), best_pos=z((r, 3)), best_rgb=z((r, 3)))


def _takes_count(sample_fn) -> bool:
    """Whether sample_fn (or the function a partial binds) takes a
    device-side row count (`count=`): the network and brick-pool samplers,
    whose kernels skip the rows past it."""
    return bool(getattr(getattr(sample_fn, "func", sample_fn), "takes_count",
                        False))


class _Slots:
    """The sample slots a superstep samples, out of its R·K.

    The masked march selects the valid slots by index (`torch.nonzero`, a
    host read). The compacted path (`counted`) selects them on the
    device: `ops/compaction.py::select_rows` partitions the slots' positions
    by the valid mask and leaves the count in device memory. On the card
    the samplers then run over the whole capacity, the network's K3 + K1
    and `brick_sample` skipping the rows past the count (other samplers see
    those rows at a harmless position), and every result past the count is
    masked to 0 before it is scattered back, so no host read is needed and
    a CUDA graph can capture the superstep. On the CPU the count is read
    and the first `count` rows are the masked march's selection, in its
    order."""

    def __init__(self, valid_flat, pos_flat, counted: bool):
        self.n_slots = valid_flat.shape[0]
        self.count = self.live = None
        if not counted:
            self.idx = torch.nonzero(valid_flat).squeeze(1)
            self.pos = pos_flat[self.idx]
            self.empty = self.idx.numel() == 0
            return
        from instantvnr_torch.ops.compaction import select_rows

        pos_c, order, count = select_rows(valid_flat, pos_flat)
        self.empty = False
        if pos_flat.device.type == "cpu":
            n = int(count)
            self.pos, self.idx = pos_c[:n], order[:n].to(torch.int64)
            self.empty = n == 0
            return
        self.pos, self.idx, self.count = pos_c, order.to(torch.int64), count
        self.live = torch.arange(self.n_slots, device=pos_flat.device) < count

    def sample(self, sample_fn, pos=None, rows_per_slot: int = 1):
        """sample_fn over the selected slots' positions (`pos` rows
        rows_per_slot a slot, default the slots' own positions)."""
        pos = self.pos if pos is None else pos
        if self.count is None:
            if pos.shape[0] == 0:  # nothing selected: nothing to sample
                return pos.new_zeros(0)
            return sample_fn(pos)
        if _takes_count(sample_fn):
            count = self.count if rows_per_slot == 1 \
                else self.count * rows_per_slot
            return sample_fn(pos, count=count)
        live = self.live if rows_per_slot == 1 \
            else self.live.repeat_interleave(rows_per_slot)
        return sample_fn(torch.where(live[:, None], pos, 0.5))

    def sample_probes(self, sample_fn, probe_pos):
        """The gradient's three probe batches probe_pos [3, n, 3] → [3, n]:
        one call, axis-major (the masked march's order); on the card with a
        count, slot-major so that the 3·count valid rows lead."""
        if self.count is None:
            return sample_fn(probe_pos.reshape(-1, 3)).reshape(3, -1)
        rows = probe_pos.permute(1, 0, 2).reshape(-1, 3)
        return self.sample(sample_fn, rows, 3).reshape(-1, 3).t()

    def safe_pos(self):
        """The positions, those past the count at the volume's centre: a
        sampler without a count form reads only finite, in-range ones."""
        return (self.pos if self.live is None
                else torch.where(self.live[:, None], self.pos, 0.5))

    def scatter(self, x_s, shape):
        """Per-slot results back to [R·K, ...] → `shape`; 0 at the slots
        not selected (and at those past the count)."""
        if self.live is not None:
            x_s = torch.where(
                self.live.reshape((-1,) + (1,) * (x_s.dim() - 1)), x_s, 0.0)
        out = x_s.new_zeros((self.n_slots,) + tuple(x_s.shape[1:]))
        out.index_copy_(0, self.idx, x_s)
        return out.reshape(shape)


def _superstep(sample_fn, org, dirn, t_far, jitter, mc: MacroCell,
               tf: TransferFunction, settings: RaymarchSettings, light_dir,
               state: _RayState, scale=None, shadow_vol=None,
               counted: bool = False) -> _RayState:
    """One bulk-synchronous superstep: EMIT → SAMPLE → COMPOSE.

    scale: optional [3] voxel→world scaling (render/transform.py); then
    `dirn` is the unnormalized voxel-space direction and shading maps back
    to world space (view = S·dirn, normal = grad/(dims·S), the diagonal
    xfmNormal of method_raymarching.cu:441/1085). counted: select the
    valid slots on the device (`_Slots`; the compacted path's form, with
    no host read on the card)."""
    r = org.shape[0]
    k = settings.n_iters * settings.samples_per_slot
    dims = device_constant(tuple(float(d) for d in mc.volume_dims),
                           torch.float32, org.device)
    base_step = 1.0 / settings.sampling_rate
    (t, t_cell_end, ss), t_x, t_y, valid = raymarch_emit(
        org, dirn, t_far, state, mc, base_step, settings.n_iters,
        settings.max_skips, settings.samples_per_slot)
    valid = valid & state.active[:, None]
    # sample position: lerp(jitter, t.x, t.y) (method_raymarching.cu:431)
    t_s = t_x + jitter[:, None] * (t_y - t_x)
    pos_v = org[:, None, :] + t_s[..., None] * dirn[:, None, :]  # [R,K,3]
    pos_obj = pos_v / dims  # voxel → object space
    # only the valid slots are sampled: an invalid slot blends with opacity
    # 0 whatever its value, so it keeps the value 0 and the frame is the
    # masked march's
    sel = _Slots(valid.reshape(-1), pos_obj.reshape(-1, 3), counted)
    if sel.empty:  # the blend would add nothing
        active = state.active & (t < t_far) & (state.alpha < NEARLY_ONE)
        return state._replace(t=t, t_cell_end=t_cell_end, ss=ss,
                              active=active)
    scatter = sel.scatter
    pos_s, idx = sel.pos, sel.idx
    vals_s = sel.sample(sample_fn)
    values = scatter(vals_s, (r, k))
    rgb_override = None
    if settings.shading == "gradient":
        # forward-difference gradient: 3 more sample batches, the step
        # flipped at the upper boundary (raytracing.h:112-130)
        grad_step = settings.gradient_step_frac / dims  # object units
        stp = torch.broadcast_to(grad_step, pos_s.shape)
        stp = torch.where(pos_s + stp > 1.0 - _EPS, -stp, stp)
        probe_pos = pos_s[None].repeat(3, 1, 1)  # [3, n, 3]
        for ax in range(3):
            probe_pos[ax, :, ax] = pos_s[:, ax] + stp[:, ax]
        probe_vals = sel.sample_probes(sample_fn, probe_pos)
        grad = torch.stack([(probe_vals[ax] - vals_s) / stp[:, ax]
                            for ax in range(3)], dim=-1)  # [n,3] object
        ray = torch.div(idx, k, rounding_mode="floor")
        if scale is None:
            shade_dir, normal = dirn[ray], -grad
        else:
            # world-space shading under anisotropic scaling: the view back
            # through S, the normal through the inverse transpose
            shade_dir = normalize(dirn * scale)[ray]
            normal = -grad / (dims * scale)
        rgb_tf, _ = classify_controls(tf, vals_s)
        shaded = _shade_scivis(shade_dir, normal, rgb_tf, light_dir=light_dir)
        rgb_override = scatter(settings.shading_scale * shaded
                               + (1.0 - settings.shading_scale) * rgb_tf,
                               (r, k, 3))
    elif settings.shading == "shadow":
        # FULL_SHADOW (method_optix.cu:208-215): the TF color modulated by
        # the light's transmittance at the sample, read from the shadow
        # volume: lerp(s, c, c·shadow) = c·((1 − s) + s·shadow)
        from instantvnr_torch.ops.trilinear import sample_volume

        sh = torch.clamp(sample_volume(shadow_vol, sel.safe_pos()), 0.0, 1.0)
        rgb_tf, _ = classify_controls(tf, vals_s)
        s_ = settings.shading_scale
        rgb_override = scatter(rgb_tf * ((1.0 - s_) + s_ * sh)[:, None],
                               (r, k, 3))
    track = ((state.best_w, state.best_pos, state.best_rgb)
             if settings.shading == "ssh" else None)
    alpha, color, best = _compose(
        values, t_x, t_y, valid, state.alpha, state.color, tf,
        settings.correction_sampling_rate or settings.sampling_rate,
        settings.density_scale, rgb_override, track_best=track,
        pos_obj=pos_obj)
    if settings.shading != "ssh":
        best = (state.best_w, state.best_pos, state.best_rgb)
    active = state.active & (t < t_far) & (alpha < NEARLY_ONE)
    return _RayState(t=t, t_cell_end=t_cell_end, ss=ss, alpha=alpha,
                     color=color, active=active, best_w=best[0],
                     best_pos=best[1], best_rgb=best[2])


def raymarch(sample_fn: Callable[[torch.Tensor], torch.Tensor],
             org: torch.Tensor, dirn: torch.Tensor, t_near: torch.Tensor,
             t_far: torch.Tensor, mc: MacroCell, tf: TransferFunction,
             jitter: torch.Tensor, settings: RaymarchSettings,
             light_dir=None, scale=None, clip_lower=None, clip_upper=None,
             shadow_vol=None, stats: dict | None = None) -> torch.Tensor:
    """March rays through the volume; returns rgba [R,4].

    org [R,3] voxel-space origins, dirn [R,3] directions, t_near/t_far [R],
    jitter [R] in [0,1). sample_fn maps object-space positions [N,3] in
    [0,1]³ to values [N].

    light_dir: the directional light for gradient/SSH shading, already
    flipped against the view by the caller (render/renderer.py); None →
    settings.light_dir. scale/clip_lower/clip_upper: the volume transform;
    the caller clips the primary rays' t range, here they shape only the
    deferred SSH shadow rays. stats: an optional dict whose "supersteps"
    this march (and its SSH shadow march) adds to.

    Without settings.fixed_steps the march runs under no_grad and stops
    once no ray is active. With it, it runs exactly max_supersteps
    supersteps under the caller's grad mode, so the rgba is differentiable
    with respect to what sample_fn reads (a sampled volume, a network's
    params, or the rays themselves: org, dirn and the t range): a ray that
    has finished samples nothing and blends opacity 0, so the extra
    supersteps leave the frame as it was. The positions depend on the rays
    through the emission's cell exits and steps (`raymarch_emit`, the
    kernel's `_Emit` on the card) and the sample's lerp, so rays that
    require grad give the frame's gradient in them, as in JAX. The SSH
    shadow march follows the same rule."""
    with torch.set_grad_enabled(settings.fixed_steps
                                and torch.is_grad_enabled()):
        return _raymarch(sample_fn, org, dirn, t_near, t_far, mc, tf, jitter,
                         settings, light_dir, scale, clip_lower, clip_upper,
                         shadow_vol, stats)


def _raymarch(sample_fn, org, dirn, t_near, t_far, mc, tf, jitter, settings,
              light_dir, scale, clip_lower, clip_upper, shadow_vol, stats):
    dims = device_constant(tuple(float(d) for d in mc.volume_dims),
                           torch.float32, org.device)
    if light_dir is None:
        light_dir = device_constant(tuple(settings.light_dir), torch.float32,
                                    org.device)
    light_dir = normalize(light_dir)
    state = init_ray_state(t_near, t_far)
    superstep = partial(_superstep, sample_fn, org, dirn, t_far, jitter, mc,
                        tf, settings, light_dir, scale=scale,
                        shadow_vol=shadow_vol)
    n = 0
    # the while_loop's condition: one host sync a superstep
    while n < settings.max_supersteps and (settings.fixed_steps
                                           or bool(state.active.any())):
        state = superstep(state)
        n += 1
    if stats is not None:
        stats["supersteps"] = stats.get("supersteps", 0) + n
    if settings.shading == "ssh":
        def march_shadow(org2, dir2, t0b, t1b, sh_settings, sh_jitter):
            return raymarch(sample_fn, org2, dir2, t0b, t1b, mc, tf,
                            sh_jitter, sh_settings, scale=scale,
                            clip_lower=clip_lower, clip_upper=clip_upper,
                            stats=stats)

        color = ssh_deferred_shade(
            march_shadow, state.color, state.alpha, state.best_w,
            state.best_pos, state.best_rgb, light_dir, dims, settings,
            scale, clip_lower, clip_upper, jitter)
        state = state._replace(color=color)
    return torch.cat([state.color, state.alpha[:, None]], dim=-1)


def ssh_shadow_settings(settings: RaymarchSettings) -> RaymarchSettings:
    """Settings of the deferred SSH shadow pass: march at the scaled-down
    rate, opacity-correct with the primary rate (the reference's
    raymarching_transmittance, method_raymarching.cu:365-399)."""
    return dataclasses.replace(
        settings,
        sampling_rate=settings.sampling_rate
        / settings.ssh_shadow_sampling_scale,
        correction_sampling_rate=settings.sampling_rate,
        shading="none", compact=False)


def ssh_deferred_shade(march_shadow, color, alpha, best_w, best_pos,
                       best_rgb, light_dir, dims, settings: RaymarchSettings,
                       scale, clip_lower, clip_upper, jitter):
    """Deferred single-shade pass (method_raymarching.cu:469-484): march a
    shadow ray from each ray's highest-contribution sample toward the light
    and blend the shaded color by its transmittance. march_shadow runs the
    march."""
    org2 = best_pos * dims  # object → voxel space
    light_v = light_dir if scale is None else light_dir / scale
    dir2 = light_v[None, :].expand(org2.shape).contiguous()
    box_lo = torch.zeros(3, device=org2.device) if clip_lower is None \
        else clip_lower
    box_hi = dims if clip_upper is None else clip_upper
    _, t1b, hitb = ray_box_intersect(org2, dir2, box_lo, box_hi)
    has_best = best_w > 0.0
    t1b = torch.where(hitb & has_best, torch.clamp(t1b, min=0.0), 0.0)
    # fresh jitter for the transmittance march (the reference redraws,
    # method_raymarching.cu:378): a multiplicative hash of the primary one
    sh_jitter = torch.remainder(jitter * 16807.0 + 0.37, 1.0)
    rgba_sh = march_shadow(org2, dir2, torch.zeros_like(t1b), t1b,
                           ssh_shadow_settings(settings), sh_jitter)
    transmittance = 1.0 - rgba_sh[:, 3]
    shaded = best_rgb * alpha[:, None] * transmittance[:, None]
    s_ = settings.shading_scale
    return torch.where(has_best[:, None], (1.0 - s_) * color + s_ * shaded,
                       color)


def _shade_scivis(ray_dir, normal, albedo, light_dir=(-1.0, 0.0, 0.0),
                  light_diffuse=(1.0, 1.0, 1.0), mat_ambient=0.6,
                  mat_diffuse=0.9, mat_specular=0.4, mat_shininess=40.0):
    """shade_scivis_light (raytracing.h:224-246) blended 50/50 with the
    simple headlight (shade_simple_light, :215-222) as the reference does.
    ray_dir, normal [..., 3]; albedo [..., 3]; light_dir a [3] tensor or a
    tuple."""
    dev = normal.device
    nn = torch.sum(normal * normal, dim=-1, keepdim=True)
    has_n = nn > 1e-6
    n = normal / torch.sqrt(torch.clamp(nn, min=1e-20))
    # constants from the process-wide cache: a CUDA graph captures no copy
    # from the host
    l = (light_dir if isinstance(light_dir, torch.Tensor) else
         device_constant(tuple(light_dir), torch.float32, dev))
    l = l / torch.linalg.vector_norm(l)
    v = -ray_dir
    cos_nl = torch.clamp(torch.sum(n * l, dim=-1, keepdim=True), min=0.0)
    h = l + v
    h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                        min=1e-20)
    cos_nh = torch.clamp(torch.sum(n * h, dim=-1, keepdim=True), min=0.0)
    diffuse = device_constant(tuple(light_diffuse), torch.float32, dev)
    color = mat_ambient * albedo
    color = color + torch.where(
        cos_nl > 0,
        mat_diffuse * cos_nl * albedo * diffuse
        + mat_specular * torch.pow(cos_nh, mat_shininess) * diffuse,
        torch.zeros_like(color))
    color = torch.where(has_n, color, torch.zeros_like(color))
    # shade_simple_light
    cos_vn = torch.abs(torch.sum(-ray_dir * n, dim=-1, keepdim=True))
    simple = torch.where(has_n, albedo * (0.2 + 0.8 * cos_vn),
                         torch.zeros_like(color))
    return 0.5 * simple + 0.5 * color
