"""One delta-tracking event of the path tracer as two CUDA kernels
(`csrc/pathtrace.cu`), with their plain versions, counterpart of the JAX
package's XLA `_pt_event` (`instantvnr_tpu/render/pathtrace.py:236-397`).

An event splits at its one volume sample:

- `pt_track`: advance the remaining optical depth τ through up to
  `cell_skips` τ-surviving macrocell crossings, then resolve the final
  cell (majorant = max opacity × density scale): its exit t1 and dτ, the
  flags `crosses` (τ survives the cell) and `exited` (the ray left its
  segment), the new t and τ, and the object-space position of a collision
  candidate;
- the caller samples the volume there (render/pathtrace.py);
- `pt_resolve`: classify the sample through the transfer function, real
  or null collision, shadow-ray resolution, escape and ambient light,
  russian roulette, the phase and the fired shadow ray, the segment
  restart with a fresh τ = −log1p(−u), and the new active flag.

Both kernels run one thread a ray over every ray, active or not, and
repeat the plain versions' operations in their order (IEEE division,
floorf, no FMA contraction): `pt_track` equals its plain version bit for
bit; `pt_resolve` too, up to the CUDA math library's `log1pf`, `sinf` and
`cosf` in the card's own build of the plain version (chip_smoke.py
reports the share of rays that differ).

The uniforms of an event are one [6, R] float32 tensor, in the order of
the JAX package's keys k1..k5: u_accept, u_tau, u_sphere (two rows),
u_rr, u_tau2. The frame's constants are one [15] float32 tensor:
light_v, light_rgb, s_inv, box_lo, box_hi, three floats each.
"""
from __future__ import annotations

import torch

from instantvnr_torch.accel.macrocell import MACROCELL_SIZE
from instantvnr_torch.ops.cuda_lib import LaunchCounter
from instantvnr_torch.render.raymarch import _EPS, _PROBE_EPS, _cell_exit_t

track_counter = LaunchCounter()
resolve_counter = LaunchCounter()

_CELL = float(MACROCELL_SIZE)
RUSSIAN_ROULETTE_LENGTH = 4  # method_pathtracing.cu:33
PHASE_FACTOR = 0.6  # PHASE(albedo) = 0.6·albedo (:35)


# -- plain versions -------------------------------------------------------


def pt_track_reference(org, dirn, t, t_far, tau, max_opacity, dims: tuple,
                       density_scale: float, cell_skips: int):
    """Plain version of `pt_track` → (new_t, new_tau, majorant, crosses,
    exited, pos_obj [R, 3])."""
    mz, my, mx = max_opacity.shape
    occ_flat = max_opacity.reshape(-1)
    top = torch.tensor([mx - 1, my - 1, mz - 1], dtype=torch.int64,
                       device=org.device)

    def probe(t_):
        tp = t_ + _PROBE_EPS
        p = org + tp[:, None] * dirn
        cell = torch.floor(p / _CELL).to(torch.int64)
        c = torch.minimum(torch.clamp(cell, min=0), top)
        occ = occ_flat[(c[:, 2] * my + c[:, 1]) * mx + c[:, 0]]
        t1 = torch.minimum(torch.maximum(_cell_exit_t(org, dirn, cell,
                                                      _CELL), tp), t_far)
        return occ * density_scale, t1

    for _ in range(cell_skips):
        majorant, t1 = probe(t)
        dtau = (t1 - t) * majorant
        cross = (tau > dtau) & (t < t_far - _EPS)
        t = torch.where(cross, t1, t)
        tau = torch.where(cross, tau - dtau, tau)
    majorant, t1 = probe(t)
    dtau = (t1 - t) * majorant
    crosses = tau > dtau
    t_coll = t + tau / torch.clamp(majorant, min=_EPS)
    new_t = torch.where(crosses, t1, t_coll)
    new_tau = torch.where(crosses, tau - dtau, tau)
    exited = crosses & (new_t >= t_far - _EPS)
    dims_t = torch.tensor([float(d) for d in dims], dtype=torch.float32,
                          device=org.device)
    pos_obj = torch.clamp((org + new_t[:, None] * dirn) / dims_t, 0.0, 1.0)
    return new_t, new_tau, majorant, crosses, exited, pos_obj


def _uniform_sphere(u0, u1):
    """uniform_sample_sphere (raytracing.h:263-269) → [R, 3]."""
    phi = 2.0 * torch.pi * u0
    cos_t = 1.0 - 2.0 * u1
    sin_t = 2.0 * torch.sqrt(torch.clamp(u1 * (1.0 - u1), min=0.0))
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], dim=-1)


def restart_segment(org, dirn, box_lo, box_hi):
    """A segment restarted at its origin (inside the volume) ends where the
    ray leaves the box, the clip box when one is set (the reference
    overwrites DeviceVolume::bbox, object.cpp:386-391)."""
    from instantvnr_torch.utils.math import ray_box_intersect

    _, t1, hit = ray_box_intersect(org, dirn, box_lo, box_hi)
    return torch.where(hit, torch.clamp(t1, min=0.0), 0.0)


def pt_resolve_reference(org, dirn, t_far, throughput, radiance,
                         scatter_index, shadow, active, new_t, new_tau,
                         majorant, crosses, exited, values, u, ctrl, lut,
                         consts, density_scale: float, light_ambient: float):
    """Plain version of `pt_resolve` → the next state (org, dirn, t, t_far,
    tau, throughput, radiance, scatter_index, shadow, active)."""
    from instantvnr_torch.ops.slab_composite import _classify_packed

    light_v, light_rgb, s_inv, box_lo, box_hi = consts.reshape(5, 3)
    pos = org + new_t[:, None] * dirn
    candidate = ~crosses
    rgba = _classify_packed(ctrl, lut, values)
    rgb, alpha = rgba[:, :3], rgba[:, 3]
    real = candidate & (u[0] * torch.clamp(majorant, min=_EPS)
                        < alpha * density_scale)
    null = candidate & ~real  # null collision: a fresh τ, continue
    new_tau = torch.where(null, -torch.log1p(-u[1]), new_tau)

    act = active
    si = scatter_index
    # (1) a shadow ray resolved (exit: add light; hit: nothing) becomes a
    #     scatter ray with a uniform-sphere direction
    shadow_done = act & shadow & (exited | real)
    radiance = torch.where((shadow_done & exited)[:, None],
                           radiance + throughput * light_rgb, radiance)
    sphere = _uniform_sphere(u[2], u[3]) * s_inv
    dir_new = torch.where(shadow_done[:, None], sphere, dirn)
    shadow_new = torch.where(shadow_done, False, shadow)
    # (2) a scatter/primary ray escaped: ambient light (not primaries)
    escape = act & ~shadow & exited
    radiance = torch.where((escape & (si > 0))[:, None],
                           radiance + throughput * light_ambient, radiance)
    terminate = escape
    # (3) a real collision of a scatter/primary ray: russian roulette, move
    #     the origin, the phase, fire a shadow ray toward the light
    hit = act & ~shadow & real
    # the floor keeps the boost finite for a black TF color
    rr_q = torch.clamp(throughput.amax(dim=-1), 1e-6, 0.95)
    late = hit & (si > RUSSIAN_ROULETTE_LENGTH)
    rr_kill = late & (u[4] > rr_q)
    rr_boost = late & ~rr_kill
    throughput = torch.where(rr_boost[:, None], throughput / rr_q[:, None],
                             throughput)
    terminate = terminate | rr_kill
    hit = hit & ~rr_kill
    si = torch.where(hit, si + 1, si)
    org_new = torch.where(hit[:, None], pos, org)
    throughput = torch.where(hit[:, None], throughput * PHASE_FACTOR * rgb,
                             throughput)
    dir_new = torch.where(hit[:, None], light_v, dir_new)
    shadow_new = torch.where(hit, True, shadow_new)
    # the segment restarts where the direction changed, with its own draw
    restart = shadow_done | hit
    tfar_new = torch.where(restart, restart_segment(org_new, dir_new, box_lo,
                                                    box_hi), t_far)
    t_new = torch.where(restart, 0.0, new_t)
    tau_new = torch.where(restart, -torch.log1p(-u[5]), new_tau)
    return (org_new, dir_new, t_new, tfar_new, tau_new, throughput, radiance,
            si, shadow_new, act & ~terminate)


# -- kernels --------------------------------------------------------------


def _check(name, device, named):
    """(arg, tensor, shape, dtype) entries → contiguous tensors, each on
    `device` with its dtype and shape, or raise."""
    out = []
    for arg, a, shape, dt in named:
        if a.device != device or a.dtype != dt or tuple(a.shape) != shape:
            raise ValueError(f"{name}: expected {arg} {dt} {shape} on "
                             f"{device}, got {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}")
        out.append(a.contiguous())
    return out


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def pt_track(org, dirn, t, t_far, tau, max_opacity, dims: tuple,
             density_scale: float, cell_skips: int):
    """`pt_track_reference` for CPU tensors, the `pt_track` kernel for CUDA
    tensors. org, dirn [R, 3] voxel space; t, t_far, tau [R]; max_opacity
    [mz, my, mx]; dims the volume's (dx, dy, dz)."""
    if org.device.type == "cpu":
        return pt_track_reference(org, dirn, t, t_far, tau, max_opacity,
                                  dims, density_scale, cell_skips)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    r = org.shape[0]
    f32 = torch.float32
    mz, my, mx = max_opacity.shape
    org, dirn, t, t_far, tau, occ = _check("pt_track", org.device, [
        ("org", org, (r, 3), f32), ("dirn", dirn, (r, 3), f32),
        ("t", t, (r,), f32), ("t_far", t_far, (r,), f32),
        ("tau", tau, (r,), f32), ("max_opacity", max_opacity, (mz, my, mx),
                                  f32)])
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    dev = org.device
    new_t, new_tau, majorant = (torch.empty(r, dtype=f32, device=dev)
                                for _ in range(3))
    crosses, exited = (torch.empty(r, dtype=torch.bool, device=dev)
                       for _ in range(2))
    pos_obj = torch.empty((r, 3), dtype=f32, device=dev)
    dx, dy, dz = (float(d) for d in dims)
    lib.call("pt_track", org.data_ptr(), dirn.data_ptr(), t.data_ptr(),
             t_far.data_ptr(), tau.data_ptr(), occ.data_ptr(), mx, my, mz,
             dx, dy, dz, float(density_scale), int(cell_skips), r,
             new_t.data_ptr(), new_tau.data_ptr(), majorant.data_ptr(),
             crosses.data_ptr(), exited.data_ptr(), pos_obj.data_ptr(),
             _stream(dev))
    track_counter.launches += 1
    return new_t, new_tau, majorant, crosses, exited, pos_obj


def pt_resolve(org, dirn, t_far, throughput, radiance, scatter_index, shadow,
               active, new_t, new_tau, majorant, crosses, exited, values, u,
               ctrl, lut, consts, density_scale: float,
               light_ambient: float):
    """`pt_resolve_reference` for CPU tensors, the `pt_resolve` kernel for
    CUDA tensors. scatter_index int32, shadow/active/crosses/exited bool,
    values [R] (read only where ~crosses), u [6, R], ctrl [Kc, 8] and lut
    [n, 4] | None (ops/slab_composite.py's pack_controls / pack_lut),
    consts [15]."""
    if org.device.type == "cpu":
        return pt_resolve_reference(
            org, dirn, t_far, throughput, radiance, scatter_index, shadow,
            active, new_t, new_tau, majorant, crosses, exited, values, u,
            ctrl, lut, consts, density_scale, light_ambient)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    r = org.shape[0]
    f32, b8 = torch.float32, torch.bool
    kc = ctrl.shape[0]
    named = [("org", org, (r, 3), f32), ("dirn", dirn, (r, 3), f32),
             ("t_far", t_far, (r,), f32),
             ("throughput", throughput, (r, 3), f32),
             ("radiance", radiance, (r, 3), f32),
             ("scatter_index", scatter_index, (r,), torch.int32),
             ("shadow", shadow, (r,), b8), ("active", active, (r,), b8),
             ("new_t", new_t, (r,), f32), ("new_tau", new_tau, (r,), f32),
             ("majorant", majorant, (r,), f32),
             ("crosses", crosses, (r,), b8), ("exited", exited, (r,), b8),
             ("values", values, (r,), f32), ("u", u, (6, r), f32),
             ("ctrl", ctrl, (kc, 8), f32), ("consts", consts, (15,), f32)]
    if lut is not None:
        named.append(("lut", lut, (lut.shape[0], 4), f32))
    ins = _check("pt_resolve", org.device, named)
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    dev = org.device
    outs = (torch.empty((r, 3), dtype=f32, device=dev),
            torch.empty((r, 3), dtype=f32, device=dev),
            torch.empty(r, dtype=f32, device=dev),
            torch.empty(r, dtype=f32, device=dev),
            torch.empty(r, dtype=f32, device=dev),
            torch.empty((r, 3), dtype=f32, device=dev),
            torch.empty((r, 3), dtype=f32, device=dev),
            torch.empty(r, dtype=torch.int32, device=dev),
            torch.empty(r, dtype=b8, device=dev),
            torch.empty(r, dtype=b8, device=dev))
    ptr = [a.data_ptr() for a in ins[:16]]
    lib.call("pt_resolve", *ptr, kc,
             ins[17].data_ptr() if lut is not None else None,
             0 if lut is None else lut.shape[0], ins[16].data_ptr(),
             float(density_scale), float(light_ambient), r,
             *(o.data_ptr() for o in outs), _stream(dev))
    resolve_counter.launches += 1
    return outs
