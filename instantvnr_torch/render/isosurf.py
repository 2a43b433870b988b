"""First-hit isosurface rendering by slab sweep (counterpart of
`instantvnr_tpu/render/isosurf.py`).

Capability counterpart of the reference's interactive isosurface app
(`apps/int_isosurface.cu`). The surface is rendered implicitly: sweep
axis-aligned slabs front to back with the shear-warp factorization of the
slab compositor (render/slabmarch.py), find each intermediate-pixel ray's
FIRST crossing of the isovalue between consecutive slab samples, lerp the
crossing depth and gradient (ops/iso_sweep.py: the CUDA kernel on the card,
its plain version on the CPU; both resample each slab through the per-row
pairs of render/slabmarch.py::_interp_pairs), then shade with the scivis
model and warp to the screen. The isovalue is an argument of the sweep, so
an edit rebuilds nothing.

A degenerate camera (the frustum looks backward along the principal axis)
has no slab factorization; there `brute_iso_render` marches each pixel's
ray at fixed steps through the trilinear grid (ops/trilinear.py), finds the
first crossing and refines it by bisection (JAX render/isosurf.py:245-381).
Mesh extraction (ops/isosurface.py) is a later item.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from instantvnr_torch.render.camera import Camera, camera_rays
from instantvnr_torch.render.raymarch import DEFAULT_LIGHT, _shade_scivis
from instantvnr_torch.render.slabmarch import (
    _coverage_masks,
    _final_warp,
    _per_slab_state,
    _permute_volume,
    camera_arrays,
    compute_gradient_volumes,
    frame_geometry,
    principal_axis,
    slab_path_valid,
)
from instantvnr_torch.utils.device import device_constant
from instantvnr_torch.utils.math import ray_box_intersect
from instantvnr_torch.utils.tfn import TransferFunction, classify_controls


@dataclass(frozen=True)
class IsoSettings:
    supersample: float = 1.0
    shading_scale: float = 0.95  # scivis blend (as the volume modes)
    light_dir: tuple = DEFAULT_LIGHT  # instantvnr_types.h:148
    color: tuple | None = None  # fixed albedo; None → TF color at isovalue
    # the brute-force marcher of degenerate cameras
    sampling_rate: float = 2.0  # steps per voxel along the ray
    n_refine: int = 8  # bisection iterations after the crossing


def _albedo(tf: TransferFunction, isovalue, settings: IsoSettings,
            device) -> torch.Tensor:
    if settings.color is not None:
        return torch.as_tensor(settings.color, dtype=torch.float32,
                               device=device)
    iso = torch.as_tensor(isovalue, dtype=torch.float32, device=device)
    rgb, _ = classify_controls(tf, iso.reshape(1, 1))
    return rgb[0, 0]


def _flip_light(settings: IsoSettings, cam_arrays) -> torch.Tensor:
    light = torch.as_tensor(settings.light_dir, dtype=torch.float32,
                            device=cam_arrays[0].device)
    fwd = cam_arrays[1] - cam_arrays[0]
    return torch.where(torch.dot(fwd, light) > 0, -light, light)


@torch.no_grad()
def slab_iso_args(volume: torch.Tensor, grad_volumes: torch.Tensor,
                  width: int, height: int, settings: IsoSettings, axis: int,
                  flipped: bool, cam_arrays, xform=None):
    """The per-frame inputs of the sweep. Returns (sweep_args, frame):
    `iso_sweep(*sweep_args, iso)` finds the first hits and
    `_shade_and_warp(*hits, tf, iso, settings, cam_arrays, width, height,
    *frame)` shades them and warps to the screen."""
    from instantvnr_torch.render.transform import default_transform

    dev = volume.device
    dz, dy, dx = volume.shape
    dims_w = torch.tensor([dx, dy, dz], dtype=torch.float32, device=dev)
    if xform is None:
        xform = default_transform((dx, dy, dz), dev)

    vol, perm = _permute_volume(volume, axis, flipped)
    # value + world-gradient slabs stacked: [D, 4, ay, ax]
    fields = torch.stack(
        [vol] + [_permute_volume(grad_volumes[i], axis, flipped)[0]
                 for i in range(3)], dim=1)
    d_slab, ay_n, ax_n = vol.shape

    # shear-warp frame state shared with the slab compositor
    eye_w = cam_arrays[0] / xform.scale + 0.5 * dims_w  # voxel space
    size_z = dims_w[perm[2]]
    geo = frame_geometry(dims_w, d_slab, ax_n, ay_n, cam_arrays, xform,
                         perm, flipped, settings.supersample, width, height)
    e, _, clo, chi, z_ref, in_front = geo[:6]
    (x_lo, x_hi, y_lo, y_hi), xs, ys, _ = geo[6:]
    wi, hi = xs.shape[0], ys.shape[0]

    z_ks, y_pairs, x_pairs, _, _ = _per_slab_state(
        e, z_ref, xs, ys, d_slab, ax_n, ay_n, banded=True)
    # no occupancy: an empty-looking slab may still hold the isovalue
    keep = in_front & (z_ks >= clo[2]) & (z_ks <= chi[2])
    covy, covx = _coverage_masks(geo, z_ks, ax_n, ay_n, keep)
    frame = (perm, flipped, e, eye_w, size_z, z_ref, x_lo, x_hi, y_lo, y_hi,
             xs, ys, wi, hi, xform)
    return (fields, y_pairs, x_pairs, covy, covx), frame


@torch.no_grad()
def slab_iso_render(volume: torch.Tensor, grad_volumes: torch.Tensor,
                    tf: TransferFunction, width: int, height: int,
                    settings: IsoSettings, axis: int, flipped: bool,
                    cam_arrays, isovalue: float, xform=None) -> torch.Tensor:
    """One frame → rgba [height·width, 4]; alpha is the hit mask (warped
    bilinearly, so silhouettes come out antialiased)."""
    from instantvnr_torch.ops.iso_sweep import iso_sweep

    sweep_args, frame = slab_iso_args(volume, grad_volumes, width, height,
                                      settings, axis, flipped, cam_arrays,
                                      xform)
    found_f, hit_z, hit_g = iso_sweep(*sweep_args, isovalue)
    return _shade_and_warp(found_f > 0.5, hit_z, hit_g, tf, isovalue,
                           settings, cam_arrays, width, height, *frame)


def _shade_and_warp(found, hit_z, hit_g, tf, iso, settings, cam_arrays,
                    width, height, perm, flipped, e, eye_w, size_z, z_ref,
                    x_lo, x_hi, y_lo, y_hi, xs, ys, wi, hi, xform):
    """Shade the first-hit state and warp it to the screen."""
    # hit position: the intermediate-pixel ray's intersection with the
    # plane z = hit_z (the mapping the resampling used)
    ratio = (hit_z - e[2]) / (z_ref - e[2])
    x_hit = e[0] + (xs[None, :] - e[0]) * ratio
    y_hit = e[1] + (ys[:, None] - e[1]) * ratio
    p_perm = [x_hit, y_hit, hit_z if not flipped else size_z - hit_z]
    p_world = [None, None, None]
    for i_ax in range(3):
        p_world[perm[i_ax]] = p_perm[i_ax]
    p_world = torch.stack(p_world, dim=-1)  # [hi, wi, 3] voxel coords
    view = (p_world - eye_w[None, None, :]) * xform.scale
    view = view / torch.clamp(
        torch.linalg.vector_norm(view, dim=-1, keepdim=True), min=1e-9)

    normal = -hit_g / xform.scale  # diagonal xfmNormal
    light = _flip_light(settings, cam_arrays)
    base = _albedo(tf, iso, settings, hit_z.device).expand(hi, wi, 3)
    shaded = _shade_scivis(view, normal, base, light_dir=light)
    s_ = settings.shading_scale
    color = torch.where(found[..., None], s_ * shaded + (1.0 - s_) * base,
                        torch.zeros_like(shaded))
    alpha_img = found.to(torch.float32)
    return _final_warp(color, alpha_img, cam_arrays, width, height, perm,
                       flipped, e, z_ref, x_lo, x_hi, y_lo, y_hi, wi, hi,
                       xform.scale)


@torch.no_grad()
def _brute_init(volume, cam_arrays, width: int, height: int, xform):
    """Ray setup of the brute marcher: voxel-space rays (t world-metric),
    the world directions and the clipped t range."""
    from instantvnr_torch.render.transform import clip_bounds, rays_to_voxel

    dev = volume.device
    dz, dy, dx = volume.shape
    dims_w = device_constant((float(dx), float(dy), float(dz)),
                             torch.float32, dev)
    cam = Camera(eye=cam_arrays[0], center=cam_arrays[1], up=cam_arrays[2],
                 fovy=cam_arrays[3])
    org_w, dir_w = camera_rays(cam, width, height, device=dev)
    org, dirn = rays_to_voxel(xform, dims_w, org_w, dir_w)
    lo, hi = clip_bounds(xform, dims_w)
    t0, t1, hit = ray_box_intersect(org, dirn, lo, hi)
    t0 = torch.where(hit, torch.clamp(t0, min=0.0), 1.0)
    t1 = torch.where(hit, t1, 0.0)
    return org, dirn, dir_w, t0, t1


def _value_at(volume, org, dirn, t):
    from instantvnr_torch.ops.trilinear import sample_volume_voxel

    return sample_volume_voxel(volume, org + t[:, None] * dirn)


@torch.no_grad()
def _brute_march_chunk(volume, org, dirn, t0, t1, iso, step, carry,
                       chunk: int, i0: int, n_steps: int):
    """`chunk` fixed steps from global step i0: each tests the segment
    [prev_t, min(t, t1)] for a sign change of value − iso and keeps the
    first crossing's bracket. Steps past n_steps change nothing."""
    prev_t, prev_v, found, ta, tb, va, vb = carry
    for gi in range(i0, min(i0 + chunk, n_steps)):
        t = t0 + (float(gi) + 1.0) * step
        t_c = torch.minimum(t, t1)
        # test the segment whenever it is non-empty: requiring t <= t1 would
        # skip the final partial segment up to the clip exit
        ok = prev_t < t1
        v = _value_at(volume, org, dirn, t_c)
        cross = ok & ~found & ((prev_v - iso) * (v - iso) <= 0.0)
        ta = torch.where(cross, prev_t, ta)
        tb = torch.where(cross, t_c, tb)
        va = torch.where(cross, prev_v, va)
        vb = torch.where(cross, v, vb)
        found = found | cross
        prev_t, prev_v = t_c, v
    return prev_t, prev_v, found, ta, tb, va, vb


@torch.no_grad()
def brute_iso_render(volume: torch.Tensor, tf: TransferFunction, width: int,
                     height: int, settings: IsoSettings, n_steps: int,
                     cam_arrays, isovalue: float, xform=None,
                     chunk: int = 16) -> torch.Tensor:
    """The exact fallback: a per-pixel fixed-step first-hit march and a
    bisection, → rgba [H·W, 4] (alpha the hit mask). Gather-bound (8 taps a
    step a ray); the slab sweep is the fast path, this covers degenerate
    cameras."""
    from instantvnr_torch.render.transform import default_transform

    dz, dy, dx = volume.shape
    if xform is None:
        xform = default_transform((dx, dy, dz), volume.device)
    org, dirn, dir_w, t0, t1 = _brute_init(volume, cam_arrays, width, height,
                                           xform)
    iso = float(isovalue)
    step = 1.0 * xform.scale.min() / settings.sampling_rate
    r = org.shape[0]
    zeros = torch.zeros((r,), dtype=torch.float32, device=volume.device)
    v0 = _value_at(volume, org, dirn, t0)
    carry = (t0, v0, torch.zeros((r,), dtype=torch.bool,
                                 device=volume.device),
             zeros, zeros, zeros, zeros)
    for c in range(-(-n_steps // chunk)):
        carry = _brute_march_chunk(volume, org, dirn, t0, t1, iso, step,
                                   carry, chunk, c * chunk, n_steps)
    _, _, found, ta, tb, va, vb = carry
    return _brute_finish(volume, tf, settings, found, ta, tb, va, vb, org,
                         dirn, dir_w, iso, cam_arrays, xform)


@torch.no_grad()
def _brute_finish(volume, tf, settings: IsoSettings, found, ta, tb, va, vb,
                  org, dirn, dir_w, iso, cam_arrays, xform):
    """Bisection refinement and shading of the brute march's crossings."""
    from instantvnr_torch.ops.trilinear import sample_volume_voxel

    for _ in range(settings.n_refine):
        tm = 0.5 * (ta + tb)
        vm = _value_at(volume, org, dirn, tm)
        left = (va - iso) * (vm - iso) <= 0.0
        ta, va, tb, vb = (torch.where(left, ta, tm), torch.where(left, va, vm),
                          torch.where(left, tm, tb), torch.where(left, vm, vb))
    denom = vb - va
    frac = torch.where(torch.abs(denom) > 1e-12, (iso - va) / denom, 0.5)
    t_hit = ta + torch.clamp(frac, 0.0, 1.0) * (tb - ta)
    p = org + t_hit[:, None] * dirn  # voxel coords
    dev = volume.device

    def cd(axis_vec):  # central difference in voxel space
        d = device_constant(axis_vec, torch.float32, dev)
        return (sample_volume_voxel(volume, p + d)
                - sample_volume_voxel(volume, p - d)) * 0.5

    g = torch.stack([cd((1.0, 0.0, 0.0)), cd((0.0, 1.0, 0.0)),
                     cd((0.0, 0.0, 1.0))], dim=-1)
    normal = -g / xform.scale  # world space, through the diagonal scale
    light = _flip_light(settings, cam_arrays)
    base = _albedo(tf, iso, settings, dev).expand(org.shape[0], 3)
    view = dir_w / torch.clamp(torch.linalg.vector_norm(dir_w, dim=-1,
                                                        keepdim=True),
                               min=1e-9)
    shaded = _shade_scivis(view, normal, base, light_dir=light)
    s_ = settings.shading_scale
    color = torch.where(found[:, None], s_ * shaded + (1.0 - s_) * base,
                        torch.zeros_like(shaded))
    return torch.cat([color, found.to(torch.float32)[:, None]], dim=-1)


class IsoRenderer:
    """Interactive isosurface viewer backend: holds the grid and its
    gradients, renders first-hit frames; isovalue edits rebuild nothing."""

    def __init__(self, width: int, height: int, grid, tf: TransferFunction,
                 isovalue: float = 0.5, settings: IsoSettings | None = None,
                 transform=None, device="cuda"):
        from instantvnr_torch.render.transform import default_transform
        from instantvnr_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.width, self.height = width, height
        self.tf = tf
        self.settings = settings or IsoSettings()
        self.isovalue = float(isovalue)
        self._frame = None
        self.set_grid(grid)
        dz, dy, dx = self.grid.shape
        self.volume_dims = (dx, dy, dz)
        self.camera = Camera.default_for_dims(self.volume_dims)
        self.set_transform(transform or default_transform(self.volume_dims,
                                                          self.device))

    def set_camera(self, cam: Camera):
        self.camera = cam

    def set_isovalue(self, isovalue: float):
        self.isovalue = float(isovalue)

    def set_grid(self, grid):
        """Rebind to a new decoded grid (online training refresh)."""
        self.grid = torch.as_tensor(grid, dtype=torch.float32,
                                    device=self.device)
        self._grads = None

    def set_transform(self, transform):
        """Keeps a host copy of the scale for the per-frame axis pick."""
        self.transform = transform
        self._scale_h = transform.scale.detach().cpu().numpy()

    def render(self):
        cam = self.camera
        axis, flipped = principal_axis(cam, self._scale_h)
        if not slab_path_valid(cam, self.volume_dims, axis, flipped,
                               self._scale_h,
                               aspect=self.width / float(self.height)):
            # degenerate camera: the brute-force first-hit marcher, over
            # enough steps to cross the scaled volume's diagonal
            scale_h = self._scale_h
            diag = float(np.linalg.norm(
                np.asarray(self.volume_dims, np.float32)
                * np.maximum(scale_h, 1e-9)))
            n_steps = int(np.ceil(diag * self.settings.sampling_rate
                                  / max(float(scale_h.min()), 1e-9)))
            self._frame = brute_iso_render(
                self.grid, self.tf, self.width, self.height, self.settings,
                n_steps, camera_arrays(cam, self.device), self.isovalue,
                self.transform)
            return self._frame
        if self._grads is None:
            self._grads = compute_gradient_volumes(self.grid)
        self._frame = slab_iso_render(
            self.grid, self._grads, self.tf, self.width, self.height,
            self.settings, axis, flipped, camera_arrays(cam, self.device),
            self.isovalue, self.transform)
        return self._frame

    def mapframe(self) -> np.ndarray:
        return self._frame.detach().cpu().numpy().reshape(
            self.height, self.width, 4)
