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

The brute-force first-hit marcher that the JAX package uses for degenerate
cameras (render/isosurf.py:244-381, over ops/trilinear.py) is not ported
and raises NotImplementedError naming its ROADMAP item; mesh extraction
(ops/isosurface.py) is a later item as well.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.raymarch import DEFAULT_LIGHT, _shade_scivis
from instantvnr_torch.render.slabmarch import (
    FALLBACK_ITEM,
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
from instantvnr_torch.utils.tfn import TransferFunction, classify_controls


@dataclass(frozen=True)
class IsoSettings:
    supersample: float = 1.0
    shading_scale: float = 0.95  # scivis blend (as the volume modes)
    light_dir: tuple = DEFAULT_LIGHT  # instantvnr_types.h:148
    color: tuple | None = None  # fixed albedo; None → TF color at isovalue


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

    z_ks, y_pairs, x_pairs, x_src, y_src = _per_slab_state(
        e, z_ref, xs, ys, d_slab, ax_n, ay_n, banded=True)
    # no occupancy: an empty-looking slab may still hold the isovalue
    keep = in_front & (z_ks >= clo[2]) & (z_ks <= chi[2])
    covy, covx = _coverage_masks(y_pairs[1], x_pairs[1], x_src, y_src, clo,
                                 chi, keep)
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
            raise NotImplementedError(
                "degenerate camera for the slab sweep (the frustum looks "
                "backward along the principal axis); its brute-force "
                "first-hit marcher is not ported yet: " + FALLBACK_ITEM)
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
