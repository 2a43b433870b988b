"""Slab-compositing volume renderer (counterpart of
`instantvnr_tpu/render/slabmarch.py`).

Perspective shear-warp factorization: pick the principal volume axis,
composite axis-aligned slabs front to back into an intermediate image on
the reference plane through the eye (each slab's projection is a uniform
scale about the epipole, so it resamples with two banded interpolation
matrices, My [hi, ay] and Mx [wi, ax], of at most two nonzeros a row), then
one final 2-D projective warp to the screen. The compositors take those
matrices as per-row pairs (`_interp_pairs`: the first column and its two
weights), and so does the isosurface sweep (render/isosurf.py). The
per-slab loop runs in a slab compositor
(ops/slab_composite.py): `composite_slabs` unshaded, `composite_slabs_ext`
with gradient shading (the value and its central-difference world gradient
resampled with the same matrices, shaded with the scivis model) and/or a
shadow volume (render/shadow.py); the CUDA kernels on the card, their plain
versions on the CPU.

A degenerate camera (`slab_path_valid` false) has no slab factorization;
render/decoded.py marches it with the wavefront (render/raymarch.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from instantvnr_torch.render.camera import Camera
from instantvnr_torch.render.raymarch import DEFAULT_LIGHT
from instantvnr_torch.render.transform import clip_bounds
from instantvnr_torch.utils.math import normalize
from instantvnr_torch.utils.tfn import TransferFunction

@dataclass(frozen=True)
class SlabSettings:
    sampling_rate: float = 1.0  # opacity-correction exponent
    density_scale: float = 1.0
    supersample: float = 1.0  # intermediate image resolution multiplier
    skip_empty_slabs: bool = True
    shading: str = "none"  # "none" | "gradient" (scivis, raytracing.h:224-246)
    shading_scale: float = 0.95  # scivis_shading_scale lerp
    light_dir: tuple = DEFAULT_LIGHT  # instantvnr_types.h:148
    shadow_ambient: float = 0.35  # floor when a shadow volume is attached


def compute_gradient_volumes(volume: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient of the grid with clamped edges, WORLD
    components: [3, dz, dy, dx] = (∂/∂x, ∂/∂y, ∂/∂z) from volume axes
    (2, 1, 0). Computed once per decode; 3× the volume's memory."""

    def central(dim):
        n = volume.shape[dim]
        lo = torch.cat([volume.narrow(dim, 0, 1), volume.narrow(dim, 0, n - 1)],
                       dim=dim)
        hi = torch.cat([volume.narrow(dim, 1, n - 1),
                        volume.narrow(dim, n - 1, 1)], dim=dim)
        return (hi - lo) * 0.5

    return torch.stack([central(2), central(1), central(0)])


def principal_axis(cam: Camera, scale=None) -> tuple[int, bool]:
    """(axis ∈ {0,1,2} for x/y/z, flipped), host-side. The view direction
    is mapped through S⁻¹ first: the slab axis must dominate in voxel
    space."""
    eye = np.asarray(cam.eye, np.float32)
    center = np.asarray(cam.center, np.float32)
    d = center - eye
    if scale is not None:
        d = d / np.asarray(scale, np.float32)
    d = d / (np.linalg.norm(d) + 1e-20)
    axis = int(np.argmax(np.abs(d)))
    return axis, bool(d[axis] < 0)


# for each principal axis: the [dz, dy, dx] volume's axes in the permuted
# (D, ay, ax) order, and perm, which maps (x, y, z) world components to
# (ax, ay, az)
_AXIS_ORDER = {2: ((0, 1, 2), (0, 1, 2)),
               1: ((1, 0, 2), (0, 2, 1)),
               0: ((2, 0, 1), (1, 2, 0))}


def _permute_volume(volume: torch.Tensor, axis: int, flipped: bool):
    """Reorder [dz,dy,dx] so the principal axis becomes the leading slab
    axis, marching in + direction. Returns (vol [D, ay, ax], perm) where
    perm maps (x,y,z) world components to (ax, ay, az)."""
    order, perm = _AXIS_ORDER[axis]
    vol = volume.permute(*order)
    if flipped:
        vol = torch.flip(vol, dims=(0,))
    return vol.contiguous(), perm


def _interp_weights(src, j, n_in: int) -> torch.Tensor:
    """Bilinear weight of source voxel j (float, center at j + 0.5) for
    the sample at src (both broadcast): 1 − |src − j| clamped at 0, the
    out-of-edge weight folded back to the edge voxel, 0 for a sample
    outside the volume (transparent)."""
    w = torch.clamp(1.0 - torch.abs(src - j), min=0.0)
    edge = ((src < 0.0) & (j == 0)) | ((src > n_in - 1.0) & (j == n_in - 1.0))
    in_range = (src > -0.5) & (src < n_in - 0.5)
    w = torch.where(edge, torch.ones_like(w), w)
    return torch.where(in_range, w, torch.zeros_like(w))


def _interp_src(n_out: int, scale: torch.Tensor, offset: torch.Tensor):
    """[D, n_out, 1] source coordinates src = offset + i·scale − 0.5."""
    i = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    return (offset[:, None] + i[None, :] * scale[:, None] - 0.5)[..., None]


def _interp_matrix(n_out: int, n_in: int, scale: torch.Tensor,
                   offset: torch.Tensor) -> torch.Tensor:
    """Banded bilinear interpolation matrices, batched over the leading dim
    of scale/offset [D] → M [D, n_out, n_in]: out[i] = Σ_j M[i,j]·in[j],
    sampling at src = offset + i·scale (voxel j's center at j+0.5).
    Out-of-range rows are all-zero (transparent outside the volume)."""
    j = torch.arange(n_in, dtype=torch.float32, device=scale.device)
    return _interp_weights(_interp_src(n_out, scale, offset), j, n_in)


def _interp_pairs(n_out: int, n_in: int, scale: torch.Tensor,
                  offset: torch.Tensor):
    """`_interp_matrix` as per-row pairs: → (j0 [D, n_out] int32, w
    [D, n_out, 2] float32), the weights of columns j0 = clamp(floor(src),
    0, n_in − 2) and j0 + 1. A row of the matrix has its nonzeros only
    there (|src − j| < 1, or the folded edge), and the weights come from
    the same float32 operations (`_interp_weights`), so `_densify_pairs`
    gives `_interp_matrix` bit for bit. An axis of one voxel has one
    column: its pair is (0, (w₀, 0)), w₀ the sole voxel's weight (1 on
    every in-range row, as the dense matrix folds both edges onto it); the
    readers clamp column j0 + 1 to n_in − 1."""
    src = _interp_src(n_out, scale, offset)
    if n_in == 1:
        # clamp(min=0, max=-1) would give −1; computed, the second weight
        # would be max(0, src) on a column that does not exist
        j0 = torch.zeros_like(src)
        w0 = _interp_weights(src, j0, n_in)
        w = torch.cat([w0, torch.zeros_like(w0)], dim=-1)
    else:
        j0 = torch.clamp(torch.floor(src), 0.0, n_in - 2.0)
        w = _interp_weights(src, torch.cat([j0, j0 + 1.0], dim=-1), n_in)
    return j0[..., 0].to(torch.int32), w


def _densify_pairs(pairs, n_in: int) -> torch.Tensor:
    """(j0 [D, n], w [D, n, 2]) → the dense [D, n, n_in] matrices. The
    second weight goes first onto column min(j0 + 1, n_in − 1), so on a
    one-voxel axis the first (w₀ on column 0) overwrites its zero."""
    j0, w = pairs
    j0 = j0.to(torch.int64)[..., None]
    dense = torch.zeros(w.shape[:2] + (n_in,), dtype=w.dtype,
                        device=w.device)
    dense.scatter_(-1, torch.clamp(j0 + 1, max=n_in - 1), w[..., 1:])
    return dense.scatter_(-1, j0, w[..., :1])


def _pixel_dt(xs, ys, e, z_ref, s_perm):
    """Per-intermediate-pixel world step length between slabs (constant
    across slabs for a pinhole camera)."""
    fx = (xs[None, :] - e[0]) / (z_ref - e[2])
    fy = (ys[:, None] - e[1]) / (z_ref - e[2])
    return torch.sqrt((fx * s_perm[0]) ** 2 + (fy * s_perm[1]) ** 2
                      + s_perm[2] ** 2)


def _per_slab_state(e, z_ref, xs, ys, d_slab: int, ax_n: int, ay_n: int,
                    z0=0.0, banded: bool = False):
    """Per-slab separable resampling state: (z_k [D], my_all [D, hi, ay],
    mx_all [D, wi, ax], x_src [D, wi], y_src [D, hi]); with `banded`,
    my_all and mx_all are `_interp_pairs` ((j0 [D, n], w [D, n, 2]))."""
    wi, hi = xs.shape[0], ys.shape[0]
    dev = xs.device
    z_k = z0 + torch.arange(d_slab, dtype=torch.float32, device=dev) + 0.5
    inv_s = (z_k - e[2]) / (z_ref - e[2])  # 1/σ_k
    off_x = e[0] + (xs[0] - e[0]) * inv_s
    scale_x = (xs[1] - xs[0]) * inv_s
    off_y = e[1] + (ys[0] - e[1]) * inv_s
    scale_y = (ys[1] - ys[0]) * inv_s
    interp = _interp_pairs if banded else _interp_matrix
    mx_all = interp(wi, ax_n, scale_x, off_x)
    my_all = interp(hi, ay_n, scale_y, off_y)
    x_src = off_x[:, None] + torch.arange(
        wi, dtype=torch.float32, device=dev)[None, :] * scale_x[:, None]
    y_src = off_y[:, None] + torch.arange(
        hi, dtype=torch.float32, device=dev)[None, :] * scale_y[:, None]
    return z_k, my_all, mx_all, x_src, y_src


def _exact_src(e_c, e_z, z_ref, z_ks, lo, hi, n_out: int) -> torch.Tensor:
    """[D, n_out] source coordinates along one in-slab axis (voxel j's
    center at j + 0.5), each the float32 rounding of its exact value: the
    ray from the eye through intermediate pixel i's center
    X_i = lo + (i + 0.5)·(hi − lo)/n_out on the reference plane meets slab
    k at e_c + (X_i − e_c)·(z_k − e_z)/(z_ref − e_z). Computed in float64
    from the frame's float32 bounds and rounded once, so a ray that grazes
    a face of the volume (or of the clip box) lands on it, where the
    float32 chain of `_per_slab_state` may round either way."""
    f8 = torch.float64
    i = torch.arange(n_out, dtype=f8, device=z_ks.device)
    lo, hi, e_c = lo.to(f8), hi.to(f8), e_c.to(f8)
    x = lo + (i + 0.5) * (hi - lo) / n_out
    r = (z_ks.to(f8) - e_z.to(f8)) / (z_ref.to(f8) - e_z.to(f8))
    return (e_c + (x[None, :] - e_c) * r[:, None]).to(torch.float32)


def _coverage_masks(geo, z_ks, ax_n: int, ay_n: int, keep):
    """Separable coverage/clip masks: covx [D, wi] folds in the per-slab
    keep mask (occupancy/in-front/z-clip), covy [D, hi] the row terms. A
    pixel is covered where its source coordinate lies inside the volume,
    0 < s < n (the rows where `_interp_matrix` is nonzero) and inside the
    clip box, clo ≤ s ≤ chi, tested on `_exact_src`: the JAX package tests
    the float32 chain's rows, which parts from the exact test only where a
    ray grazes a face, and there by the rounding of its compiler
    (ROADMAP Queue 3)."""
    e, _, clo, chi, z_ref = geo[:5]
    x_lo, x_hi, y_lo, y_hi = geo.bounds
    x_src = _exact_src(e[0], e[2], z_ref, z_ks, x_lo, x_hi,
                       geo.xs.shape[0])
    y_src = _exact_src(e[1], e[2], z_ref, z_ks, y_lo, y_hi,
                       geo.ys.shape[0])
    covx = ((x_src > 0) & (x_src < ax_n) & (x_src >= clo[0])
            & (x_src <= chi[0]) & keep[:, None]).to(torch.float32)
    covy = ((y_src > 0) & (y_src < ay_n) & (y_src >= clo[1])
            & (y_src <= chi[1])).to(torch.float32)
    return covy, covx


class _FrameGeometry(NamedTuple):
    """Camera-derived per-frame state of the shear-warp factorization."""

    e: torch.Tensor        # eye, permuted voxel space (flip-normalized)
    s_perm: torch.Tensor   # permuted voxel→world scale
    clo: torch.Tensor      # clip box, permuted voxel coords
    chi: torch.Tensor
    z_ref: torch.Tensor    # reference slab plane
    in_front: torch.Tensor  # [D] slabs in front of the eye
    bounds: tuple          # (x_lo, x_hi, y_lo, y_hi) intermediate domain
    xs: torch.Tensor       # [wi] intermediate pixel centers
    ys: torch.Tensor       # [hi]
    dt: torch.Tensor       # [hi, wi] world step between slabs


def frame_geometry(dims_w, d_slab: int, ax_n: int, ay_n: int, cam_arrays,
                   xform, perm, flipped: bool, supersample: float,
                   width: int, height: int) -> _FrameGeometry:
    """Camera/clip-derived frame state in PERMUTED voxel space."""
    dev = dims_w.device
    p = list(perm)
    eye_w = cam_arrays[0] / xform.scale + 0.5 * dims_w
    e = eye_w[p].clone()
    s_perm = xform.scale[p]
    size_z = dims_w[perm[2]]
    clip_lo_w, clip_hi_w = clip_bounds(xform, dims_w)
    clo = clip_lo_w[p].clone()
    chi = clip_hi_w[p].clone()
    if flipped:
        e[2] = size_z - e[2]
        clo_z, chi_z = size_z - chi[2], size_z - clo[2]
        clo[2] = clo_z
        chi[2] = chi_z

    z_ref = torch.clamp(torch.floor(e[2] + 0.5), 0.0, d_slab - 1.0) + 0.5
    slab_zs = torch.arange(d_slab, dtype=torch.float32, device=dev) + 0.5
    in_front = slab_zs >= z_ref - 1e-3

    sigma_far = (z_ref - e[2]) / (d_slab - 0.5 - e[2])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    x_lo = torch.minimum(zero, e[0] + sigma_far * (0.0 - e[0]))
    x_hi = torch.maximum(zero + ax_n, e[0] + sigma_far * (ax_n - e[0]))
    y_lo = torch.minimum(zero, e[1] + sigma_far * (0.0 - e[1]))
    y_hi = torch.maximum(zero + ay_n, e[1] + sigma_far * (ay_n - e[1]))

    wi = int(width * supersample)
    hi = int(height * supersample)
    xs = x_lo + (torch.arange(wi, dtype=torch.float32, device=dev) + 0.5) \
        * (x_hi - x_lo) / wi
    ys = y_lo + (torch.arange(hi, dtype=torch.float32, device=dev) + 0.5) \
        * (y_hi - y_lo) / hi

    return _FrameGeometry(e, s_perm, clo, chi, z_ref, in_front,
                          (x_lo, x_hi, y_lo, y_hi), xs, ys,
                          _pixel_dt(xs, ys, e, z_ref, s_perm))


def camera_arrays(cam: Camera, device) -> tuple:
    """(eye, center, up, fovy) as float32 tensors on `device`."""
    f = torch.float32
    return (torch.as_tensor(cam.eye, dtype=f, device=device),
            torch.as_tensor(cam.center, dtype=f, device=device),
            torch.as_tensor(cam.up, dtype=f, device=device),
            torch.as_tensor(float(cam.fovy), dtype=f, device=device))


def permuted_dims(dims_zyx, axis: int) -> tuple[int, int, int]:
    """(D, ay, ax) of a [dz, dy, dx] volume under `_permute_volume`."""
    return tuple(int(dims_zyx[i]) for i in _AXIS_ORDER[axis][0])


class SlabFrameState(NamedTuple):
    """The per-frame inputs of the slab compositors that do not read the
    volume: the per-slab rows (`y_pairs`, `x_pairs`, `covy`, `covx`, and
    for `composite_slabs_ext` `x_src`, `y_src`, `zw`), the per-pixel
    `corr_exp`, the ext compositor's `misc` (None without it), `perm` and
    the arguments of `_final_warp` after (color, alpha)."""

    y_pairs: tuple
    x_pairs: tuple
    covy: torch.Tensor
    covx: torch.Tensor
    corr_exp: torch.Tensor
    x_src: torch.Tensor
    y_src: torch.Tensor
    zw: torch.Tensor
    misc: torch.Tensor | None
    perm: tuple
    warp: tuple

    def slabs(self, k0: int, k1: int) -> "SlabFrameState":
        """The state of slabs [k0, k1): a chunk of the frame's slabs."""
        def rows(a):
            return a[k0:k1]

        return self._replace(
            y_pairs=tuple(rows(a) for a in self.y_pairs),
            x_pairs=tuple(rows(a) for a in self.x_pairs),
            covy=rows(self.covy), covx=rows(self.covx),
            x_src=rows(self.x_src), y_src=rows(self.y_src),
            zw=rows(self.zw))


@torch.no_grad()
def slab_frame_state(dims_zyx, device, cam_arrays, width: int, height: int,
                     settings: SlabSettings, axis: int, flipped: bool,
                     slab_occupancy: torch.Tensor | None = None, xform=None,
                     ext: bool = False) -> SlabFrameState:
    """The frame's `SlabFrameState` from the volume's dims [dz, dy, dx]
    alone, so that a slab-sharded frame (parallel/slab.py) builds it with
    no volume on the device; `ext` adds `misc` for
    `composite_slabs_ext`."""
    from instantvnr_torch.ops.slab_composite import pack_misc
    from instantvnr_torch.render.transform import default_transform

    dev = torch.device(device)
    dz, dy, dx = (int(d) for d in dims_zyx)
    dims_w = torch.tensor([dx, dy, dz], dtype=torch.float32, device=dev)
    if xform is None:
        xform = default_transform((dx, dy, dz), dev)
    perm = _AXIS_ORDER[axis][1]
    d_slab, ay_n, ax_n = permuted_dims(dims_zyx, axis)
    geo = frame_geometry(dims_w, d_slab, ax_n, ay_n, cam_arrays, xform,
                         perm, flipped, settings.supersample, width, height)
    e, _, clo, chi, z_ref, in_front = geo[:6]
    (x_lo, x_hi, y_lo, y_hi), xs, ys, dt = geo[6:]
    corr_exp = settings.sampling_rate * settings.density_scale * dt

    if slab_occupancy is None:
        slab_occupancy = torch.ones((d_slab,), dtype=torch.bool, device=dev)
    slab_occupancy = slab_occupancy & in_front

    z_ks, y_pairs, x_pairs, x_src, y_src = _per_slab_state(
        e, z_ref, xs, ys, d_slab, ax_n, ay_n, banded=True)
    keep = slab_occupancy & (z_ks >= clo[2]) & (z_ks <= chi[2])
    covy, covx = _coverage_masks(geo, z_ks, ax_n, ay_n, keep)
    warp = (cam_arrays, width, height, perm, flipped, e, z_ref, x_lo, x_hi,
            y_lo, y_hi, xs.shape[0], ys.shape[0], xform.scale)
    size_z = dims_w[perm[2]]
    zw = size_z - z_ks if flipped else z_ks  # unflipped permuted voxel z
    misc = None
    if ext:
        # the light flips against the view (renderer.cpp:98-100)
        light = torch.as_tensor(settings.light_dir, dtype=torch.float32,
                                device=dev)
        cam_fwd = cam_arrays[1] - cam_arrays[0]
        light = torch.where(torch.dot(cam_fwd, light) > 0, -light, light)
        light = light / torch.linalg.vector_norm(light)
        eye_w = cam_arrays[0] / xform.scale + 0.5 * dims_w  # voxel, world
        misc = pack_misc(settings.shadow_ambient, settings.shading_scale,
                         light, eye_w, xform.scale)
    return SlabFrameState(y_pairs, x_pairs, covy, covx,
                          corr_exp.contiguous(), x_src, y_src, zw, misc,
                          perm, warp)


@torch.no_grad()
def slab_composite_args(volume: torch.Tensor, tf: TransferFunction,
                        cam_arrays, width: int, height: int,
                        settings: SlabSettings, axis: int, flipped: bool,
                        slab_occupancy: torch.Tensor | None = None,
                        xform=None, grad_volumes: torch.Tensor | None = None,
                        shadow_volume: torch.Tensor | None = None):
    """The per-frame inputs of the slab compositor. Returns
    (compositor, args, warp): `compositor(*args)` composites the
    intermediate image and `_final_warp(color, alpha, *warp)` maps it to the
    screen. The compositor is `composite_slabs_ext` when gradient shading
    (settings.shading == "gradient" with grad_volumes [3, dz, dy, dx]) or a
    shadow volume [dz, dy, dx] is on, else `composite_slabs`, as the JAX
    package dispatches (slabmarch.py:455-473)."""
    from instantvnr_torch.ops.slab_composite import (composite_slabs,
                                                     composite_slabs_ext,
                                                     pack_controls, pack_lut)

    use_shading = settings.shading == "gradient" and grad_volumes is not None
    use_shadow = shadow_volume is not None
    st = slab_frame_state(volume.shape, volume.device, cam_arrays, width,
                          height, settings, axis, flipped, slab_occupancy,
                          xform, ext=use_shading or use_shadow)
    vol, _ = _permute_volume(volume, axis, flipped)
    if not (use_shading or use_shadow):
        args = (vol, st.y_pairs, st.x_pairs, st.covy, st.covx, st.corr_exp,
                pack_controls(tf), pack_lut(tf))
        return composite_slabs, args, st.warp

    if use_shading:
        fields = torch.stack(
            [vol] + [_permute_volume(grad_volumes[i], axis, flipped)[0]
                     for i in range(3)], dim=1)  # [D, 4, ay, ax]
    else:
        fields = vol[:, None]
    svol = (_permute_volume(shadow_volume, axis, flipped)[0] if use_shadow
            else None)
    args = (fields, svol, st.y_pairs, st.x_pairs, st.covy, st.covx,
            st.corr_exp, st.x_src, st.y_src, st.zw, pack_controls(tf),
            st.misc, st.perm, pack_lut(tf))
    return composite_slabs_ext, args, st.warp


@torch.no_grad()
def slab_render(volume: torch.Tensor, tf: TransferFunction, cam_arrays,
                width: int, height: int, settings: SlabSettings, axis: int,
                flipped: bool, slab_occupancy: torch.Tensor | None = None,
                xform=None, grad_volumes: torch.Tensor | None = None,
                shadow_volume: torch.Tensor | None = None) -> torch.Tensor:
    """Render one frame → rgba [height·width, 4] (row-major, bottom-left
    origin)."""
    compositor, args, warp = slab_composite_args(
        volume, tf, cam_arrays, width, height, settings, axis, flipped,
        slab_occupancy, xform, grad_volumes, shadow_volume)
    color, alpha_img = compositor(*args)
    return _final_warp(color, alpha_img, *warp)


def _final_warp(color, alpha_img, cam_arrays, width, height, perm, flipped,
                e, z_ref, x_lo, x_hi, y_lo, y_hi, wi, hi, scale=None):
    """Reference plane → screen (the frame's only gather)."""
    dev = color.device
    eye = cam_arrays[0]
    direction = normalize(cam_arrays[1] - eye)
    up = cam_arrays[2]
    t2 = 2.0 * torch.tan(cam_arrays[3] * np.float32(np.pi) / 360.0)
    aspect = width / float(height)
    horizontal = t2 * aspect * normalize(torch.linalg.cross(direction, up))
    vertical = torch.linalg.cross(horizontal, direction) / aspect

    py, px = torch.meshgrid(
        (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height,
        (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width,
        indexing="ij",
    )
    d = (direction[None, None, :]
         + (px - 0.5)[..., None] * horizontal[None, None, :]
         + (py - 0.5)[..., None] * vertical[None, None, :])  # [H, W, 3]
    if scale is not None:
        d = d / scale  # world → voxel direction (anisotropic scaling)
    d_p = d[..., list(perm)]
    if flipped:
        d_p = torch.cat([d_p[..., :2], -d_p[..., 2:]], dim=-1)
    tt = (z_ref - e[2]) / d_p[..., 2]
    hit = tt > 0
    px_ref = e[0] + tt * d_p[..., 0]
    py_ref = e[1] + tt * d_p[..., 1]
    u = (px_ref - x_lo) / (x_hi - x_lo) * wi - 0.5
    v = (py_ref - y_lo) / (y_hi - y_lo) * hi - 0.5
    rgba_i = torch.cat([color, alpha_img[..., None]], dim=-1)  # [hi, wi, 4]
    out = _bilinear2d(rgba_i, v, u)
    out = torch.where(hit[..., None], out, torch.zeros_like(out))
    return out.reshape(height * width, 4)


def _bilinear2d(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """img [H, W, C] sampled at continuous (y, x); zero outside."""
    h, w = img.shape[:2]
    inside = (x > -1.0) & (x < w) & (y > -1.0) & (y < h)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    c0 = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    c1 = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    out = c0 * (1 - fy) + c1 * fy
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def slab_occupancy_from_macrocell(mc, axis: int, flipped: bool,
                                  d_slab: int) -> torch.Tensor:
    """Per-slab occupancy [D]: does any macrocell in the slab's cell layer
    have nonzero max opacity? Each (possibly flipped) slab maps to its
    ORIGINAL voxel index before binning into cells."""
    from instantvnr_torch.accel.macrocell import MACROCELL_SIZE

    occ = mc.max_opacity > 1e-6  # [mz, my, mx]
    if axis == 2:
        layer = occ.any(dim=2).any(dim=1)  # [mz]
    elif axis == 1:
        layer = occ.any(dim=2).any(dim=0)  # [my]
    else:
        layer = occ.any(dim=1).any(dim=0)  # [mx]
    idx = torch.arange(d_slab, device=occ.device)
    if flipped:
        idx = d_slab - 1 - idx
    cell = torch.clamp(idx // MACROCELL_SIZE, max=layer.shape[0] - 1)
    return layer[cell]


def eye_outside_slab_range(cam: Camera, dims, axis: int, scale=None) -> bool:
    """v1 validity guard (host-side)."""
    eye = np.asarray(cam.eye, np.float32)
    if scale is not None:
        eye = eye / np.asarray(scale, np.float32)
    eye = eye + np.asarray(dims, np.float32) / 2
    return not (0.0 <= eye[axis] <= float(dims[axis]))


def slab_path_valid(cam: Camera, dims, axis: int, flipped: bool, scale=None,
                    aspect: float = 1.0, margin: float = 0.05) -> bool:
    """Host-side: can the shear-warp factorization render this camera?
    True for eyes outside the principal-axis slab range; inside the volume,
    true while every corner ray looks forward along the principal axis."""
    if eye_outside_slab_range(cam, dims, axis, scale):
        return True
    eye = np.asarray(cam.eye, np.float32)
    direction = np.asarray(cam.center, np.float32) - eye
    direction = direction / max(np.linalg.norm(direction), 1e-12)
    up = np.asarray(cam.up, np.float32)
    t2 = 2.0 * np.tan(float(cam.fovy) * np.pi / 360.0)
    h = np.cross(direction, up)
    h = t2 * aspect * h / max(np.linalg.norm(h), 1e-12)
    v = np.cross(h, direction) / max(aspect, 1e-12)
    corners = [direction + sx * h + sy * v
               for sx in (-0.5, 0.5) for sy in (-0.5, 0.5)]
    sgn = -1.0 if flipped else 1.0
    for d in corners:
        dv = d if scale is None else d / np.asarray(scale, np.float32)
        if sgn * dv[axis] <= margin * np.linalg.norm(dv):
            return False
    return True
