"""Shadow volume precomputation: directional-light transmittance
(counterpart of `instantvnr_tpu/render/shadow.py`).

Capability counterpart of the reference's `generate_shadow_map` app
(apps/shadowmap.cu:322-358) and the 2-pass MethodShadowMap renderer:

  1. permute the volume so the light's dominant axis is the layer axis;
  2. SHEAR each layer by the light's constant per-layer offset (two banded
     interpolation matrices per layer, as in slabmarch, applied as batched
     matrix products) so light rays become vertical columns;
  3. transmittance = exclusive cumulative product of (1 − α·correction)
     down the columns;
  4. un-shear each layer back.

The result S [dz, dy, dx] ∈ [0, 1] is how much directional light reaches
each voxel; the slab compositor resamples it per slab and modulates the
sample color: rgb × (ambient + (1 − ambient)·S).
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.render.slabmarch import _interp_matrix, _permute_volume
from instantvnr_torch.utils.tfn import TransferFunction, classify_controls

_PERMS = {2: (0, 1, 2), 1: (0, 2, 1), 0: (1, 2, 0)}


def light_principal_axis(light_dir) -> tuple[int, bool]:
    """(layer axis, flipped): light travels along −light_dir, and layers
    accumulate in the direction it propagates."""
    d = np.asarray(light_dir, np.float32)
    d = d / (np.linalg.norm(d) + 1e-20)
    axis = int(np.argmax(np.abs(d)))
    return axis, bool(d[axis] > 0)


def _shear_matrices(n_out: int, n_in: int, ks: torch.Tensor, step, pad):
    """Per-layer interpolation matrices [d, n_out, n_in] reading input
    coordinate (i − pad) + k·step at output i, and their coverage [d, n_out]."""
    offset = 0.5 + ks * step - pad
    m = _interp_matrix(n_out, n_in, torch.ones_like(ks), offset)
    return m, m.sum(2) > 0


@torch.no_grad()
def compute_shadow_volume(volume: torch.Tensor, tf: TransferFunction,
                          light_dir, axis: int, flipped: bool,
                          sampling_rate: float = 1.0,
                          pads: tuple = (0, 0, 0, 0)) -> torch.Tensor:
    """→ S [dz, dy, dx] float32 transmittance toward the directional light.

    light_dir points TOWARD the light (world components); axis/flipped from
    light_principal_axis. Layers march in the propagation direction, so
    layer 0 is fully lit. pads = (x_lo, x_hi, y_lo, y_hi) enlarge the
    sheared buffer laterally so that rays entering through a side face
    still accumulate occlusion (shadow_volume_for sizes them)."""
    dev = volume.device
    vol, perm = _permute_volume(volume, axis, flipped)
    d, ny, nx = vol.shape
    pxl, pxh, pyl, pyh = pads
    nxb, nyb = nx + pxl + pxh, ny + pyl + pyh

    light = torch.as_tensor(light_dir, dtype=torch.float32, device=dev)
    lp = light[list(perm)]
    if flipped:
        lp = lp * torch.tensor([1.0, 1.0, -1.0], device=dev)
    # propagation = −light_dir; per unit layer the ray shifts by s = l_xy/l_z
    sx = lp[0] / lp[2]
    sy = lp[1] / lp[2]
    step_len = torch.sqrt(sx * sx + sy * sy + 1.0)  # per-layer ray length

    ks = torch.arange(d, dtype=torch.float32, device=dev)
    # sheared buffer coord ib reads volume x = (ib − pxl) + k·sx
    mx, cov_x = _shear_matrices(nxb, nx, ks, sx, pxl)
    my, cov_y = _shear_matrices(nyb, ny, ks, sy, pyl)
    sheared = torch.matmul(torch.matmul(my, vol), mx.transpose(1, 2))
    _, alpha = classify_controls(tf, sheared)
    alpha = 1.0 - torch.pow(torch.clamp(1.0 - alpha, min=0.0),
                            sampling_rate * step_len)
    cov = cov_y[:, :, None] & cov_x[:, None, :]
    alpha = torch.where(cov, alpha, torch.zeros_like(alpha))  # outside: clear
    # exclusive cumulative transmittance down the layer axis
    trans = torch.cumprod(1.0 - alpha, dim=0)
    trans = torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)

    mx, cov_x = _shear_matrices(nx, nxb, ks, -sx, -pxl)
    my, cov_y = _shear_matrices(ny, nyb, ks, -sy, -pyl)
    out = torch.matmul(torch.matmul(my, trans), mx.transpose(1, 2))
    # with the pads sized to d·|s| every in-volume position is covered; the
    # fallback only catches under-quantized extremes (≈ fully lit)
    cov = cov_y[:, :, None] & cov_x[:, None, :]
    out = torch.where(cov, out, torch.ones_like(out))

    # un-permute back to [dz, dy, dx]
    if flipped:
        out = torch.flip(out, dims=(0,))
    if axis == 1:
        out = out.permute(1, 0, 2)
    elif axis == 0:
        out = out.permute(1, 2, 0)
    return out.contiguous()


def _quantized_pad(need: int, d: int) -> int:
    """Smallest of {0, 8, 16, 32, ...} ≥ need, capped at d, so a smoothly
    moving light meets only a handful of buffer sizes."""
    if need <= 0:
        return 0
    p = 8
    while p < need and p < d:
        p *= 2
    return min(p, d)


def shadow_volume_for(volume: torch.Tensor, tf: TransferFunction, light_dir,
                      sampling_rate: float = 1.0) -> torch.Tensor:
    """Host-side wrapper choosing the layer axis and the buffer pads."""
    axis, flipped = light_principal_axis(light_dir)
    # lateral shift bound: deep layers shear by up to d·|s| voxels (|s| ≤ 1
    # since the layer axis is the light's dominant component)
    l = np.asarray(light_dir, np.float32)
    perm = _PERMS[axis]
    lp = np.array([l[perm[0]], l[perm[1]], l[perm[2]]], np.float32)
    if flipped:
        lp[2] = -lp[2]
    sx = float(lp[0] / lp[2])
    sy = float(lp[1] / lp[2])
    d = volume.shape[0 if axis == 2 else (1 if axis == 1 else 2)]
    # buffer coord = volume coord − k·s: positive s shifts LOW, negative HIGH
    px = _quantized_pad(int(np.ceil(d * abs(sx))), d)
    py = _quantized_pad(int(np.ceil(d * abs(sy))), d)
    pads = (px if sx > 0 else 0, px if sx < 0 else 0,
            py if sy > 0 else 0, py if sy < 0 else 0)
    return compute_shadow_volume(volume, tf, light_dir, axis, flipped,
                                 sampling_rate, pads)
