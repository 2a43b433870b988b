"""Trilinear volume sampling, the counterpart of CUDA `tex3D` (and of
`instantvnr_tpu/ops/trilinear.py`).

The reference samples with hardware trilinear filtering
(`raytracing.h:105-110`): voxel i's centre sits at (i + 0.5)/N, addressing
clamps at the border. Coordinates are in [0,1]³ object space, the volume is
[dz, dy, dx] float32. Indices are int64, so volumes of more than 2^31
voxels need no split gather. The 8 corners are gathered at once and blended
x, then y, then z, with the reference's lerp a·(1 − f) + b·f.
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.utils.device import device_constant

# the 8 corner offsets of a cell, x fastest
_CORNERS = tuple((c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8))


def _const(vol: torch.Tensor, values, dtype=torch.float32) -> torch.Tensor:
    return device_constant(tuple(values), dtype, vol.device)


def _lerp_pairs(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Blend even with odd entries of the last axis: v[2i]·(1−f) + v[2i+1]·f."""
    f = f[..., None]
    return v[..., 0::2] * (1 - f) + v[..., 1::2] * f


def sample_volume_voxel(vol: torch.Tensor,
                        xyz_voxel: torch.Tensor) -> torch.Tensor:
    """Trilinear sample at continuous voxel coordinates [..., 3] (texel
    space: voxel i's centre at i + 0.5), clamp addressing."""
    dz, dy, dx = vol.shape
    top = _const(vol, (dx - 1.0, dy - 1.0, dz - 1.0))
    x = torch.minimum(torch.clamp(xyz_voxel - 0.5, min=0.0), top)
    i0f = torch.floor(x)
    frac = x - i0f
    i0 = i0f.to(torch.int64)
    i1 = torch.minimum(i0 + 1, _const(vol, (dx - 1, dy - 1, dz - 1),
                                      torch.int64))
    strides = _const(vol, (1, dx, dx * dy), torch.int64)
    base = (i0 * strides).sum(-1, keepdim=True)
    step = (i1 - i0) * strides  # [..., 3]: 0 where the clamp held i1 = i0
    corners = _const(vol, _CORNERS, torch.int64)  # [8, 3]
    idx = base + (step[..., None, :] * corners).sum(-1)  # [..., 8]
    v = vol.reshape(-1)[idx]
    v = _lerp_pairs(v, frac[..., 0])  # [c00, c10, c01, c11]
    v = _lerp_pairs(v, frac[..., 1])  # [c0, c1]
    return _lerp_pairs(v, frac[..., 2])[..., 0]


def sample_volume(vol: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sample at normalized [0,1]³ coordinates with the reference's
    cell-centred remap p' = p(1 − 1/N) + 0.5/N (`raytracing.h:105-110`)."""
    dz, dy, dx = vol.shape
    r = [np.float32(1.0) / np.float32(d) for d in (dx, dy, dz)]
    scale = _const(vol, (float(np.float32(1.0) - v) for v in r))
    shift = _const(vol, (float(np.float32(0.5) * v) for v in r))
    dims = _const(vol, (float(dx), float(dy), float(dz)))
    return sample_volume_voxel(vol, (p * scale + shift) * dims)


def sample_volume_tex(vol: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sample at direct texture coordinates (texel i's centre at
    (i + 0.5)/N), with no remap: what the training sampler reads
    (`neural_sampler.cu:151-155`)."""
    dz, dy, dx = vol.shape
    return sample_volume_voxel(vol, p * _const(vol, (float(dx), float(dy),
                                                      float(dz))))


def sample_gradient(vol: torch.Tensor, p: torch.Tensor, v: torch.Tensor,
                    step) -> torch.Tensor:
    """Forward-difference gradient [..., 3] with the boundary flip of
    `raytracing.h:112-130`: where p + step leaves [0,1] on an axis the step
    is negated there. `v` is the value at p."""
    eps = 1.19209e-07
    stp = torch.broadcast_to(torch.as_tensor(step, dtype=torch.float32,
                                             device=p.device), p.shape)
    stp = torch.where(p + stp > 1.0 - eps, -stp, stp)
    out = []
    for axis in range(3):
        d = torch.zeros_like(stp)
        d[..., axis] = stp[..., axis]
        out.append(sample_volume(vol, p + d) - v)
    return torch.stack(out, dim=-1) / stp
