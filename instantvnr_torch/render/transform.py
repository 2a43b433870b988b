"""Volume clipping box + anisotropic scaling (reference `api.h:146-147`;
counterpart of `instantvnr_tpu/render/transform.py`).

world = (voxel − dims/2) · scale; clip bounds are VOXEL coordinates in
[0, dims] (the reference's user-facing convention, api.cpp:332-333).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VolumeTransform(NamedTuple):
    scale: torch.Tensor  # [3] anisotropic voxel→world scaling
    clip_lower: torch.Tensor  # [3] voxel coords
    clip_upper: torch.Tensor  # [3] voxel coords


def default_transform(dims, device="cuda") -> VolumeTransform:
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    d = torch.as_tensor([float(v) for v in dims], dtype=torch.float32,
                        device=dev)
    return VolumeTransform(
        scale=torch.ones(3, dtype=torch.float32, device=dev),
        clip_lower=torch.zeros(3, dtype=torch.float32, device=dev),
        clip_upper=d,
    )


def rays_to_voxel(xform: VolumeTransform, dims, org_w, dir_w):
    """World rays → voxel-space rays. dir_w is normalized; the returned
    direction is not (|dir_v| = |S⁻¹·dir_w|), so `t` along the voxel-space
    ray measures WORLD distance, as the reference marches the transformed,
    unnormalized direction (method_raymarching.cu:520-521)."""
    d = torch.as_tensor(dims, dtype=torch.float32, device=org_w.device)
    return org_w / xform.scale + 0.5 * d, dir_w / xform.scale


def clip_bounds(xform: VolumeTransform, dims):
    """Clip box intersected with the volume box, in voxel coords."""
    d = torch.as_tensor(dims, dtype=torch.float32, device=xform.scale.device)
    lo = torch.clamp(xform.clip_lower, torch.zeros_like(d), d)
    hi = torch.clamp(xform.clip_upper, torch.zeros_like(d), d)
    return lo, torch.maximum(hi, lo)
