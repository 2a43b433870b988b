"""Volume decoding and PSNR (counterpart of `instantvnr_tpu/models/metrics.py`).

decode_volume evaluates the network on the full voxel grid in z-slabs of 16
slices, the reference's progressive "blob" granularity
(`network.cu:171,290-326`).
"""
from __future__ import annotations

import torch

from instantvnr_torch.models.network import NeuralField, network_apply


def _grid_coords_slab(dims, z0: int, slab: int, device) -> torch.Tensor:
    """Texel-centre coords ((i+0.5)/N) for a z-slab of the grid → [n, 3]."""
    dx, dy, dz = dims
    f32 = torch.float32
    z, y, x = torch.meshgrid(
        (z0 + torch.arange(slab, dtype=f32, device=device) + 0.5) / dz,
        (torch.arange(dy, dtype=f32, device=device) + 0.5) / dy,
        (torch.arange(dx, dtype=f32, device=device) + 0.5) / dx,
        indexing="ij",
    )
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


@torch.no_grad()
def decode_slab(field: NeuralField, params, z0: int, dims,
                slab: int = 16) -> torch.Tensor:
    """One blob of progressive decoding (`infer_progressively_decode_volume`,
    network.cu:290-326): [slab, dy, dx] starting at z-slice z0."""
    dx, dy, _ = dims
    coords = _grid_coords_slab(dims, int(z0), slab, params["table"].device)
    return network_apply(params, coords, field).reshape(slab, dy, dx)


@torch.no_grad()
def decode_volume(field: NeuralField, params, dims,
                  slab: int = 16) -> torch.Tensor:
    """The network over the full grid → [dz, dy, dx] float32. A last blob
    that overhangs dz decodes past the grid and is trimmed."""
    dz = dims[2]
    slab = min(slab, dz)
    blobs = [decode_slab(field, params, z0, dims, slab)
             for z0 in range(0, dz, slab)]
    return torch.cat(blobs, dim=0)[:dz]


def psnr_arrays(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    err = (pred.to(torch.float32) - gt.to(torch.float32)) ** 2
    mse = torch.mean(err)
    rng = torch.max(gt) - torch.min(gt)
    return 10.0 * torch.log10(rng * rng / torch.clamp(mse, min=1e-20))
