"""Quality metrics and volume decoding (counterpart of
`instantvnr_tpu/models/metrics.py`).

- PSNR: 10·log10(range²/mse), range = (max − min) of the ground truth
  (`network.cu:410-472`).
- SSIM: uniform 7³ window, sample covariance (N/(N−1)), K1 = 0.01,
  K2 = 0.03, data range 1, mean over the windows inside the grid
  (`network.cu:474-549`).
- decode_volume evaluates the network on the full voxel grid in z-slabs of
  16 slices, the reference's progressive "blob" granularity
  (`network.cu:171,290-326`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from instantvnr_torch.models.network import (NeuralField, network_apply,
                                             render_params)


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


def psnr_vs(field: NeuralField, params, gt: torch.Tensor) -> torch.Tensor:
    """PSNR of the decoded network against a ground-truth [dz, dy, dx]
    volume."""
    dims = (gt.shape[2], gt.shape[1], gt.shape[0])
    return psnr_arrays(decode_volume(field, render_params(params, field),
                                     dims), gt)


def psnr(field: NeuralField, params, gt: torch.Tensor) -> float:
    """`psnr_vs` as a host float."""
    return float(psnr_vs(field, params, gt))


def _uniform_filter3(x: torch.Tensor, win: int) -> torch.Tensor:
    """3-D mean filter over win³ windows (valid), one axis at a time."""
    x = x[None, None]
    for kernel in ((win, 1, 1), (1, win, 1), (1, 1, win)):
        x = F.avg_pool3d(x, kernel, stride=1)
    return x[0, 0]


def ssim_arrays(pred: torch.Tensor, gt: torch.Tensor, win: int = 7,
                data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM with the reference kernel's semantics
    (`network.cu:70-129`)."""
    x = gt.to(torch.float32)
    y = pred.to(torch.float32)
    n = win ** 3
    cov_norm = n / (n - 1.0)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ux = _uniform_filter3(x, win)
    uy = _uniform_filter3(y, win)
    uxx = _uniform_filter3(x * x, win)
    uyy = _uniform_filter3(y * y, win)
    uxy = _uniform_filter3(x * y, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return torch.mean((a1 * a2) / (b1 * b2))


def mssim(field: NeuralField, params, gt: torch.Tensor) -> float:
    dims = (gt.shape[2], gt.shape[1], gt.shape[0])
    return float(ssim_arrays(decode_volume(
        field, render_params(params, field), dims), gt))
