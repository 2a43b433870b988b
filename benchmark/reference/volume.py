"""The benchmark's volume: a vorts-like field of rotating Gaussian tubes
made on the device from the seed, and its trilinear sample.

The tubes' parameters come from the seed; every seed gives the same
number of tubes and the same dims, so every seed makes the same amount of
work. The field is made in slabs of z so that a 512³ volume never holds
more than one slab's temporaries.
"""
from __future__ import annotations

import numpy as np
import torch

N_TUBES = 6


def tube_params(seed: int) -> np.ndarray:
    """[N_TUBES, 8]: centre (3), unit axis (3), width, phase."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x766F7274])
    out = np.zeros((N_TUBES, 8), np.float64)
    for i in range(N_TUBES):
        c = rng.uniform(-0.5, 0.5, 3)
        a = rng.normal(size=3)
        a /= np.linalg.norm(a) + 1e-9
        out[i] = [*c, *a, rng.uniform(0.05, 0.15), rng.uniform(0, np.pi)]
    return out


@torch.no_grad()
def vorts(dims, seed: int, device, slab: int = 32) -> torch.Tensor:
    """[dz, dy, dx] float32 in [0, 1] on `device` (dims = (x, y, z))."""
    dx, dy, dz = (int(d) for d in dims)
    f32 = torch.float32
    xs = torch.linspace(-1, 1, dx, dtype=f32, device=device)
    ys = torch.linspace(-1, 1, dy, dtype=f32, device=device)
    zs = torch.linspace(-1, 1, dz, dtype=f32, device=device)
    out = torch.empty((dz, dy, dx), dtype=f32, device=device)
    tubes = tube_params(seed)
    for z0 in range(0, dz, slab):
        z = zs[z0:z0 + slab][:, None, None]
        y = ys[None, :, None]
        x = xs[None, None, :]
        acc = torch.zeros((z.shape[0], dy, dx), dtype=f32, device=device)
        for cx, cy, cz, ax, ay, az, sigma, phase in tubes:
            px, py, pz = x - cx, y - cy, z - cz
            dot = px * ax + py * ay + pz * az
            qx, qy, qz = px - dot * ax, py - dot * ay, pz - dot * az
            d2 = qx * qx + qy * qy + qz * qz
            acc += torch.exp(d2 * (-0.5 / (sigma * sigma))) * (
                0.75 + 0.25 * torch.cos(8.0 * dot + phase))
        out[z0:z0 + slab] = acc
    out.clamp_(min=0.0)
    lo, hi = out.min(), out.max()
    return (out - lo) / torch.clamp(hi - lo, min=1e-30)


def sample_voxel(vol: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Trilinear sample at continuous voxel coordinates [..., 3] (voxel
    i's centre at i + 0.5), clamped at the border, as CUDA's tex3D."""
    dz, dy, dx = vol.shape
    dev = vol.device
    top = torch.tensor((dx - 1.0, dy - 1.0, dz - 1.0), device=dev)
    x = torch.minimum(torch.clamp(xyz - 0.5, min=0.0), top)
    i0f = torch.floor(x)
    f = x - i0f
    i0 = i0f.to(torch.int64)
    i1 = torch.minimum(i0 + 1, torch.tensor((dx - 1, dy - 1, dz - 1),
                                            device=dev))
    flat = vol.reshape(-1)

    def at(ix, iy, iz):
        return flat[(iz * dy + iy) * dx + ix]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    c00 = at(x0, y0, z0) * (1 - fx) + at(x1, y0, z0) * fx
    c10 = at(x0, y1, z0) * (1 - fx) + at(x1, y1, z0) * fx
    c01 = at(x0, y0, z1) * (1 - fx) + at(x1, y0, z1) * fx
    c11 = at(x0, y1, z1) * (1 - fx) + at(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def sample_tex(vol: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sample at texture coordinates p in [0,1]³ (texel i's centre at
    (i + 0.5)/N): what a training batch's ground truth is."""
    dz, dy, dx = vol.shape
    scale = torch.tensor((float(dx), float(dy), float(dz)), device=vol.device)
    return sample_voxel(vol, p * scale)
