"""Analytic training sources (counterpart of
`instantvnr_tpu/data/procedural.py`; the reference's OpenVKLSampler modes,
`core/samplers/neural_sampler.cpp:714-958`).

A field is a function f: [0,1]³ → [0,1] over [..., 3] float32 coords, so
training draws a batch and evaluates the field on the batch's device: no
volume exists, in core or out. `AnalyticSampler` holds the field's name
and its static parameters; `downsample_volume` is the reference's
downsampled-grid source as a plain Volume transform.

Torch's generators cannot draw threefry's numbers, so `sample` takes an
explicit `torch.Generator` and the packages are compared through
`evaluate` on the same coords.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from instantvnr_torch.utils.device import device_constant


def _field_sphere(p, params):
    # radial falloff about the centre, like the 'sphere' grid synthetic
    q = p * 2.0 - 1.0
    r = torch.sqrt(torch.sum(q * q, dim=-1))
    return torch.clamp(1.0 - r, 0.0, 1.0) ** 2


def _field_xyz(p, params):
    # openvkl's XYZProceduralVolume: the product of the coordinates
    return p[..., 0] * p[..., 1] * p[..., 2]


def _field_wavelet(p, params):
    # openvkl's WaveletProceduralVolume: axis sines remapped to [0, 1]
    # (the reference instantiates WaveletVdbVolumeFloat,
    # neural_sampler.cpp:732)
    q = p * 2.0 - 1.0
    xf, yf, zf = 12.0, 10.0, 8.0
    s = (torch.sin(xf * q[..., 0]) * 0.4 + torch.sin(yf * q[..., 1]) * 0.35
         + torch.cos(zf * q[..., 2]) * 0.25)
    return 0.5 + 0.5 * s


def _field_marschner_lobb(p, params):
    # Marschner & Lobb '94 resampling test signal on [-1,1]³, fM = 6,
    # alpha = 0.25
    q = p * 2.0 - 1.0
    alpha, fm = 0.25, 6.0
    r = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)
    rho_r = torch.cos(2.0 * math.pi * fm * torch.cos(math.pi * r / 2.0))
    v = (1.0 - torch.sin(math.pi * q[..., 2] / 2.0) + alpha * (1.0 + rho_r))
    return v / (2.0 * (1.0 + alpha))


def _field_tubes(p, params):
    # the analytic 'vorts': superposed rotating Gaussian tubes,
    # params = ((cx, cy, cz, ax, ay, az, sigma), ...)
    q = p * 2.0 - 1.0
    acc = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    for (cx, cy, cz, ax, ay, az, sigma) in params:
        # made once per process: a copy from the host each step would make
        # the host wait for the card
        c = device_constant((cx, cy, cz), torch.float32, q.device)
        a = device_constant((ax, ay, az), torch.float32, q.device)
        d = q - c
        dot = torch.sum(d * a, dim=-1)
        perp = d - dot[..., None] * a
        d2 = torch.sum(perp * perp, dim=-1)
        acc = acc + torch.exp(-d2 / (2.0 * sigma * sigma)) * (
            0.75 + 0.25 * torch.cos(8.0 * dot))
    return torch.clamp(acc, 0.0, 1.0)


def _tube_params(seed: int = 0, n: int = 6) -> tuple:
    rng = np.random.default_rng(seed + 7)
    out = []
    for _ in range(n):
        cx, cy, cz = rng.uniform(-0.5, 0.5, 3)
        a = rng.normal(size=3)
        a = a / (np.linalg.norm(a) + 1e-9)
        sigma = rng.uniform(0.05, 0.15)
        out.append((float(cx), float(cy), float(cz),
                    float(a[0]), float(a[1]), float(a[2]), float(sigma)))
    return tuple(out)


FIELDS = {
    "sphere": _field_sphere,
    "xyz": _field_xyz,
    "wavelet": _field_wavelet,
    "marschner-lobb": _field_marschner_lobb,
    "tubes": _field_tubes,
}


def field_names() -> tuple:
    return tuple(sorted(FIELDS))


@dataclass(frozen=True)
class AnalyticSampler:
    """A sampler over an analytic field, with StaticSampler's surface:
    `sample(generator, batch, lower, upper)` and `sample_grid(origin,
    grid_dims, spacing)`; the values come from the field, not a texture."""

    kind: str = "wavelet"
    params: tuple = ()  # static field parameters (the tube list)

    @classmethod
    def create(cls, kind: str, seed: int = 0) -> "AnalyticSampler":
        if kind == "tubes":
            return cls(kind=kind, params=_tube_params(seed))
        if kind not in FIELDS:
            raise ValueError(
                f"unknown analytic field {kind!r}; have {field_names()}")
        return cls(kind=kind)

    def evaluate(self, coords: torch.Tensor) -> torch.Tensor:
        """Field values at [..., 3] coords in [0,1]³, on their device."""
        return FIELDS[self.kind](coords, self.params).to(torch.float32)

    def sample(self, generator: torch.Generator, batch: int,
               lower=(0.0, 0.0, 0.0), upper=(1.0, 1.0, 1.0)):
        """B uniform coords in [lower, upper) on the generator's device and
        the field there: (coords [B, 3], values [B, 1])."""
        dev = generator.device
        lo = device_constant(tuple(float(v) for v in lower), torch.float32,
                             dev)
        hi = device_constant(tuple(float(v) for v in upper), torch.float32,
                             dev)
        u = torch.rand((batch, 3), generator=generator, dtype=torch.float32,
                       device=dev)
        coords = lo + u * (hi - lo)
        return coords, self.evaluate(coords)[:, None]

    def sample_grid(self, origin, grid_dims, spacing, device="cuda"):
        """A regular sub-grid's cell-centred coords (data/sampler.py::
        grid_coords) and the field there."""
        from instantvnr_torch.data.sampler import grid_coords
        from instantvnr_torch.utils.device import resolve_device

        coords = grid_coords(origin, grid_dims, spacing,
                             device=resolve_device(device))
        return coords, self.evaluate(coords)[:, None]

    def lattice_grid(self, dims, device="cuda") -> torch.Tensor:
        """[dz, dy, dx] field values at the decode lattice ((i + 0.5)/N):
        the PSNR and SSIM ground truth of training without a ground-truth
        volume (the reference compares against vklComputeSample on the
        same grid coords)."""
        from instantvnr_torch.utils.device import resolve_device

        dev = resolve_device(device)
        dx, dy, dz = (int(d) for d in dims)
        f32 = torch.float32
        z, y, x = torch.meshgrid(
            (torch.arange(dz, dtype=f32, device=dev) + 0.5) / dz,
            (torch.arange(dy, dtype=f32, device=dev) + 0.5) / dy,
            (torch.arange(dx, dtype=f32, device=dev) + 0.5) / dx,
            indexing="ij")
        return self.evaluate(torch.stack([x, y, z], dim=-1))


def downsample_volume(vol, factor: int):
    """The mean-pooled grid (the reference's downsampled-grid OpenVKL
    source, OpenVKLSampler(filename, dims, downsample)) as a Volume on the
    input's device; pooled in numpy, bit for bit the JAX package's."""
    from instantvnr_torch.data.volume import Volume

    src = vol.data if hasattr(vol, "data") else vol
    dev = src.device if isinstance(src, torch.Tensor) else torch.device("cpu")
    data = (src.detach().cpu().numpy() if isinstance(src, torch.Tensor)
            else np.asarray(src))
    f = int(factor)
    dz, dy, dx = data.shape
    cz, cy, cx = dz // f * f, dy // f * f, dx // f * f
    pooled = data[:cz, :cy, :cx].reshape(
        cz // f, f, cy // f, f, cx // f, f).mean(axis=(1, 3, 5))
    return Volume(data=torch.as_tensor(pooled.astype(np.float32), device=dev),
                  dims=(cx // f, cy // f, cz // f),
                  original_range=getattr(vol, "original_range", (0.0, 1.0)))
