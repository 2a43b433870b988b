"""Training-data samplers (reference `core/samplers/*`; counterpart of
`instantvnr_tpu/data/sampler.py`).

`StaticSampler` is the in-core sampler: a batch is B uniform-random
coordinates in [0,1]³ (optionally a sub-box) paired with the ground truth
fetched by a trilinear texture lookup (`StaticSampler::sample`,
neural_sampler.cu:130-164), all on the volume's device.

Randomness comes from an explicit `torch.Generator` on that device. The
reference seeds its sampler with 1337 (neural_sampler.cu:36). Torch's
generators cannot reproduce JAX's threefry bits, so the packages are
compared on fixed coordinates, never on a seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from instantvnr_torch.data.volume import Volume
from instantvnr_torch.ops.trilinear import sample_volume_tex
from instantvnr_torch.utils.device import device_constant

DEFAULT_SEED = 1337  # reference neural_sampler.cu:36


@dataclass(frozen=True)
class StaticSampler:
    """In-core sampler over a normalized volume."""

    volume: Volume

    def sample(self, generator: torch.Generator, batch: int,
               lower=(0.0, 0.0, 0.0), upper=(1.0, 1.0, 1.0)):
        """(coords [B,3] in [0,1]³, values [B,1])."""
        return sample_static(self.volume.data, generator, batch, lower, upper)


def sample_static(vol: torch.Tensor, generator: torch.Generator, batch: int,
                  lower=(0.0, 0.0, 0.0), upper=(1.0, 1.0, 1.0)):
    """B uniform coords in the box [lower, upper) and their trilinear
    values: (coords [B,3], values [B,1])."""
    coords = torch.rand((batch, 3), generator=generator, dtype=torch.float32,
                        device=vol.device)
    lo = np.asarray(lower, np.float32)
    extent = np.asarray(upper, np.float32) - lo
    if lo.any() or (extent != 1).any():  # lower + u·(upper − lower)
        coords = (device_constant(tuple(lo.tolist()), torch.float32,
                                  vol.device)
                  + coords * device_constant(tuple(extent.tolist()),
                                             torch.float32, vol.device))
    return coords, sample_volume_tex(vol, coords)[:, None]


def grid_coords(origin, grid_dims, spacing, device="cpu") -> torch.Tensor:
    """Normalized coords of a regular sub-grid, cell-centred like the
    reference's generate_grid_coords (voxel centre (i + 0.5)·spacing),
    x fastest → [gz·gy·gx, 3]."""
    gx, gy, gz = (int(d) for d in grid_dims)
    f32 = torch.float32
    origin = torch.as_tensor(origin, dtype=f32, device=device)
    spacing = torch.as_tensor(spacing, dtype=f32, device=device)
    z, y, x = torch.meshgrid(torch.arange(gz, dtype=f32, device=device),
                             torch.arange(gy, dtype=f32, device=device),
                             torch.arange(gx, dtype=f32, device=device),
                             indexing="ij")
    grid = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    return (origin + (grid + 0.5)) * spacing
