"""Volumes and their normalization (counterpart of
`instantvnr_tpu/data/volume.py`).

`data` is a [dz, dy, dx] float32 tensor in [0, 1] (axis order z, y, x —
index [z, y, x] ≡ the reference's linear layout x + y·dx + z·dx·dy). Raw
files are read and normalized in numpy (the reference's StaticSampler load
path, `core/samplers/neural_sampler.cpp:176-288`: eight dtypes, a byte
swap for big-endian files, an offset), and the synthetic volumes are
generated in numpy, bit-identical to the JAX package's; then the data goes
to the requested device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from instantvnr_torch.config import VolumeDesc


@dataclass(frozen=True)
class Volume:
    data: torch.Tensor  # [dz, dy, dx] float32 in [0, 1]
    dims: tuple[int, int, int]  # (x, y, z) — reference order
    original_range: tuple[float, float]  # (min, max) in data units


def normalize_array(raw: np.ndarray,
                    value_range: tuple[float, float] | None = None
                    ) -> tuple[np.ndarray, tuple[float, float]]:
    """Normalize to [0,1] float32 (neural_sampler.cpp:244-288). An explicit
    range saturates to [0,1]; constant volumes map to all-zeros."""
    raw = np.asarray(raw)
    if value_range is None:
        vmin = float(raw.min())
        vmax = float(raw.max())
    else:
        vmin, vmax = float(value_range[0]), float(value_range[1])
    scale = 1.0 / (vmax - vmin) if vmax > vmin else 0.0
    out = ((raw.astype(np.float32) - vmin) * scale).astype(np.float32)
    if value_range is not None:
        out = np.clip(out, 0.0, 1.0)
    return out, (vmin, vmax)


def synthetic_array(dims=(64, 64, 64), kind: str = "vorts",
                    seed: int = 0) -> tuple[np.ndarray, tuple[float, float]]:
    """The procedural test volumes as normalized numpy ([dz, dy, dx], range).

    'vorts' superposes rotating Gaussian tubes (empty space plus sharp
    features); 'sphere' is a radial falloff; 'noise' is smoothed noise;
    the analytic fields of data/procedural.py ('tubes', 'wavelet', 'xyz',
    'marschner-lobb') are sampled at the decode lattice."""
    dx, dy, dz = dims
    z, y, x = np.meshgrid(
        np.linspace(-1, 1, dz), np.linspace(-1, 1, dy), np.linspace(-1, 1, dx),
        indexing="ij",
    )
    if kind == "sphere":
        r = np.sqrt(x * x + y * y + z * z)
        data = np.clip(1.0 - r, 0.0, 1.0) ** 2
    elif kind == "noise":
        rng = np.random.default_rng(seed)
        data = rng.random((dz, dy, dx)).astype(np.float32)
        for axis in range(3):
            data = 0.5 * data + 0.25 * (
                np.roll(data, 1, axis) + np.roll(data, -1, axis))
    elif kind == "vorts":
        data = np.zeros_like(x)
        rng = np.random.default_rng(seed + 7)
        for _ in range(6):
            cx, cy, cz = rng.uniform(-0.5, 0.5, 3)
            ax, ay, az = rng.normal(size=3)
            n = np.sqrt(ax * ax + ay * ay + az * az) + 1e-9
            ax, ay, az = ax / n, ay / n, az / n
            px, py, pz = x - cx, y - cy, z - cz
            dot = px * ax + py * ay + pz * az
            qx, qy, qz = px - dot * ax, py - dot * ay, pz - dot * az
            d2 = qx * qx + qy * qy + qz * qz
            sigma = rng.uniform(0.05, 0.15)
            data += np.exp(-d2 / (2 * sigma * sigma)) * (
                0.75 + 0.25 * np.cos(8.0 * dot))
        data = np.clip(data, 0, None)
    else:
        # the analytic fields (data/procedural.py) at the decode lattice,
        # left unstretched: [0, 1] by contract, so the grid equals the
        # field and the PSNR oracles agree
        from instantvnr_torch.data.procedural import FIELDS, AnalyticSampler

        if kind not in FIELDS:
            raise ValueError(f"unknown synthetic volume kind: {kind}")
        grid = AnalyticSampler.create(kind, seed).lattice_grid(dims,
                                                               device="cpu")
        return grid.numpy(), (0.0, 1.0)
    return normalize_array(data.astype(np.float32))


def synthetic_volume(dims=(64, 64, 64), kind: str = "vorts", seed: int = 0,
                     device="cuda") -> Volume:
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    data, rng = synthetic_array(dims, kind, seed)
    return Volume(data=torch.as_tensor(data, device=dev),
                  dims=tuple(int(d) for d in dims), original_range=rng)


def load_volume(desc: VolumeDesc, device="cuda") -> Volume:
    """A raw volume file per its descriptor, normalized by the scene's
    `desc.value_range` when it has one, else by the data's own min and max
    (StaticSampler::load), then placed on `device`."""
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dx, dy, dz = desc.dims
    raw = np.fromfile(desc.filename, dtype=desc.np_dtype, count=desc.n_voxels,
                      offset=desc.offset)
    if raw.size != desc.n_voxels:
        raise ValueError(
            f"{desc.filename}: expected {desc.n_voxels} voxels, got {raw.size}")
    data, rng = normalize_array(raw.reshape(dz, dy, dx), desc.value_range)
    return Volume(data=torch.as_tensor(data, device=dev), dims=desc.dims,
                  original_range=rng)


def save_raw(volume_data, path: str) -> None:
    """Dump a [dz, dy, dx] float32 volume to a raw file (the reference's
    save_inference_volume / save_reference_volume, network.cu:328-408)."""
    if isinstance(volume_data, torch.Tensor):
        volume_data = volume_data.detach().cpu().numpy()
    np.asarray(volume_data, dtype=np.float32).tofile(path)
