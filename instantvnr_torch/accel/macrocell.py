"""Macro-cell acceleration grid (reference `core/macrocell.{h,cu}`;
counterpart of `instantvnr_tpu/accel/macrocell.py`).

Per-cell (min, max) of the volume plus a per-cell max opacity derived from
the transfer function; the slab renderer uses the max opacity to skip empty
slabs. Cell size = 2^MACROCELL_SIZE_MIP voxels (16³).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from instantvnr_torch.config import MACROCELL_SIZE_MIP
from instantvnr_torch.utils.tfn import TransferFunction, max_alpha_in_range

MACROCELL_SIZE = 1 << MACROCELL_SIZE_MIP

# empty-initialized range: lo=+2, hi=-2 (any real update shrinks into [0,1])
_EMPTY_LO = 2.0
_EMPTY_HI = -2.0


@dataclass(frozen=True)
class MacroCell:
    """Per-cell tensors, all shaped [mz, my, mx]."""

    value_lo: torch.Tensor
    value_hi: torch.Tensor
    max_opacity: torch.Tensor
    volume_dims: tuple[int, int, int]  # (x, y, z)

    @property
    def dims(self) -> tuple[int, int, int]:
        """(mx, my, mz)"""
        mz, my, mx = self.value_lo.shape
        return (mx, my, mz)

    @property
    def spacings(self) -> tuple[float, float, float]:
        """Cell size in normalized [0,1] coords (MacroCell::set_shape)."""
        dx, dy, dz = self.volume_dims
        return (MACROCELL_SIZE / dx, MACROCELL_SIZE / dy, MACROCELL_SIZE / dz)


def macrocell_dims(volume_dims) -> tuple[int, int, int]:
    """(mx, my, mz) = ceil(dims / 16) (MacroCell::set_shape)."""
    dx, dy, dz = volume_dims
    c = MACROCELL_SIZE
    return (-(-dx // c), -(-dy // c), -(-dz // c))


def allocate(volume_dims, device="cuda") -> MacroCell:
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    mx, my, mz = macrocell_dims(volume_dims)
    shape = (mz, my, mx)
    return MacroCell(
        value_lo=torch.full(shape, _EMPTY_LO, dtype=torch.float32, device=dev),
        value_hi=torch.full(shape, _EMPTY_HI, dtype=torch.float32, device=dev),
        max_opacity=torch.zeros(shape, dtype=torch.float32, device=dev),
        volume_dims=tuple(int(d) for d in volume_dims),
    )


def compute_value_ranges(mc: MacroCell, volume: torch.Tensor) -> MacroCell:
    """Offline full sweep: per-cell min/max over the window
    [c·W−1, c·W+W+1) per axis — an 18³ window at stride 16, padded with
    ∓inf so the padding never wins (the JAX package's reduce_window)."""
    w = MACROCELL_SIZE
    mz, my, mx = mc.value_lo.shape
    dz, dy, dx = volume.shape
    pad_hi = [max((m - 1) * w - 1 + (w + 2) - d, 0)
              for m, d in ((mx, dx), (my, dy), (mz, dz))]
    # F.pad orders (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi)
    pads = (1, pad_hi[0], 1, pad_hi[1], 1, pad_hi[2])
    v = volume.to(torch.float32)[None, None]
    hi = F.max_pool3d(F.pad(v, pads, value=-float("inf")), w + 2, stride=w)
    lo = -F.max_pool3d(F.pad(-v, pads, value=-float("inf")), w + 2, stride=w)
    return MacroCell(value_lo=lo[0, 0].contiguous(),
                     value_hi=hi[0, 0].contiguous(),
                     max_opacity=mc.max_opacity, volume_dims=mc.volume_dims)


def update_max_opacity(mc: MacroCell, tf: TransferFunction) -> MacroCell:
    """Per-cell max opacity over the cell's value range
    (macrocell_max_opacity_kernel, macrocell.cu:153-193). Cells never
    touched keep opacity 0."""
    touched = mc.value_hi >= mc.value_lo
    opacity = max_alpha_in_range(tf, mc.value_lo, mc.value_hi)
    return MacroCell(value_lo=mc.value_lo, value_hi=mc.value_hi,
                     max_opacity=torch.where(touched, opacity,
                                             torch.zeros_like(opacity)),
                     volume_dims=mc.volume_dims)


def build(volume: torch.Tensor, volume_dims,
          tf: TransferFunction | None = None) -> MacroCell:
    """allocate + full sweep + (optional) max opacity, on the volume's
    device."""
    mc = compute_value_ranges(allocate(volume_dims, volume.device), volume)
    if tf is not None:
        mc = update_max_opacity(mc, tf)
    return mc
