"""Slab-sharded rendering: the slab compositor over ranks (counterpart of
`instantvnr_tpu/parallel/slab.py`).

The slab compositor (render/slabmarch.py) is a front-to-back `over` fold of
per-slab premultiplied RGBA layers, and `over` is associative, so the fold
splits across ranks: the volume is split over its (permuted) slab axis,
every rank resamples, classifies and composites ITS contiguous chunk of
slabs into one premultiplied [4, hi, wi] partial (`composite_slabs`, or
`composite_slabs_ext` with a shadow volume: the kernels on the card), and
one all_gather brings the n partials to every rank, which combines them
front to back and warps the result to the screen. A rank holds only its
chunk of the volume: from a host numpy volume each rank copies only its own
slabs to its device, so the volume's memory scales with the ranks.

The per-slab state comes from the volume's dims alone
(`slabmarch.slab_frame_state`); a chunk takes its rows of it, which carry
their slab index, so no z offset is threaded through. A chunk's early
termination starts afresh at its first slab: the combined frame differs
from the single-device one only by contributions past opacity 0.9999.
Value rendering, with or without a shadow volume; gradient shading is the
single-device path's, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.ops.slab_composite import (composite_slabs,
                                                 composite_slabs_ext,
                                                 pack_controls, pack_lut)
from instantvnr_torch.parallel.mesh import Mesh, all_gather
from instantvnr_torch.render.slabmarch import (SlabSettings, _final_warp,
                                               _AXIS_ORDER, _permute_volume,
                                               permuted_dims, slab_frame_state)


def _permute_host(volume: np.ndarray, axis: int, flipped: bool):
    """Host-memory mirror of slabmarch._permute_volume (the same table);
    numpy transposes and flips are views, so nothing is copied here."""
    order, perm = _AXIS_ORDER[axis]
    vol = np.transpose(volume, order)
    if flipped:
        vol = vol[::-1]
    return vol, perm


def _chunk(mesh: Mesh, d: int) -> slice:
    n = mesh.shape["data"]
    if d % n:
        raise ValueError(f"slab count {d} not divisible by the data axis "
                         f"({n})")
    k = d // n
    i = mesh.axis_index("data")
    return slice(i * k, (i + 1) * k)


def shard_volume_slabs(volume, mesh: Mesh, axis: int, flipped: bool):
    """This rank's chunk of a [dz, dy, dx] volume permuted to its slab axis
    → (chunk [D/n, ay, ax] float32 on the rank's device, perm).

    Pass a HOST (numpy) array for a volume that does not fit one device:
    each rank then copies only its own slabs from host memory. A tensor is
    permuted where it lies and its chunk taken from there."""
    if isinstance(volume, np.ndarray):
        vol, perm = _permute_host(volume, axis, flipped)
        part = np.ascontiguousarray(vol[_chunk(mesh, vol.shape[0])],
                                    dtype=np.float32)
        return torch.from_numpy(part).to(mesh.device), perm
    vol, perm = _permute_volume(volume, axis, flipped)
    part = vol[_chunk(mesh, vol.shape[0])]
    return part.to(device=mesh.device, dtype=torch.float32).contiguous(), perm


def make_sharded_slab_render(mesh: Mesh, width: int, height: int,
                             settings: SlabSettings, axis: int,
                             flipped: bool, dims_zyx):
    """The slab-sharded frame for one principal axis of a [dz, dy, dx]
    volume → fn(vol_chunk, tf, cam_arrays, slab_occupancy [D] bool, xform,
    shadow_chunk=None) → rgba [H·W, 4] on every rank. vol_chunk and
    shadow_chunk are this rank's chunks (`shard_volume_slabs`); the data
    axis must divide d_slab, the frame's slab count (the JAX package takes
    d_slab here; the port takes the dims it derives d_slab from)."""
    dims_zyx = tuple(int(d) for d in dims_zyx)
    d_slab = permuted_dims(dims_zyx, axis)[0]
    n = mesh.shape["data"]
    if d_slab % n != 0:
        raise ValueError(f"data axis size {n} must divide d_slab {d_slab}")
    if settings.shading != "none":
        raise ValueError("the slab-sharded frame renders values: gradient "
                         "shading is the single-device path's")
    k = d_slab // n
    rows = _chunk(mesh, d_slab)

    @torch.no_grad()
    def frame(vol_chunk, tf, cam_arrays, slab_occupancy, xform,
              shadow_chunk=None):
        kc = vol_chunk.shape[0]
        # a chunk of another slab count must fail loudly, not composite
        # with shifted geometry
        if kc != k:
            raise ValueError(f"a chunk of {kc} slabs, expected {k} "
                             f"(d_slab {d_slab} over {n} ranks)")
        ext = shadow_chunk is not None
        st = slab_frame_state(dims_zyx, vol_chunk.device,
                              cam_arrays, width, height, settings, axis,
                              flipped, slab_occupancy, xform, ext=ext)
        c = st.slabs(rows.start, rows.stop)
        if ext:
            color, alpha = composite_slabs_ext(
                vol_chunk[:, None], shadow_chunk, c.y_pairs, c.x_pairs,
                c.covy, c.covx, c.corr_exp, c.x_src, c.y_src, c.zw,
                pack_controls(tf), c.misc, c.perm, pack_lut(tf))
        else:
            color, alpha = composite_slabs(
                vol_chunk, c.y_pairs, c.x_pairs, c.covy, c.covx, c.corr_exp,
                pack_controls(tf), pack_lut(tf))
        part = torch.cat([color.permute(2, 0, 1), alpha[None]])
        g = all_gather(part, mesh, "data")  # [n, 4, hi, wi]
        out = g[0]
        for i in range(1, n):  # front-to-back `over` of the n chunks
            out = out + (1.0 - out[3:4]) * g[i]
        return _final_warp(out[:3].permute(1, 2, 0), out[3], *st.warp)

    return frame
