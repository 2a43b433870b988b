"""First-hit isosurface sweep: the whole slab sweep of a frame as one CUDA
kernel (`csrc/iso_sweep.cu`), counterpart of the TPU kernel
`instantvnr_tpu/ops/pallas/iso_sweep.py::iso_sweep`.

`iso_sweep` launches the kernel for CUDA tensors and takes the plain
version, `iso_sweep_reference`, only for CPU tensors. Both resample each
slab through per-row pairs (ops/slab_composite.py::resample_pairs;
render/slabmarch.py::_interp_pairs), the two nonzeros of each row of the
dense interpolation matrices that the TPU kernel multiplies.

The kernel's output [5, hi, wi]: 0 found, 1 hit_z, 2:5 hit_g.
"""
from __future__ import annotations

import torch

from instantvnr_torch.ops.cuda_lib import LaunchCounter
from instantvnr_torch.ops.slab_composite import (_kernel_tensors,
                                                 _pair_entries,
                                                 _slab_pairs, resample_pairs)

counter = LaunchCounter()


def iso_sweep_reference(fields, y_pairs, x_pairs, covy, covx, iso):
    """Plain version: the TPU kernel's crossing test (iso_sweep.py:58-78)
    formula for formula over the same per-slab inputs as the kernel,
    resampling through the pairs (`resample_pairs`) where the TPU kernel
    multiplies dense matrices. Returns (found [hi, wi] float 0/1, hit_z
    [hi, wi], hit_g [hi, wi, 3])."""
    d = fields.shape[0]
    hi, wi = covy.shape[1], covx.shape[1]
    dev = fields.device
    zero = torch.zeros((hi, wi), dtype=torch.float32, device=dev)
    found, hit_z, prev_v, prev_ok = zero, zero, zero, zero
    hit_g = [zero] * 3
    prev_g = [zero] * 3
    for k in range(d):
        rs = resample_pairs(fields[k], _slab_pairs(y_pairs, k),
                            _slab_pairs(x_pairs, k))  # [4, hi, wi]
        vals = rs[0]
        cov = covy[k][:, None] * covx[k][None, :]
        denom = vals - prev_v
        frac = torch.where(torch.abs(denom) > 1e-12, (iso - prev_v) / denom,
                           torch.full_like(denom, 0.5))
        frac = torch.clamp(frac, 0.0, 1.0)
        sign = ((prev_v - iso) * (vals - iso) <= 0.0).to(torch.float32)
        newly = prev_ok * cov * sign * (1.0 - found)
        z_cross = (float(k) - 0.5) + frac  # z_{k-1} = k − 0.5
        hit_z = hit_z + newly * (z_cross - hit_z)
        for c in range(3):
            g_cross = prev_g[c] + frac * (rs[1 + c] - prev_g[c])
            hit_g[c] = hit_g[c] + newly * (g_cross - hit_g[c])
        found = torch.maximum(found, newly)
        prev_v = vals
        prev_ok = cov
        prev_g = [rs[1 + c] for c in range(3)]
    return found, hit_z, torch.stack(hit_g, dim=-1)


def iso_sweep(fields, y_pairs, x_pairs, covy, covx, iso: float):
    """Fused first-hit sweep over precomputed per-slab resampling state.

    fields   [D, 4, ay, ax]  permuted value + world-gradient slabs
    y_pairs  (j0 [D, hi] int32, w [D, hi, 2])  per-slab row interpolation
             (render/slabmarch.py::_interp_pairs)
    x_pairs  (j0 [D, wi] int32, w [D, wi, 2])  the same for columns
    covy     [D, hi] 0/1  row coverage & clip
    covx     [D, wi] 0/1  column coverage & clip & slab keep
    iso      the isovalue (a float: an edit rebuilds nothing)
    Returns (found [hi, wi] float 0/1, hit_z [hi, wi], hit_g [hi, wi, 3]).
    """
    iso = float(iso)
    if fields.device.type == "cpu":
        return iso_sweep_reference(fields, y_pairs, x_pairs, covy, covx, iso)
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")
    d, _, ay, ax = fields.shape
    hi, wi = covy.shape[1], covx.shape[1]
    f32 = torch.float32
    t = _kernel_tensors(
        "iso_sweep", fields.device,
        [("fields", fields, (d, 4, ay, ax), f32)]
        + _pair_entries(y_pairs, x_pairs, d, hi, wi)
        + [("covy", covy, (d, hi), f32), ("covx", covx, (d, wi), f32)])
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    out = torch.empty((5, hi, wi), dtype=torch.float32, device=fields.device)
    lib.call("iso_sweep_forward",
             *(t[n].data_ptr() for n in ("fields", "jy", "wy", "jx", "wx",
                                         "covy", "covx")),
             iso, out.data_ptr(), d, ay, ax, hi, wi,
             torch.cuda.current_stream(fields.device).cuda_stream)
    counter.launches += 1
    return out[0], out[1], out[2:5].permute(1, 2, 0)
