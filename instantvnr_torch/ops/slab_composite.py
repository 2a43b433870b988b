"""Slab compositors: the whole front-to-back slab loop of a frame as one CUDA
kernel (`csrc/slab_composite.cu`, one kernel template for both),
counterparts of the TPU kernels in
`instantvnr_tpu/ops/pallas/slab_composite.py`:

- `composite_slabs`: the unshaded loop;
- `composite_slabs_ext`: the same loop over the value and its three
  world-gradient fields with scivis + headlight shading, and/or a
  shadow-transmittance slab that darkens each sample.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (`*_reference`) only for CPU tensors. Both resample each slab
through per-row pairs (`resample_pairs`; render/slabmarch.py::
_interp_pairs), the two nonzeros of each row of the dense interpolation
matrices, in the order of the dense product. All take every transfer
function: up to `_CONTROLS_CROSSOVER` segments they classify from the
control points, beyond it from the dense LUT (`lut`), as the JAX package's
XLA scan does (the TPU kernels covered only the first form).
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.config import NEARLY_ONE
from instantvnr_torch.ops.cuda_lib import LaunchCounter
from instantvnr_torch.utils.tfn import _CONTROLS_CROSSOVER, TransferFunction

counter = LaunchCounter()
ext_counter = LaunchCounter()

# early-termination threshold on the transmittance, rounded to float32 as
# the JAX package's weakly-typed comparison rounds it
TERM_THRESH = float(np.float32(1.0 - NEARLY_ONE))


def pack_controls(tf: TransferFunction) -> torch.Tensor:
    """Control points → [Kc, 8] rows [x, r, g, b, a, range_lo, range_hi, 0]."""
    kc = tf.ctrl_x.shape[0]
    rng = torch.stack([tf.range_lo.expand(kc), tf.range_hi.expand(kc)], dim=-1)
    return torch.cat([tf.ctrl_x[:, None], tf.ctrl_rgba, rng,
                      torch.zeros((kc, 1), dtype=torch.float32,
                                  device=tf.ctrl_x.device)], dim=-1)


def pack_lut(tf: TransferFunction) -> torch.Tensor | None:
    """The dense [R, 4] rgba LUT when the TF has more segments than the
    control-point form takes, else None."""
    if tf.ctrl_x.shape[0] - 1 <= _CONTROLS_CROSSOVER:
        return None
    return torch.cat([tf.colors, tf.alphas[:, None]], dim=-1).contiguous()


def _classify_packed(ctrl: torch.Tensor, lut: torch.Tensor | None,
                     vals: torch.Tensor):
    lo, hi = ctrl[0, 5], ctrl[0, 6]
    v = (torch.clamp(vals, lo, hi) - lo) / torch.clamp(hi - lo, min=1e-20)
    if lut is not None:
        r = lut.shape[0]
        x = v * (r - 1)
        i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, r - 2)
        frac = (x - i0.to(torch.float32))[..., None]
        c0, c1 = lut[i0], lut[i0 + 1]
        return c0 + (c1 - c0) * frac  # [..., 4]
    kc = ctrl.shape[0]
    acc = ctrl[0, 1:5].expand(v.shape + (4,)).clone()
    for i in range(kc - 1):
        denom = torch.clamp(ctrl[i + 1, 0] - ctrl[i, 0], min=1e-12)
        t = torch.clamp((v - ctrl[i, 0]) / denom, 0.0, 1.0)
        acc = acc + t[..., None] * (ctrl[i + 1, 1:5] - ctrl[i, 1:5])
    return acc


def resample_pairs(src, y_pairs, x_pairs):
    """Banded resample of src [..., ay, ax] → [..., hi, wi] through one
    slab's pairs (j0 [n], w [n, 2] per axis, render/slabmarch.py::
    _interp_pairs), in the order of the dense product's nonzero terms:
    tmp = wy0·src[jy] + wy1·src[jy + 1], then v = wx0·tmp[:, jx] +
    wx1·tmp[:, jx + 1]. The kernels sum in the same order."""
    (jy, wy), (jx, wx) = y_pairs, x_pairs
    jy, jx = jy.to(torch.int64), jx.to(torch.int64)
    tmp = (wy[:, 0, None] * src[..., jy, :]
           + wy[:, 1, None] * src[..., jy + 1, :])
    return wx[:, 0] * tmp[..., jx] + wx[:, 1] * tmp[..., jx + 1]


def _slab_pairs(pairs, k):
    return pairs[0][k], pairs[1][k]


def composite_slabs_reference(vol, y_pairs, x_pairs, covy, covx, corr_exp,
                              ctrl, lut=None):
    """Plain version: the front-to-back loop of the JAX package's scan
    (instantvnr_tpu/render/slabmarch.py:478-558), unshaded, over the same
    precomputed per-slab inputs as the kernel, resampling through the
    pairs (`resample_pairs`) where the scan multiplies dense matrices.
    Returns (color [hi, wi, 3] premultiplied, alpha [hi, wi])."""
    d = vol.shape[0]
    hi, wi = corr_exp.shape
    color = torch.zeros((hi, wi, 3), dtype=torch.float32, device=vol.device)
    trans = torch.ones((hi, wi), dtype=torch.float32, device=vol.device)
    for k in range(d):
        vals = resample_pairs(vol[k], _slab_pairs(y_pairs, k),
                              _slab_pairs(x_pairs, k))  # [hi, wi]
        rgba = _classify_packed(ctrl, lut, vals)
        color, trans = _blend(color, trans, rgba[..., :3], rgba[..., 3],
                              corr_exp, covy[k], covx[k])
    return color, 1.0 - trans


def _blend(color, trans, rgb, a, corr_exp, covy_k, covx_k):
    """Opacity correction 1-(1-a)^corr, coverage x early-termination mask
    and front-to-back blend of one slab (the TPU kernels' _blend,
    slab_composite.py:84). Returns the new (color, trans)."""
    alpha = 1.0 - torch.pow(torch.clamp(1.0 - a, min=0.0), corr_exp)
    mask = (covy_k[:, None] * covx_k[None, :]
            * (trans > TERM_THRESH).to(torch.float32))
    alpha = alpha * mask
    color = color + (trans * alpha)[..., None] * rgb
    return color, trans * (1.0 - alpha)


def _kernel_tensors(name, device, named):
    """Check (name, tensor, shape, dtype) entries for the kernels: each on
    `device`, of its dtype and shape → {name: contiguous tensor, 16-byte
    aligned for the kernels' vector loads}."""
    out = {}
    for arg, a, s, dt in named:
        if a.device != device or a.dtype != dt or tuple(a.shape) != s:
            raise ValueError(f"{name}: expected {arg} {dt} {s} on {device}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")
        a = a.contiguous()
        out[arg] = a.clone() if a.data_ptr() % 16 else a
    return out


def _pair_entries(y_pairs, x_pairs, d, hi, wi, ay, ax):
    """The pairs' entries for _kernel_tensors. The kernels read columns j0
    and j0 + 1 of every row (j0 in [0, n − 2]), so each slab axis needs 2
    voxels, as _interp_pairs does."""
    if ay < 2 or ax < 2:
        raise ValueError(f"slab compositors: a slab of {ay} x {ax} voxels; "
                         f"the banded resample needs 2 along each axis")
    i32, f32 = torch.int32, torch.float32
    return [("jy", y_pairs[0], (d, hi), i32),
            ("wy", y_pairs[1], (d, hi, 2), f32),
            ("jx", x_pairs[0], (d, wi), i32),
            ("wx", x_pairs[1], (d, wi, 2), f32)]


def composite_slabs(vol, y_pairs, x_pairs, covy, covx, corr_exp, ctrl,
                    lut=None):
    """Fused compositor over precomputed per-slab resampling state.

    vol      [D, ay, ax]   permuted volume
    y_pairs  (j0 [D, hi] int32, w [D, hi, 2])  per-slab row interpolation:
                           row i samples vol rows j0 and j0 + 1
                           (render/slabmarch.py::_interp_pairs)
    x_pairs  (j0 [D, wi] int32, w [D, wi, 2])  the same for columns
    covy     [D, hi]       row coverage & clip (0/1)
    covx     [D, wi]       column coverage & clip & per-slab keep (0/1)
    corr_exp [hi, wi]      opacity-correction exponent (per-pixel Δt)
    ctrl     [Kc, 8]       pack_controls(tf)
    lut      [R, 4] | None pack_lut(tf): classify from the dense LUT
    returns  (color [hi, wi, 3] premultiplied, alpha [hi, wi])

    CUDA tensors launch `slab_composite_forward`, the kernel template's
    <false, false> instantiation; CPU tensors take
    `composite_slabs_reference`.
    """
    if vol.device.type == "cpu":
        return composite_slabs_reference(vol, y_pairs, x_pairs, covy, covx,
                                         corr_exp, ctrl, lut)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    d, ay, ax = vol.shape
    hi, wi = corr_exp.shape
    f32 = torch.float32
    named = ([("vol", vol, (d, ay, ax), f32)]
             + _pair_entries(y_pairs, x_pairs, d, hi, wi, ay, ax)
             + [("covy", covy, (d, hi), f32), ("covx", covx, (d, wi), f32),
                ("corr_exp", corr_exp, (hi, wi), f32),
                ("ctrl", ctrl, (ctrl.shape[0], 8), f32)]
             + ([] if lut is None else [("lut", lut, (lut.shape[0], 4),
                                         f32)]))
    t = _kernel_tensors("composite_slabs", vol.device, named)
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    out = torch.empty((4, hi, wi), dtype=torch.float32, device=vol.device)
    lib.call("slab_composite_forward",
             *(t[n].data_ptr() for n in ("vol", "jy", "wy", "jx", "wx",
                                         "covy", "covx", "corr_exp",
                                         "ctrl")),
             ctrl.shape[0], t["lut"].data_ptr() if "lut" in t else None,
             0 if lut is None else lut.shape[0], out.data_ptr(),
             d, ay, ax, hi, wi, TERM_THRESH,
             torch.cuda.current_stream(vol.device).cuda_stream)
    counter.launches += 1
    return out[:3].permute(1, 2, 0), 1.0 - out[3]


def pack_misc(shadow_ambient, shading_scale, light, eye_w, scale):
    """The [11] scalar vector of `composite_slabs_ext` (the TPU kernel's
    SMEM layout, slab_composite.py:98-101): [0] shadow_ambient,
    [1] shading_scale, [2:5] light direction (normalized, flipped against
    the view), [5:8] eye (voxel space, world axis order), [8:11] voxel→world
    scale."""
    dev = eye_w.device
    return torch.cat([
        torch.tensor([shadow_ambient, shading_scale], dtype=torch.float32,
                     device=dev),
        torch.as_tensor(light, dtype=torch.float32, device=dev).reshape(3),
        eye_w.to(torch.float32).reshape(3),
        scale.to(torch.float32).reshape(3)])


def _shade_ext(rgb, rs, x_src_k, y_src_k, zw_k, misc, perm):
    """Scivis + headlight shading of one slab's samples, formula for formula
    the TPU kernel's (_kernel_ext, slab_composite.py:140-181): rgb is a list
    of three [hi, wi] planes, rs the four resampled fields (value, then the
    world gradient)."""
    hi, wi = rs[0].shape
    scale = [misc[8 + c] for c in range(3)]
    eye = [misc[5 + c] for c in range(3)]
    light = [misc[2 + c] for c in range(3)]
    # per-pixel world position: permuted source coords (x per column, y per
    # row, z per slab) → world components
    p_perm = [x_src_k[None, :].expand(hi, wi), y_src_k[:, None].expand(hi, wi),
              zw_k.expand(hi, wi)]
    p_world = [None, None, None]
    for i_ax in range(3):
        p_world[perm[i_ax]] = p_perm[i_ax]
    view = [(p_world[c] - eye[c]) * scale[c] for c in range(3)]
    vn = torch.sqrt(view[0] * view[0] + view[1] * view[1]
                    + view[2] * view[2])
    view = [v / torch.clamp(vn, min=1e-9) for v in view]
    # world-space normal: diagonal xfmNormal = divide by scale
    normal = [-rs[1 + c] / scale[c] for c in range(3)]
    nn = normal[0] * normal[0] + normal[1] * normal[1] + normal[2] * normal[2]
    has_n = nn > 1e-6
    n = [x / torch.sqrt(torch.clamp(nn, min=1e-20)) for x in normal]
    cos_nl = torch.clamp(n[0] * light[0] + n[1] * light[1] + n[2] * light[2],
                         min=0.0)
    h = [light[c] - view[c] for c in range(3)]
    hn = torch.sqrt(h[0] * h[0] + h[1] * h[1] + h[2] * h[2])
    h = [x / torch.clamp(hn, min=1e-20) for x in h]
    cos_nh = torch.clamp(n[0] * h[0] + n[1] * h[1] + n[2] * h[2], min=0.0)
    spec = 0.4 * torch.pow(cos_nh, 40.0)
    lit = (cos_nl > 0.0).to(torch.float32)
    cos_vn = torch.abs(view[0] * n[0] + view[1] * n[1] + view[2] * n[2])
    zero = torch.zeros_like(cos_vn)
    simple_w = torch.where(has_n, 0.2 + 0.8 * cos_vn, zero)
    s_ = misc[1]
    out = []
    for c in range(3):
        scivis = torch.where(
            has_n, 0.6 * rgb[c] + lit * (0.9 * cos_nl * rgb[c] + spec), zero)
        sh_c = 0.5 * rgb[c] * simple_w + 0.5 * scivis
        out.append(s_ * sh_c + (1.0 - s_) * rgb[c])
    return out


def composite_slabs_ext_reference(fields, shadow_vol, y_pairs, x_pairs, covy,
                                  covx, corr_exp, x_src, y_src, zw, ctrl, misc,
                                  perm, lut=None):
    """Plain version of `composite_slabs_ext`: the TPU kernel's _kernel_ext
    (slab_composite.py:102-191) formula for formula, over the same
    precomputed per-slab inputs, resampling every field through the pairs
    (`resample_pairs`). Shades when fields has 4 channels, darkens by the
    shadow slab when shadow_vol is given."""
    d, c_f = fields.shape[:2]
    hi, wi = corr_exp.shape
    dev = fields.device
    shade = c_f == 4
    color = torch.zeros((hi, wi, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((hi, wi), dtype=torch.float32, device=dev)
    for k in range(d):
        yk, xk = _slab_pairs(y_pairs, k), _slab_pairs(x_pairs, k)
        rs = resample_pairs(fields[k], yk, xk)  # [C, hi, wi]
        rgba = _classify_packed(ctrl, lut, rs[0])
        rgb = [rgba[..., c] for c in range(3)]
        if shade:
            rgb = _shade_ext(rgb, rs, x_src[k], y_src[k], zw[k], misc, perm)
        if shadow_vol is not None:
            sh = resample_pairs(shadow_vol[k], yk, xk)
            amb = misc[0]
            f = amb + (1.0 - amb) * torch.clamp(sh, 0.0, 1.0)
            rgb = [r * f for r in rgb]
        color, trans = _blend(color, trans, torch.stack(rgb, dim=-1),
                              rgba[..., 3], corr_exp, covy[k], covx[k])
    return color, 1.0 - trans


def composite_slabs_ext(fields, shadow_vol, y_pairs, x_pairs, covy, covx,
                        corr_exp, x_src, y_src, zw, ctrl, misc, perm,
                        lut=None):
    """Fused compositor with gradient shading and/or shadow modulation.

    fields     [D, C, ay, ax]  permuted value (+3 world-gradient) slabs;
                               C = 4 shades, C = 1 does not
    shadow_vol [D, ay, ax] | None  permuted shadow transmittance
    x_src      [D, wi]  per-slab permuted-voxel x of each column
    y_src      [D, hi]  per-slab permuted-voxel y of each row
    zw         [D]      slab z in UNFLIPPED permuted voxel coords
    misc       [11]     pack_misc(...)
    perm       (3 ints) permuted-axis → world-component map (slabmarch)
    Other arguments as composite_slabs. Returns (color premult, alpha).

    CUDA tensors launch `slab_composite_ext_forward`, the kernel template's
    <shade, shadow> instantiation; CPU tensors take
    `composite_slabs_ext_reference`.
    """
    if fields.dim() != 4 or fields.shape[1] not in (1, 4):
        raise ValueError(f"composite_slabs_ext: fields must be [D, 1|4, ay, "
                         f"ax], got {tuple(fields.shape)}")
    if fields.shape[1] == 1 and shadow_vol is None:
        raise ValueError("composite_slabs_ext: neither shading nor a shadow "
                         "volume; use composite_slabs")
    if sorted(perm) != [0, 1, 2]:
        raise ValueError(f"composite_slabs_ext: perm {perm} is no permutation")
    if fields.device.type == "cpu":
        return composite_slabs_ext_reference(
            fields, shadow_vol, y_pairs, x_pairs, covy, covx, corr_exp,
            x_src, y_src, zw, ctrl, misc, perm, lut)
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")
    d, c_f, ay, ax = fields.shape
    hi, wi = corr_exp.shape
    f32 = torch.float32
    named = ([("fields", fields, (d, c_f, ay, ax), f32)]
             + _pair_entries(y_pairs, x_pairs, d, hi, wi, ay, ax)
             + [("covy", covy, (d, hi), f32), ("covx", covx, (d, wi), f32),
                ("corr_exp", corr_exp, (hi, wi), f32),
                ("x_src", x_src, (d, wi), f32), ("y_src", y_src, (d, hi), f32),
                ("zw", zw, (d,), f32), ("ctrl", ctrl, (ctrl.shape[0], 8), f32),
                ("misc", misc, (11,), f32)])
    if shadow_vol is not None:
        named.append(("shadow_vol", shadow_vol, (d, ay, ax), f32))
    if lut is not None:
        named.append(("lut", lut, (lut.shape[0], 4), f32))
    t = _kernel_tensors("composite_slabs_ext", fields.device, named)
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    out = torch.empty((4, hi, wi), dtype=torch.float32, device=fields.device)

    def ptr(name):
        return t[name].data_ptr() if name in t else None

    lib.call("slab_composite_ext_forward", ptr("fields"), c_f,
             ptr("shadow_vol"), ptr("jy"), ptr("wy"), ptr("jx"), ptr("wx"),
             ptr("covy"), ptr("covx"), ptr("corr_exp"), ptr("x_src"),
             ptr("y_src"), ptr("zw"), ptr("ctrl"), ctrl.shape[0], ptr("lut"),
             0 if lut is None else lut.shape[0], ptr("misc"), *perm,
             out.data_ptr(), d, ay, ax, hi, wi, TERM_THRESH,
             torch.cuda.current_stream(fields.device).cuda_stream)
    ext_counter.launches += 1
    return out[:3].permute(1, 2, 0), 1.0 - out[3]
