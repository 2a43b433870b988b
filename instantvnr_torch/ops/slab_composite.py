"""Slab compositors: the whole front-to-back slab loop of a frame as one CUDA
kernel (`csrc/slab_composite.cu`, one kernel template for both),
counterparts of the TPU kernels in
`instantvnr_tpu/ops/pallas/slab_composite.py`:

- `composite_slabs`: the unshaded loop;
- `composite_slabs_ext`: the same loop over the value and its three
  world-gradient fields with scivis + headlight shading, and/or a
  shadow-transmittance slab that darkens each sample.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (`*_reference`) only for CPU tensors. All take every transfer
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


def composite_slabs_reference(vol, my_all, mx_all, covy, covx, corr_exp,
                              ctrl, lut=None):
    """Plain version: the front-to-back loop of the JAX package's scan
    (instantvnr_tpu/render/slabmarch.py:478-558), unshaded, over the same
    precomputed per-slab inputs as the kernel. Returns (color [hi, wi, 3]
    premultiplied, alpha [hi, wi])."""
    d = vol.shape[0]
    hi, wi = corr_exp.shape
    color = torch.zeros((hi, wi, 3), dtype=torch.float32, device=vol.device)
    trans = torch.ones((hi, wi), dtype=torch.float32, device=vol.device)
    for k in range(d):
        vals = my_all[k] @ vol[k] @ mx_all[k].T  # [hi, wi]
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


def composite_slabs(vol, my_all, mx_all, covy, covx, corr_exp, ctrl,
                    lut=None):
    """Fused compositor over precomputed per-slab resampling state.

    vol      [D, ay, ax]   permuted volume
    my_all   [D, hi, ay]   per-slab row interpolation matrices
    mx_all   [D, wi, ax]   per-slab column interpolation matrices
    covy     [D, hi]       row coverage & clip (0/1)
    covx     [D, wi]       column coverage & clip & per-slab keep (0/1)
    corr_exp [hi, wi]      opacity-correction exponent (per-pixel Δt)
    ctrl     [Kc, 8]       pack_controls(tf)
    lut      [R, 4] | None pack_lut(tf): classify from the dense LUT
    returns  (color [hi, wi, 3] premultiplied, alpha [hi, wi])
    """
    if vol.device.type == "cpu":
        return composite_slabs_reference(vol, my_all, mx_all, covy, covx,
                                         corr_exp, ctrl, lut)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    d, ay, ax = vol.shape
    hi, wi = corr_exp.shape
    args = [vol, my_all, mx_all, covy, covx, corr_exp, ctrl] + (
        [] if lut is None else [lut])
    shapes = [(d, ay, ax), (d, hi, ay), (d, wi, ax), (d, hi), (d, wi),
              (hi, wi), (ctrl.shape[0], 8)] + ([] if lut is None
                                               else [(lut.shape[0], 4)])
    for a, s in zip(args, shapes):
        if (a.device != vol.device or a.dtype != torch.float32
                or tuple(a.shape) != s):
            raise ValueError(f"composite_slabs: expected float32 {s} on "
                             f"{vol.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    args = [a.contiguous() for a in args]
    out = torch.empty((4, hi, wi), dtype=torch.float32, device=vol.device)
    lut_c = args[7] if lut is not None else None
    lib.call("slab_composite_forward", *(a.data_ptr() for a in args[:7]),
             ctrl.shape[0], None if lut_c is None else lut_c.data_ptr(),
             0 if lut_c is None else lut_c.shape[0], out.data_ptr(),
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


def composite_slabs_ext_reference(fields, shadow_vol, my_all, mx_all, covy,
                                  covx, corr_exp, x_src, y_src, zw, ctrl, misc,
                                  perm, lut=None):
    """Plain version of `composite_slabs_ext`: the TPU kernel's _kernel_ext
    (slab_composite.py:102-191) formula for formula, over the same
    precomputed per-slab inputs. Shades when fields has 4 channels, darkens
    by the shadow slab when shadow_vol is given."""
    d, c_f = fields.shape[:2]
    hi, wi = corr_exp.shape
    dev = fields.device
    shade = c_f == 4
    color = torch.zeros((hi, wi, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((hi, wi), dtype=torch.float32, device=dev)
    for k in range(d):
        my, mx_t = my_all[k], mx_all[k].T
        rs = torch.matmul(torch.matmul(my, fields[k]), mx_t)  # [C, hi, wi]
        rgba = _classify_packed(ctrl, lut, rs[0])
        rgb = [rgba[..., c] for c in range(3)]
        if shade:
            rgb = _shade_ext(rgb, rs, x_src[k], y_src[k], zw[k], misc, perm)
        if shadow_vol is not None:
            sh = my @ shadow_vol[k] @ mx_t
            amb = misc[0]
            f = amb + (1.0 - amb) * torch.clamp(sh, 0.0, 1.0)
            rgb = [r * f for r in rgb]
        color, trans = _blend(color, trans, torch.stack(rgb, dim=-1),
                              rgba[..., 3], corr_exp, covy[k], covx[k])
    return color, 1.0 - trans


def composite_slabs_ext(fields, shadow_vol, my_all, mx_all, covy, covx,
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
            fields, shadow_vol, my_all, mx_all, covy, covx, corr_exp, x_src,
            y_src, zw, ctrl, misc, perm, lut)
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")
    d, c_f, ay, ax = fields.shape
    hi, wi = corr_exp.shape
    named = [("fields", fields, (d, c_f, ay, ax)),
             ("my_all", my_all, (d, hi, ay)), ("mx_all", mx_all, (d, wi, ax)),
             ("covy", covy, (d, hi)), ("covx", covx, (d, wi)),
             ("corr_exp", corr_exp, (hi, wi)), ("x_src", x_src, (d, wi)),
             ("y_src", y_src, (d, hi)), ("zw", zw, (d,)),
             ("ctrl", ctrl, (ctrl.shape[0], 8)), ("misc", misc, (11,))]
    if shadow_vol is not None:
        named.append(("shadow_vol", shadow_vol, (d, ay, ax)))
    if lut is not None:
        named.append(("lut", lut, (lut.shape[0], 4)))
    for name, a, s in named:
        if (a.device != fields.device or a.dtype != torch.float32
                or tuple(a.shape) != s):
            raise ValueError(f"composite_slabs_ext: expected {name} float32 "
                             f"{s} on {fields.device}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    from instantvnr_torch.ops.cuda_lib import load_library

    lib = load_library()
    t = {name: a.contiguous() for name, a, _ in named}
    out = torch.empty((4, hi, wi), dtype=torch.float32, device=fields.device)

    def ptr(name):
        return t[name].data_ptr() if name in t else None

    lib.call("slab_composite_ext_forward", ptr("fields"), c_f,
             ptr("shadow_vol"), ptr("my_all"), ptr("mx_all"), ptr("covy"),
             ptr("covx"), ptr("corr_exp"), ptr("x_src"), ptr("y_src"),
             ptr("zw"), ptr("ctrl"), ctrl.shape[0], ptr("lut"),
             0 if lut is None else lut.shape[0], ptr("misc"), *perm,
             out.data_ptr(), d, ay, ax, hi, wi, TERM_THRESH,
             torch.cuda.current_stream(fields.device).cuda_stream)
    ext_counter.launches += 1
    return out[:3].permute(1, 2, 0), 1.0 - out[3]
