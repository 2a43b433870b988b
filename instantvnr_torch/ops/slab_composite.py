"""Slab compositor: the whole front-to-back slab loop of a frame as one CUDA
kernel (`csrc/slab_composite.cu`), counterpart of the TPU kernel
`instantvnr_tpu/ops/pallas/slab_composite.py::composite_slabs`.

`composite_slabs` launches the kernel for CUDA tensors and takes the plain
version, `composite_slabs_reference`, only for CPU tensors. Both take every
transfer function: up to `_CONTROLS_CROSSOVER` segments they classify from
the control points, beyond it from the dense LUT (`lut`), as the JAX
package's XLA scan does (the TPU kernel covered only the first form).
"""
from __future__ import annotations

import numpy as np
import torch

from instantvnr_torch.config import NEARLY_ONE
from instantvnr_torch.ops.cuda_lib import LaunchCounter
from instantvnr_torch.utils.tfn import _CONTROLS_CROSSOVER, TransferFunction

counter = LaunchCounter()

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
        alpha = 1.0 - torch.pow(torch.clamp(1.0 - rgba[..., 3], min=0.0),
                                corr_exp)
        mask = (covy[k][:, None] * covx[k][None, :]
                * (trans > TERM_THRESH).to(torch.float32))
        alpha = alpha * mask
        color = color + (trans * alpha)[..., None] * rgba[..., :3]
        trans = trans * (1.0 - alpha)
    return color, 1.0 - trans


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
