"""Transfer functions: piecewise-linear control points baked into dense LUTs
(counterpart of `instantvnr_tpu/utils/tfn.py`).

Reference semantics (`raytracing.h:146-164` `sampleTransferFunction`): the
value is clamped to `tfn.range`, normalized, then color and alpha are read
from nodal 1-D arrays with linear interpolation. A baked transfer function
carries both the dense LUT (for classification of detailed TFs and for the
macrocell range-max structure) and the padded control points (for the
control-point classification form).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from instantvnr_torch.config import TransferFunctionConfig

# beyond this many segments classification reads the dense LUT instead of
# evaluating the control-point chain (instantvnr_tpu/utils/tfn.py:165)
_CONTROLS_CROSSOVER = 64


@dataclass(frozen=True)
class TransferFunction:
    """Baked transfer function: tensors on one device."""

    colors: torch.Tensor  # [R, 3] float32
    alphas: torch.Tensor  # [R] float32
    alpha_rmq: torch.Tensor  # [K, R]: alpha_rmq[k, i] = max(alphas[i:i+2^k])
    range_lo: torch.Tensor  # 0-dim, value-domain lower bound
    range_hi: torch.Tensor  # 0-dim
    ctrl_x: torch.Tensor  # [Kc] control positions in [0,1] (sorted, padded)
    ctrl_rgba: torch.Tensor  # [Kc, 4] control colors + alpha

    @property
    def resolution(self) -> int:
        return self.colors.shape[0]


def _interp_controls(points: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Piecewise-linear interpolation of [N, 1+C] control points at xs."""
    pos = points[:, 0]
    order = np.argsort(pos)
    pos = pos[order]
    vals = points[order, 1:]
    return np.stack(
        [np.interp(xs, pos, vals[:, c]) for c in range(vals.shape[1])], axis=-1)


def build_alpha_rmq(alphas: np.ndarray) -> np.ndarray:
    """Sparse table for range-max queries over the alpha LUT:
    alpha_rmq[k, i] = max(alphas[i : i + 2^k]) (clamped at the end)."""
    r = alphas.shape[0]
    n_levels = max(1, int(np.ceil(np.log2(r))) + 1)
    table = np.empty((n_levels, r), np.float32)
    table[0] = alphas
    for k in range(1, n_levels):
        half = 1 << (k - 1)
        shifted = np.concatenate([table[k - 1, half:],
                                  table[k - 1, -1:].repeat(half)])
        table[k] = np.maximum(table[k - 1], shifted)
    return table


def bake_transfer_function(cfg: TransferFunctionConfig, resolution: int = 1024,
                           device="cuda") -> TransferFunction:
    """Bake on the host (numpy, bit-identical to the JAX package's bake) and
    place the result on `device`."""
    from instantvnr_torch.utils.device import resolve_device

    dev = resolve_device(device)
    xs = np.linspace(0.0, 1.0, resolution).astype(np.float32)
    colors = _interp_controls(np.asarray(cfg.colors, np.float32), xs)
    alphas = _interp_controls(np.asarray(cfg.alphas, np.float32), xs)[:, 0]

    # merged control points: union of color and alpha knot positions
    cpos = np.asarray([c[0] for c in cfg.colors], np.float32)
    apos = np.asarray([a[0] for a in cfg.alphas], np.float32)
    knots = np.unique(np.concatenate([cpos, apos, [0.0, 1.0]]))
    rgb_k = _interp_controls(np.asarray(cfg.colors, np.float32), knots)
    a_k = _interp_controls(np.asarray(cfg.alphas, np.float32), knots)[:, 0]
    ctrl = np.concatenate([rgb_k, a_k[:, None]], axis=-1)
    # padded to a power of two by repeating the last knot: the padded
    # segments have zero width and rely on max(denom, 1e-12)
    kc = 1 << max(2, int(np.ceil(np.log2(len(knots)))))
    pad = kc - len(knots)
    if pad:
        knots = np.concatenate([knots, np.full(pad, knots[-1])])
        ctrl = np.concatenate([ctrl, np.repeat(ctrl[-1:], pad, 0)])

    # RMQ majorant envelope: env[i] covers [xs[i], xs[i+1]] — both bin
    # endpoints plus every alpha knot inside the bin
    env = alphas.copy()
    env[:-1] = np.maximum(env[:-1], alphas[1:])
    a_knots = np.asarray(cfg.alphas, np.float32)
    kidx = np.clip((a_knots[:, 0] * (resolution - 1)).astype(np.int64),
                   0, resolution - 2)
    np.maximum.at(env, kidx, a_knots[:, 1])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return TransferFunction(
        colors=t(colors), alphas=t(alphas), alpha_rmq=t(build_alpha_rmq(env)),
        range_lo=t(np.float32(cfg.range[0])),
        range_hi=t(np.float32(cfg.range[1])),
        ctrl_x=t(knots), ctrl_rgba=t(ctrl))


def clip_ties(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """clamp(u, lo, hi) with the JAX package's gradient on the bounds:
    jnp.clip is a maximum then a minimum, each of which splits the
    cotangent of a tie in two, so a value of exactly a knot or the range's
    end, a kink of the transfer function, passes half of it (torch.clamp
    passes all of it). Only a differentiable frame
    (RaymarchSettings.fixed_steps) reaches the second form."""
    if not u.requires_grad:
        return torch.clamp(u, lo, hi)
    lo = torch.as_tensor(lo, dtype=u.dtype, device=u.device)
    hi = torch.as_tensor(hi, dtype=u.dtype, device=u.device)
    return torch.minimum(torch.maximum(u, lo), hi)


def _normalized(tf: TransferFunction, values: torch.Tensor) -> torch.Tensor:
    return ((clip_ties(values, tf.range_lo, tf.range_hi) - tf.range_lo)
            / torch.clamp(tf.range_hi - tf.range_lo, min=1e-20))


def classify(tf: TransferFunction, values: torch.Tensor):
    """Value → (rgb [..., 3], alpha [...]) through the dense LUT with nodal
    lerp (`raytracing.h:148-157`)."""
    v = _normalized(tf, values)
    r = tf.resolution
    x = v * (r - 1)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, r - 2)
    frac = x - i0.to(torch.float32)
    c0 = tf.colors[i0]
    c1 = tf.colors[i0 + 1]
    a0 = tf.alphas[i0]
    a1 = tf.alphas[i0 + 1]
    return c0 + (c1 - c0) * frac[..., None], a0 + (a1 - a0) * frac


def classify_controls(tf: TransferFunction, values: torch.Tensor):
    """Classification from the control points by the telescoping form

        f(v) = y₀ + Σᵢ (yᵢ₊₁ − yᵢ)·clip((v − xᵢ)/(xᵢ₊₁ − xᵢ), 0, 1),

    exact for values covered by the control points. Transfer functions of
    more than `_CONTROLS_CROSSOVER` segments read the dense LUT instead."""
    kc = tf.ctrl_x.shape[0]
    if kc - 1 > _CONTROLS_CROSSOVER:
        return classify(tf, values)
    v = _normalized(tf, values)
    x = tf.ctrl_x
    y = tf.ctrl_rgba
    acc = y[0].expand(v.shape + (4,)).to(torch.float32)
    for i in range(kc - 1):
        denom = torch.clamp(x[i + 1] - x[i], min=1e-12)
        t = clip_ties((v - x[i]) / denom, 0.0, 1.0)
        acc = acc + t[..., None] * (y[i + 1] - y[i])
    return acc[..., :3], acc[..., 3]


def max_alpha_in_range(tf: TransferFunction, lo: torch.Tensor,
                       hi: torch.Tensor) -> torch.Tensor:
    """Max alpha over the data-unit value interval [lo, hi], O(1) gathers
    through the sparse table (macrocell.cu:153-193 index rule: round to the
    nearest LUT entry, widen by one on each side, clamp)."""
    r = tf.resolution
    denom = torch.clamp(tf.range_hi - tf.range_lo, min=1e-20)
    nlo = torch.clamp((lo - tf.range_lo) / denom, 0.0, 1.0)
    nhi = torch.clamp((hi - tf.range_lo) / denom, 0.0, 1.0)
    i0 = torch.clamp(torch.floor(nlo * (r - 1) + 0.5).to(torch.int64) - 1,
                     0, r - 1)
    i1 = torch.clamp(torch.floor(nhi * (r - 1) + 0.5).to(torch.int64) + 1,
                     0, r - 1)
    length = torch.clamp(i1 - i0 + 1, min=1)
    k = torch.clamp(torch.floor(torch.log2(length.to(torch.float32))
                                ).to(torch.int64),
                    0, tf.alpha_rmq.shape[0] - 1)
    left = tf.alpha_rmq[k, i0]
    right_start = torch.clamp(i1 + 1 - torch.pow(2, k), min=0)
    right = tf.alpha_rmq[k, right_start]
    out = torch.maximum(left, right)
    return torch.where(i1 >= i0, out, tf.alphas[torch.clamp(i0, 0, r - 1)])
