"""Progressive-rendering denoiser: an edge-preserving à-trous filter
(counterpart of `instantvnr_tpu/render/denoise.py`; the capability of the
reference's optional OptiX denoiser, renderer.cpp:117-121).

N passes of a 5×5 B3-spline kernel with a hole size doubling each pass
(Dammertz et al.), every tap an edge-clamped shift, weighted by the running
estimate's own color and alpha distances. Plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

# 1-D B3 spline kernel; the 2-D 5×5 kernel is its outer product
_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped shift of [H, W, C] by (dy, dx): out[i, j] =
    img[clamp(i − dy), clamp(j − dx)]."""
    h, w = img.shape[:2]
    rows = torch.clamp(torch.arange(h, device=img.device) - dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) - dx, 0, w - 1)
    return img[rows][:, cols]


@torch.no_grad()
def atrous_denoise(rgba: torch.Tensor, n_iters: int = 4,
                   sigma_color: float = 0.8,
                   sigma_alpha: float = 0.35) -> torch.Tensor:
    """rgba [H, W, 4] → denoised [H, W, 4]. All four channels are filtered
    jointly; the edge-stopping weight uses the estimate's own color and
    alpha distances, re-evaluated each level."""
    out = rgba.to(torch.float32)
    for it in range(n_iters):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=torch.float32,
                           device=out.device)
        for iy in range(5):
            for ix in range(5):
                k = float(_B3[iy] * _B3[ix])
                s = _shift2d(out, (iy - 2) * step, (ix - 2) * step)
                dc = torch.sum((s[..., :3] - out[..., :3]) ** 2, dim=-1,
                               keepdim=True)
                da = (s[..., 3:] - out[..., 3:]) ** 2
                w = k * torch.exp(-dc / (sigma_color ** 2)
                                  - da / (sigma_alpha ** 2))
                acc = acc + w * s
                wsum = wsum + w
        out = acc / torch.clamp(wsum, min=1e-8)
    return out
