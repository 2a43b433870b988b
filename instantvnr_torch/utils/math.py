"""Small vector helpers (counterpart of `instantvnr_tpu/utils/math.py`)."""
from __future__ import annotations

import numpy as np
import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=dim, keepdim=True),
                           min=eps)


def camera_frame(eye, center, up, device="cpu"):
    """Right-handed camera basis (dir, right, up'), as in the reference
    `Camera` → `LaunchParams.camera` derivation (renderer.cpp:87-96)."""
    eye = torch.as_tensor(eye, dtype=torch.float32, device=device)
    center = torch.as_tensor(center, dtype=torch.float32, device=device)
    up = torch.as_tensor(up, dtype=torch.float32, device=device)
    direction = normalize(center - eye)
    right = normalize(torch.linalg.cross(direction, up))
    true_up = torch.linalg.cross(right, direction)
    return direction, right, true_up


def look_at_rays(eye, center, up, fovy_deg, width: int, height: int,
                 jitter: torch.Tensor | None = None, device="cpu"):
    """Per-pixel primary rays of a look-at camera, pixel (0,0) at the lower
    left, rays through pixel centres (or `jitter` [H·W, 2] in [0,1)).
    Returns (origins [H·W, 3], directions [H·W, 3] normalized)."""
    direction, right, true_up = camera_frame(eye, center, up, device)
    f32 = torch.float32
    fovy = torch.tensor(float(fovy_deg), dtype=f32, device=device) \
        * np.float32(np.pi) / 180.0
    tan_half = torch.tan(0.5 * fovy)
    aspect = width / float(height)
    yy, xx = torch.meshgrid(torch.arange(height, dtype=f32, device=device),
                            torch.arange(width, dtype=f32, device=device),
                            indexing="ij")
    px, py = xx.reshape(-1), yy.reshape(-1)
    if jitter is None:
        px, py = px + 0.5, py + 0.5
    else:
        px, py = px + jitter[:, 0], py + jitter[:, 1]
    u = (px / width * 2.0 - 1.0) * tan_half * aspect
    v = (py / height * 2.0 - 1.0) * tan_half
    dirs = normalize(direction[None, :] + u[:, None] * right[None, :]
                     + v[:, None] * true_up[None, :])
    eye_t = torch.as_tensor(eye, dtype=f32, device=device)
    return eye_t[None, :].expand(dirs.shape), dirs


def axis_quotient(num, dirn, reciprocal=False):
    """num / dirn per axis (num · (1 / dirn) with `reciprocal`), bit for bit
    that expression, and its non-finite entries (a zero component of the
    direction, or an overflow) → (quotient, finite mask). Under autograd a
    non-finite entry sends exactly 0 to num and dirn: the quotient is taken
    again with 1 in place of those entries' divisor (a "double where").
    Dropping them with a single where would meet the division's own
    derivative there, 0·(b − o)/0² = NaN; 0 is the true gradient's limit,
    since an axis the ray never crosses sets no exit."""
    def quotient(d):
        return num * (1.0 / d) if reciprocal else num / d

    with torch.no_grad():
        raw = quotient(dirn)
    finite = torch.isfinite(raw)
    return torch.where(finite, quotient(torch.where(finite, dirn, 1.0)),
                       raw), finite


def ray_box_intersect(org, dirn, box_lo, box_hi, t_min=0.0, t_max=np.inf):
    """Slab-method ray/AABB intersection (reference raytracing.h:60-103).
    org, dirn [..., 3]. Returns (t0, t1, hit) with t0 <= t1 where hit;
    axis-parallel rays go through IEEE 1/0 = ±inf, and send 0 to the
    gradient on those axes (`axis_quotient`)."""
    dev = org.device
    lo, _ = axis_quotient(
        torch.as_tensor(box_lo, dtype=torch.float32, device=dev) - org, dirn,
        reciprocal=True)
    hi, _ = axis_quotient(
        torch.as_tensor(box_hi, dtype=torch.float32, device=dev) - org, dirn,
        reciprocal=True)
    near = torch.minimum(lo, hi)
    far = torch.maximum(lo, hi)
    # 0·inf → NaN when the origin sits ON a slab plane of a parallel axis:
    # the graze counts as inside, (-inf, +inf)
    nan = torch.isnan(near) | torch.isnan(far)
    near = torch.where(nan, -np.inf, near)
    far = torch.where(nan, np.inf, far)
    t0 = torch.clamp(near.amax(dim=-1), min=t_min)
    t1 = torch.clamp(far.amin(dim=-1), max=t_max)
    return t0, t1, t0 < t1


def world_to_object(p_world, dims):
    """World box [-dims/2, dims/2] → object space [0,1]³ (reference
    network.cu:569)."""
    d = torch.as_tensor(dims, dtype=torch.float32, device=p_world.device)
    return p_world / d + 0.5


def object_to_world(p_obj, dims):
    d = torch.as_tensor(dims, dtype=torch.float32, device=p_obj.device)
    return (p_obj - 0.5) * d
