"""Shading of the reference's scivis model (counterpart of the shading part
of `instantvnr_tpu/render/raymarch.py`).

Only `_shade_scivis` and the default directional light are ported here: the
slab renderers (render/slabmarch.py, render/isosurf.py) shade with them. The
masked-wavefront marcher itself is ROADMAP "Next slices" item 3.
"""
from __future__ import annotations

import torch

# default directional light (RaymarchSettings.light_dir,
# instantvnr_types.h:148); it points toward the light
DEFAULT_LIGHT = (0.7, 0.9, 0.4)


def _shade_scivis(ray_dir, normal, albedo, light_dir=(-1.0, 0.0, 0.0),
                  light_diffuse=(1.0, 1.0, 1.0), mat_ambient=0.6,
                  mat_diffuse=0.9, mat_specular=0.4, mat_shininess=40.0):
    """shade_scivis_light (raytracing.h:224-246) blended 50/50 with the
    simple headlight (shade_simple_light, :215-222) as the reference does.
    ray_dir, normal [..., 3]; albedo [..., 3]; light_dir a [3] tensor or a
    tuple."""
    dev = normal.device
    nn = torch.sum(normal * normal, dim=-1, keepdim=True)
    has_n = nn > 1e-6
    n = normal / torch.sqrt(torch.clamp(nn, min=1e-20))
    l = torch.as_tensor(light_dir, dtype=torch.float32, device=dev)
    l = l / torch.linalg.vector_norm(l)
    v = -ray_dir
    cos_nl = torch.clamp(torch.sum(n * l, dim=-1, keepdim=True), min=0.0)
    h = l + v
    h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                        min=1e-20)
    cos_nh = torch.clamp(torch.sum(n * h, dim=-1, keepdim=True), min=0.0)
    diffuse = torch.as_tensor(light_diffuse, dtype=torch.float32, device=dev)
    color = mat_ambient * albedo
    color = color + torch.where(
        cos_nl > 0,
        mat_diffuse * cos_nl * albedo * diffuse
        + mat_specular * torch.pow(cos_nh, mat_shininess) * diffuse,
        torch.zeros_like(color))
    color = torch.where(has_n, color, torch.zeros_like(color))
    # shade_simple_light
    cos_vn = torch.abs(torch.sum(-ray_dir * n, dim=-1, keepdim=True))
    simple = torch.where(has_n, albedo * (0.2 + 0.8 * cos_vn),
                         torch.zeros_like(color))
    return 0.5 * simple + 0.5 * color
