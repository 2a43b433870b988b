"""Small vector helpers (counterpart of `instantvnr_tpu/utils/math.py`)."""
from __future__ import annotations

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
