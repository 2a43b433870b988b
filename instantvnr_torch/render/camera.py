"""Camera model (reference `renderer.cpp:87-96`; counterpart of
`instantvnr_tpu/render/camera.py`). Host-side: a camera is a frozen tuple
of floats, turned into tensors by the renderer each frame."""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from instantvnr_torch.config import CameraConfig
from instantvnr_torch.utils.math import normalize


@dataclass(frozen=True)
class Camera:
    eye: tuple[float, float, float]
    center: tuple[float, float, float]
    up: tuple[float, float, float]
    fovy: float = 60.0  # degrees

    @classmethod
    def from_config(cls, cfg: CameraConfig) -> "Camera":
        return cls(eye=tuple(cfg.eye), center=tuple(cfg.center),
                   up=tuple(cfg.up), fovy=cfg.fovy)

    @classmethod
    def default_for_dims(cls, dims) -> "Camera":
        """A default framing of the whole volume."""
        d = max(dims)
        return cls(eye=(0.0, 0.0, -2.2 * d), center=(0.0, 0.0, 0.0),
                   up=(0.0, 1.0, 0.0), fovy=45.0)

    @classmethod
    def from_scene(cls, path: str) -> "Camera":
        """vnrCreateCamera(scene json) (api.cpp:66-86): the camera section
        of a scene file (either dialect)."""
        from instantvnr_torch.config import load_scene_config

        return cls.from_config(load_scene_config(path).camera)

    # vnrCameraSet / vnrCameraGet{Position,Focus,UpVec} (api.h:120-125).
    # The dataclass is frozen, so set() returns the updated handle.
    def set(self, eye=None, center=None, up=None, fovy=None) -> "Camera":
        kw = {}
        if eye is not None:
            kw["eye"] = tuple(float(v) for v in eye)
        if center is not None:
            kw["center"] = tuple(float(v) for v in center)
        if up is not None:
            kw["up"] = tuple(float(v) for v in up)
        if fovy is not None:
            kw["fovy"] = float(fovy)
        return replace(self, **kw)

    @property
    def position(self):
        return self.eye

    @property
    def focus(self):
        return self.center

    @property
    def up_vec(self):
        return self.up


def camera_rays(cam: Camera, width: int, height: int,
                jitter: torch.Tensor | None = None, device="cpu"):
    """Per-pixel rays, reference parameterization (renderer.cpp:87-96):

        t  = 2·tan(fovy/2);  aspect = W/H
        horizontal = t·aspect · normalize(dir × up)
        vertical   = (horizontal × dir)/aspect          (magnitude t)
        ray = dir + (sx−.5)·horizontal + (sy−.5)·vertical,  s ∈ [0,1]²

    The camera's fields may be tuples or tensors (the renderers' camera
    arrays). Returns (origins [H·W,3], dirs [H·W,3] normalized), row-major
    with pixel (0,0) at the bottom left."""
    f32 = torch.float32

    def t(v):
        return torch.as_tensor(v, dtype=f32, device=device)

    eye = t(cam.eye)
    direction = normalize(t(cam.center) - eye)
    up = t(cam.up)
    tan = 2.0 * torch.tan(t(cam.fovy) * np.float32(np.pi) / 360.0)
    aspect = width / float(height)
    horizontal = tan * aspect * normalize(torch.linalg.cross(direction, up))
    vertical = torch.linalg.cross(horizontal, direction) / aspect
    yy, xx = torch.meshgrid(torch.arange(height, dtype=f32, device=device),
                            torch.arange(width, dtype=f32, device=device),
                            indexing="ij")
    px, py = xx.reshape(-1), yy.reshape(-1)
    if jitter is None:
        sx, sy = (px + 0.5) / width, (py + 0.5) / height
    else:
        sx, sy = (px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height
    dirs = (direction[None, :] + (sx - 0.5)[:, None] * horizontal[None, :]
            + (sy - 0.5)[:, None] * vertical[None, :])
    dirs = normalize(dirs)
    return eye[None, :].expand(dirs.shape), dirs
