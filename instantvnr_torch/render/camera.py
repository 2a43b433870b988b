"""Camera model (reference `renderer.cpp:87-96`; counterpart of
`instantvnr_tpu/render/camera.py`). Host-side: a camera is a frozen tuple
of floats, turned into tensors by the renderer each frame."""
from __future__ import annotations

from dataclasses import dataclass

from instantvnr_torch.config import CameraConfig


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
