"""Device resolution for the package's entry points.

Entry points run on the card unless the caller asks for the CPU: a request
for CUDA on a machine without it raises here instead of silently running
the plain versions on the CPU.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


@functools.lru_cache(maxsize=64)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant tensor on `device`, made once per process and never
    written to. Making it per call would copy from the host, and a copy to
    a CUDA device from pageable memory waits for the stream: the host could
    then no longer run ahead of the card."""
    return torch.tensor(values, dtype=dtype, device=device)
