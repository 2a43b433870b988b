"""Shared CLI helpers of the port's apps (counterpart of `apps/common.py`;
the reference's `apps/cmdline.h`).

Every app takes `--device` (default `cuda`; `cpu` runs the plain PyTorch
versions), in place of the JAX package's INSTANTVNR_CPU. PNG frames are
written with zlib and struct alone, so no imaging package is needed.
"""
from __future__ import annotations

import argparse
import struct
import sys
import zlib

import numpy as np

# the grid synthetics and the analytic fields at the decode lattice
# (data/volume.py::synthetic_array, data/procedural.py)
SYNTHETIC_KINDS = ("vorts", "sphere", "noise", "tubes", "wavelet", "xyz",
                   "marschner-lobb")


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (cpu: the plain PyTorch versions)")


def add_volume_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("volume")
    g.add_argument("--scene", help="scene JSON (diva or vidi dialect)")
    g.add_argument("--synthetic", choices=SYNTHETIC_KINDS,
                   help="procedural volume instead of a scene file (with "
                   "--sampling-mode analytic, the analytic field trained "
                   "with no volume)")
    g.add_argument("--dims", type=int, nargs="+", default=[64],
                   help="synthetic volume dims (1 or 3 ints)")
    g.add_argument("--volume",
                   help=".vdb volume file (an OpenVDB FloatGrid, the "
                   "reference's OpenVKL VDB source; data/vdb.py)")
    g.add_argument("--vdb-grid", default=None,
                   help="grid name inside the .vdb (default: the only grid, "
                   "or 'density')")


def add_model_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("model")
    g.add_argument("--model", default=None,
                   help="model JSON (tcnn schema); default = reference schema")
    g.add_argument("--max-num-steps", type=int, default=1000,
                   help="training steps (batch_trainer.cpp:42 default)")
    g.add_argument("--batch", type=int, default=1 << 16)
    g.add_argument("--seed", type=int, default=0)


def volume_dims(args) -> tuple:
    d = args.dims
    return tuple(d * 3) if len(d) == 1 else tuple(d)


def check_volume_arg(args):
    """--volume reads .vdb files only (raw volumes come through a scene
    JSON, which gives their dims and type)."""
    vol = getattr(args, "volume", None)
    if vol and not vol.endswith(".vdb"):
        raise SystemExit(f"--volume {vol}: only .vdb files are read here "
                         "(raw volumes need a scene JSON for dims and type)")


def load_simple_volume(args):
    """The SimpleVolume the arguments name: --volume x.vdb, else --scene,
    else --synthetic (default vorts)."""
    from instantvnr_torch.api import SimpleVolume

    check_volume_arg(args)
    if getattr(args, "volume", None):
        from instantvnr_torch.data.vdb import vdb_to_volume

        return SimpleVolume(vdb_to_volume(args.volume, args.vdb_grid,
                                          device=args.device),
                            device=args.device)
    if args.scene:
        return SimpleVolume(args.scene, device=args.device)
    return SimpleVolume.synthetic(dims=volume_dims(args),
                                  kind=args.synthetic or "vorts",
                                  device=args.device)


def load_model_config(args):
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.config import load_model_config as load

    return load(args.model) if args.model else ModelConfig()


def interactive_model_config(args):
    """The interactive apps' model: the --model file, else the reference
    schema with its hash table capped at 2^14, the JAX package's
    interactive default (apps/vnr_int_online.py:51-61), so that the two
    packages' apps train the same model."""
    import dataclasses

    cfg = load_model_config(args)
    if not args.model:
        cfg = dataclasses.replace(cfg, encoding=dataclasses.replace(
            cfg.encoding, log2_hashmap_size=14))
        # on stderr: the viewer's first line of stdout names its address
        print("[vnr] interactive default: hash table capped at 2^14, the "
              "JAX package's default (pass --model for the exact "
              "reference schema)", file=sys.stderr)
    return cfg


def device_name(device) -> str:
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def framebuffer_to_u8(rgba) -> np.ndarray:
    """rgba [H, W, 4] float framebuffer → uint8 image (flipped to image
    convention: the framebuffer's row 0 is the bottom scanline)."""
    return (np.clip(np.asarray(rgba)[::-1], 0, 1) * 255).astype(np.uint8)


def png_bytes(img: np.ndarray) -> bytes:
    """uint8 [H, W, C] (C = 3 or 4) → a PNG file's bytes: 8-bit RGB(A),
    every scanline filter 0, one zlib stream."""
    h, w, c = img.shape
    color = {3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(rgba, path: str):
    """rgba [H, W, 4] float framebuffer → PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(framebuffer_to_u8(rgba)))


class CsvLogger:
    """vidi::CsvLogger analog (training curves, frame timings)."""

    def __init__(self, path: str | None, header: list[str]):
        self.f = open(path, "w") if path else None
        if self.f:
            self.f.write(",".join(header) + "\n")

    def log(self, *values):
        if self.f:
            self.f.write(",".join(str(v) for v in values) + "\n")
            self.f.flush()

    def close(self):
        if self.f:
            self.f.close()


def sync(device):
    """Wait for the device's queued work (a host clock around it then
    measures the work, not its enqueue)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
