"""The port's benchmark (counterpart of the repository's `bench.py`, reduced
to what the port runs): the interactive neural-volume pipeline at 512².

    python3 -m instantvnr_torch.bench              (one NVIDIA GPU)
    python3 -m instantvnr_torch.bench --device cpu --dims 16 --size 16 ...

Setup as bench.py's: the synthetic vorts volume at 128³, the reference
schema with its hash table capped at 2^14 a level (the bench schema),
512² frames from the bench camera. Stages, each warmed up before its timed
section:

- training at the bench schema: B = 2^16 samples a step, Msamples/s over
  the timed steps, then on to the 1000-step protocol point (the
  reference's batch_trainer.cpp:42) for PSNR and SSIM;
- training at the untouched reference schema (2^19): Msamples/s;
- the headline: a full decode of the trained network, then DECODED_SLAB
  frames of the decoded grid (decode + slab render, fps);
- gradient-shaded slab frames, ISOSURFACE_DECODED frames, the exact
  neural wavefront (NEURAL_WAVEFRONT, streaming_cache="none") with its
  supersteps a frame, the brick wavefront (NEURAL_WAVEFRONT on the default
  streaming_cache="auto" pool) and the path tracer (PATHTRACE_DECODED,
  progressive frames) with its events a frame. These three run the
  compacted path (render/compaction.py), as the facade does: its bucket
  family is warmed first (`warmup()`: on the card, their CUDA graphs) and
  COMPACT_WARM frames record, replay and fuse the schedule before the
  timed frames.

Prints ONE JSON line, {"metric", "value", "unit", "secondary", "device"},
with the card's name and power limit (nvidia-smi). A stage that fails ends
the run with a non-zero exit and no line. Timings from `--device cpu` are
the CPU's and name it; the device numbers come only from a GPU run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

METRIC = "neural decode+slab-render fps @ 512x512 (hash 2^14)"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


# untimed frames of a compacted renderer: one serialized, two replayed
# (the second captures the whole frame), one fused
COMPACT_WARM = 4


def _time_compacted(r, device, frames: int) -> float:
    """fps of a compacted renderer: its warmup, COMPACT_WARM frames, then
    `frames` timed ones."""
    r._impl.warmup()
    return _time_frames(r, device, frames, warm=COMPACT_WARM)


def _time_frames(r, device, frames: int, warm: int) -> float:
    """fps of `frames` renders after `warm` untimed ones (the frames are
    queued, one synchronize at the end)."""
    for _ in range(warm):
        r.render()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(frames):
        r.render()
    _sync(device)
    return frames / (time.perf_counter() - t0)


def _train_msps(nv, device, steps: int, warm: int) -> float:
    nv.train(warm, fast_mode=True)
    _sync(device)
    t0 = time.perf_counter()
    nv.train(steps, fast_mode=True)
    _sync(device)
    return steps * nv.train_batch / (time.perf_counter() - t0) / 1e6


def device_info(device) -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    if device != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power = (v.strip() for v in out.split(",", 1))
    return {"platform": "gpu", "name": name, "power_limit": power}


def run(args) -> dict:
    import torch

    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.render.camera import Camera

    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available")
    info = device_info(dev)
    log(f"device: {info}")
    dims = (args.dims,) * 3
    size = args.size
    sv = api.SimpleVolume.synthetic(dims, "vorts", device=dev)
    cfg = ModelConfig()
    cfg14 = dataclasses.replace(cfg, encoding=dataclasses.replace(
        cfg.encoding, log2_hashmap_size=14))
    cam = Camera(eye=(0.15 * dims[0], 0.1 * dims[1], -2.0 * dims[2]),
                 center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), fovy=45.0)
    sec = {}

    # training at the bench schema, then on to the protocol point
    nv = api.NeuralVolume(cfg14, sv, seed=args.seed, device=dev,
                          train_batch=args.batch)
    sec["train_msamples_per_s_hash14"] = _train_msps(
        nv, dev, args.train_steps, args.train_warmup)
    rest = args.protocol_steps - nv.step
    if rest > 0:
        nv.train(rest, fast_mode=True)
    sec["psnr_db"] = nv.get_psnr()
    sec["ssim"] = nv.get_mssim()
    log(f"train 2^14: {sec['train_msamples_per_s_hash14']} Msamples/s; "
        f"PSNR {sec['psnr_db']} dB, SSIM {sec['ssim']} at step {nv.step}")

    # the untouched reference schema
    nv19 = api.NeuralVolume(cfg, sv, seed=args.seed, device=dev,
                            train_batch=args.batch)
    sec["train_msamples_per_s_hash19_ref_schema"] = _train_msps(
        nv19, dev, args.steps_19, args.train_warmup_19)
    del nv19
    log(f"train 2^19: {sec['train_msamples_per_s_hash19_ref_schema']} "
        "Msamples/s")

    # headline: full decode, then DECODED_SLAB frames of the grid
    _sync(dev)
    t0 = time.perf_counter()
    nv.ensure_decoded(size, size)
    _sync(dev)
    sec["decode_ms"] = (time.perf_counter() - t0) * 1e3
    r = api.VNRenderer(nv, size, size, api.RenderMode.DECODED_SLAB)
    r.set_camera(cam)
    fps = _time_frames(r, dev, args.frames, warm=5)
    r.set_slab_shading("gradient")
    sec["slab_fps_512_shaded"] = _time_frames(r, dev, args.frames // 2,
                                              warm=3)
    r.set_slab_shading("none")
    log(f"slab {size}²: {fps} fps, shaded "
        f"{sec['slab_fps_512_shaded']} fps; decode {sec['decode_ms']} ms")

    ri = api.VNRenderer(nv, size, size, api.RenderMode.ISOSURFACE_DECODED)
    ri.set_camera(cam)
    sec["isosurface_fps_512"] = _time_frames(ri, dev, args.frames // 2,
                                             warm=3)
    log(f"isosurface {size}²: {sec['isosurface_fps_512']} fps")

    rw = api.VNRenderer(nv, size, size, api.RenderMode.NEURAL_WAVEFRONT,
                        streaming_cache="none")
    rw.set_camera(cam)
    sec["neural_wavefront_fps_512"] = _time_compacted(
        rw, dev, args.wavefront_frames)
    sec["neural_wavefront_supersteps"] = rw.last_stats["supersteps"]
    log(f"exact neural wavefront {size}²: "
        f"{sec['neural_wavefront_fps_512']} fps, "
        f"{sec['neural_wavefront_supersteps']} supersteps a frame")
    frame = rw.mapframe()
    if not (frame == frame).all() or frame[..., 3].max() <= 0.0:
        raise AssertionError("the neural wavefront frame is empty or NaN")

    rb = api.VNRenderer(nv, size, size, api.RenderMode.NEURAL_WAVEFRONT)
    rb.set_camera(cam)
    sec["brick_wavefront_fps_512"] = _time_compacted(
        rb, dev, args.wavefront_frames)
    log(f"brick wavefront {size}²: {sec['brick_wavefront_fps_512']} fps "
        f"({rb.streaming_cache_info})")
    rp = api.VNRenderer(nv, size, size, api.RenderMode.PATHTRACE_DECODED)
    rp.set_camera(cam)
    sec["pathtrace_fps_512"] = _time_compacted(rp, dev,
                                               args.wavefront_frames)
    sec["pathtrace_events"] = rp.last_stats["events"]
    log(f"path tracer {size}²: {sec['pathtrace_fps_512']} fps, "
        f"{sec['pathtrace_events']} events a frame")
    for name, r_ in (("brick wavefront", rb), ("path tracer", rp)):
        frame = r_.mapframe()
        if not (frame == frame).all() or frame[..., 3].max() <= 0.0:
            raise AssertionError(f"the {name} frame is empty or NaN")
    return {"metric": METRIC if (size, args.dims) == (512, 128) else
            f"neural decode+slab-render fps @ {size}x{size} (hash 2^14, "
            f"vorts {args.dims}^3)",
            "value": fps, "unit": "fps", "secondary": sec, "device": info}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dims", type=int, default=128)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=1 << 16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-warmup", type=int, default=50)
    p.add_argument("--train-steps", type=int, default=100)
    p.add_argument("--protocol-steps", type=int, default=1000)
    p.add_argument("--train-warmup-19", type=int, default=5)
    p.add_argument("--steps-19", type=int, default=20)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--wavefront-frames", type=int, default=3)
    line = run(p.parse_args(argv))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
