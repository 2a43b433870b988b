"""Headless render benchmark, the port's `vnr_cmd_render` (counterpart of
`apps/vnr_cmd_render.py`; the reference's apps/batch_renderer.cpp): warm-up
frames, N timed frames, a per-frame fps CSV, a PNG of the last frame.

    python -m instantvnr_torch.apps.vnr_cmd_render --load params.bson \\
        --size 512 --num-frames 20 --output frame.png --fps-log fps.csv

The neural wavefront modes take `--streaming-cache` (default "auto", a
brick pool; "none" is exact per-sample network evaluation); `pathtrace`,
`pathtrace-neural` and `pathtrace-reference` run the path tracer on the
decoded grid (the ground truth without a checkpoint), the network and the
ground truth. `--scene s.json --timestep k` renders a scene's timestep,
from the scene's camera unless `--camera` is given. `--profile DIR` traces
the timed frames with torch.profiler into `DIR/trace.json` (a Chrome
trace; utils/profiling.py::trace).
"""
from __future__ import annotations

import argparse
import contextlib
import math
import time

from instantvnr_torch.apps.common import (
    CsvLogger,
    add_device_arg,
    add_volume_args,
    device_name,
    load_simple_volume,
    save_png,
    sync,
)

_MODES = ("decoded", "neural", "reference", "gradient", "ssh", "pathtrace",
          "pathtrace-neural", "pathtrace-reference", "isosurface",
          "isosurface-reference")


def render_mode(name: str, neural: bool):
    """The RenderMode a --mode name selects (neural: a checkpoint is
    loaded, so gradient/ssh/isosurface render the network)."""
    from instantvnr_torch.api import RenderMode

    return {
        "decoded": RenderMode.DECODED_SLAB,
        "neural": RenderMode.NEURAL_WAVEFRONT,
        "reference": RenderMode.REFERENCE_RAYMARCH,
        "gradient": (RenderMode.NEURAL_WAVEFRONT_GRADIENT if neural
                     else RenderMode.REFERENCE_GRADIENT),
        "ssh": (RenderMode.NEURAL_WAVEFRONT_SSH if neural
                else RenderMode.REFERENCE_SSH),
        "isosurface": (RenderMode.ISOSURFACE_DECODED if neural
                       else RenderMode.ISOSURFACE_REFERENCE),
        "isosurface-reference": RenderMode.ISOSURFACE_REFERENCE,
        "pathtrace": (RenderMode.PATHTRACE_DECODED if neural
                      else RenderMode.PATHTRACE_REFERENCE),
        "pathtrace-neural": RenderMode.PATHTRACE_NEURAL,
        "pathtrace-reference": RenderMode.PATHTRACE_REFERENCE,
    }[name]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_volume_args(p)
    add_device_arg(p)
    p.add_argument("--load", help="checkpoint (renders without a ground "
                   "truth when no volume is given)")
    p.add_argument("--mode", default="decoded", choices=_MODES,
                   help="render mode (the reference's api.h:36-60 matrix)")
    p.add_argument("--size", type=int, default=768,
                   help="frame size (batch_renderer.cpp:199 default 768²)")
    p.add_argument("--num-frames", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--sampling-rate", type=float, default=1.0,
                   help="vnrRendererSetVolumeSamplingRate")
    p.add_argument("--density-scale", type=float, default=1.0,
                   help="vnrRendererSetVolumeDensityScale")
    p.add_argument("--streaming-cache", default="auto",
                   choices=["auto", "brick", "hq", "lazy", "none"],
                   help="sample-streaming policy of the neural wavefront "
                   "modes: a brick pool (auto, brick, hq, lazy) or exact "
                   "per-sample evaluation (none)")
    p.add_argument("--denoise", action="store_true",
                   help="à-trous denoiser at mapframe (vnrRendererSetDenoiser)")
    p.add_argument("--shadows", action="store_true",
                   help="shadow volume on the decoded path")
    p.add_argument("--slab-shading", default="none",
                   choices=["none", "gradient"],
                   help="shading of the decoded slab path")
    p.add_argument("--output", default="frame.png")
    p.add_argument("--fps-log", help="per-frame fps CSV")
    p.add_argument("--camera", type=float, nargs=3, default=None,
                   help="eye position (default: auto-framed)")
    p.add_argument("--isovalue", type=float, default=0.5,
                   help="isovalue of the isosurface modes")
    p.add_argument("--timestep", type=int, default=0,
                   help="time-series volumes: render this timestep "
                   "(vnrSimpleVolumeSetCurrentTimeStep, api.h:118)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="trace the timed frames into DIR/trace.json (a "
                   "Chrome trace of torch.profiler, utils/profiling.trace)")
    p.add_argument("--orbit", action="store_true",
                   help="rotate the camera one full orbit over the timed "
                   "frames (a camera rebind a frame)")
    args = p.parse_args(argv)

    from instantvnr_torch.api import NeuralVolume, RenderMode, VNRenderer
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.utils.profiling import trace

    simple = None
    if args.scene or args.synthetic or args.volume:
        simple = load_simple_volume(args)
    if args.load:
        nv = NeuralVolume.from_checkpoint(args.load, simple=simple,
                                          device=args.device)
        subject, dims = nv, nv.dims
    else:
        if simple is None:
            raise SystemExit("--load or a volume source is required")
        subject, dims = simple, simple.dims
    mode = render_mode(args.mode, args.load is not None)
    if args.timestep and simple is not None:
        print(f"[vnr] timestep {args.timestep}/{simple.num_timesteps}")
        simple.set_current_timestep(args.timestep)

    r = VNRenderer(subject, width=args.size, height=args.size, mode=mode,
                   streaming_cache=args.streaming_cache)
    if args.sampling_rate != 1.0:
        r.set_volume_sampling_rate(args.sampling_rate)
    if args.density_scale != 1.0:
        r.set_volume_density_scale(args.density_scale)
    r.set_denoiser(args.denoise)
    if args.isovalue != 0.5:
        r.set_isovalue(args.isovalue)
    if mode == RenderMode.DECODED_SLAB:
        if args.slab_shading != "none":
            r.set_slab_shading(args.slab_shading)
        if args.shadows:
            r.enable_shadows()
    center0, up0, fovy0 = (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0
    d = max(dims)
    if args.camera:
        eye0 = tuple(args.camera)
    elif simple is None or simple.camera_cfg is None:
        eye0 = (0.15 * d, 0.1 * d, -2.0 * d)
    else:  # the scene's camera
        c = simple.camera_cfg
        eye0, center0, up0, fovy0 = (tuple(c.eye), tuple(c.center),
                                     tuple(c.up), c.fovy)
    r.set_camera(Camera(eye=eye0, center=center0, up=up0, fovy=fovy0))

    def orbit_camera(i: int) -> Camera:
        """The camera rotated about +y through the centre by
        2πi/num_frames."""
        a = 2.0 * math.pi * i / max(args.num_frames, 1)
        x, y, z = (eye0[k] - center0[k] for k in range(3))
        eye = (center0[0] + x * math.cos(a) + z * math.sin(a),
               center0[1] + y,
               center0[2] - x * math.sin(a) + z * math.cos(a))
        return Camera(eye=eye, center=center0, up=up0, fovy=fovy0)

    print(f"[vnr] mode {args.mode} ({mode.name}), {args.size}x{args.size}, "
          f"device {device_name(args.device)}")
    for _ in range(args.warmup):
        r.render()
    sync(args.device)
    logger = CsvLogger(args.fps_log, ["frame", "fps", "supersteps"])
    t_total = 0.0
    prof = trace(args.profile) if args.profile else contextlib.nullcontext()
    with prof as trace_path:
        for i in range(args.num_frames):
            t0 = time.time()
            if args.orbit:
                r.set_camera(orbit_camera(i))
            r.render()
            sync(args.device)
            dt = time.time() - t0
            t_total += dt
            logger.log(i, 1.0 / dt, r.last_stats.get("supersteps", ""))
    logger.close()
    if args.profile:
        print(f"[vnr] trace written to {trace_path}")
    if args.num_frames:
        print(f"[vnr] {args.num_frames / t_total:.2f} fps average over "
              f"{args.num_frames} frames")
    frame = r.mapframe()
    if args.output:
        save_png(frame, args.output)
        print(f"[vnr] saved {args.output}")
    return frame


if __name__ == "__main__":
    main()
