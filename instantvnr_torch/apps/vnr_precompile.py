"""Build the kernels ahead of the first frame: the port's analog of
`apps/vnr_precompile.py`.

The JAX package's cold start is XLA compilation, which its vnr_precompile
moves into a persistent compile cache. The port's cold start is instead
the `nvcc` build of `instantvnr_torch/csrc/*.cu` into
`instantvnr_torch/_build/` (kept across processes, keyed by a hash of the
sources) and, in every process, the first launches' set-up on the card
(the CUDA context, loading the library's modules, PyTorch's allocator).
This app runs the build, so that the next process (the viewer,
vnr_cmd_render, the bench) loads the library instead of building it. The
compacted wavefront and path tracer have a second set-up in each process:
their bucket family (render/compaction.py), which `warmup()` runs once
ahead of the first frame and which on the card captures its CUDA graphs
(JAX's warmup_programs).

    python -m instantvnr_torch.apps.vnr_precompile
    python -m instantvnr_torch.apps.vnr_precompile --report --dims 128

`--report` then times each selected mode's set-up (the renderer and, for
the compacted modes, the warmed bucket family) and first frame against
its second, on the card. On the CPU (`--device cpu`)
there is nothing to build: the plain PyTorch versions run there.
"""
from __future__ import annotations

import argparse
import sys
import time

from instantvnr_torch.apps.common import (
    add_device_arg,
    add_model_args,
    add_volume_args,
    device_name,
    load_model_config,
    load_simple_volume,
)

MODES = ("slab", "wavefront", "wavefront_exact", "pathtrace",
         "pathtrace_neural", "isosurface", "reference")


def log(*a):
    print("[precompile]", *a, file=sys.stderr, flush=True)


def report(size: int, simple, model_cfg, modes) -> dict:
    """Each mode's set-up (the renderer and its warmup), first frame and
    second, in seconds, each frame ending in its copy to the host."""
    from instantvnr_torch.api import NeuralVolume, RenderMode, VNRenderer

    mode_map = {"slab": RenderMode.DECODED_SLAB,
                "wavefront": RenderMode.NEURAL_WAVEFRONT,
                "wavefront_exact": RenderMode.NEURAL_WAVEFRONT,
                "pathtrace": RenderMode.PATHTRACE_DECODED,
                "pathtrace_neural": RenderMode.PATHTRACE_NEURAL,
                "isosurface": RenderMode.ISOSURFACE_DECODED,
                "reference": RenderMode.REFERENCE_RAYMARCH}
    nv = NeuralVolume(model_cfg, simple=simple, train_batch=1 << 14,
                      device=simple.device)
    nv.train(1)
    times = {}
    for name in modes:
        mode = mode_map[name]
        t0 = time.perf_counter()
        r = VNRenderer(simple if mode == RenderMode.REFERENCE_RAYMARCH
                       else nv, width=size, height=size, mode=mode,
                       streaming_cache=("none" if name == "wavefront_exact"
                                        else "auto"))
        impl = r._impl
        if getattr(getattr(impl, "settings", None), "compact", False):
            impl.warmup()  # the bucket family (on the card, its graphs)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        r.render()
        r.mapframe()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        r.render()
        r.mapframe()
        second = time.perf_counter() - t0
        times[name] = {"setup_s": setup, "first_s": first,
                       "second_s": second}
        log(f"{name}: set-up {setup:.3f} s, first frame {first:.3f} s, "
            f"second {second:.3f} s")
        del r
    return times


def main(argv=None):
    """→ {"build_s": ..., "library": ..., "report": {mode: times}} (empty
    on the CPU)."""
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_volume_args(p)
    add_model_args(p)
    add_device_arg(p)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--modes", nargs="+", default=["all"],
                   choices=("all",) + MODES,
                   help="the modes --report times (default: all)")
    p.add_argument("--report", action="store_true",
                   help="after the build, time each mode's first frame "
                   "against its second")
    args = p.parse_args(argv)

    from instantvnr_torch.utils.device import resolve_device

    if resolve_device(args.device).type == "cpu":
        log("--device cpu: nothing to build (the CPU runs the plain "
            "PyTorch versions)")
        return {}
    from instantvnr_torch.ops.cuda_lib import load_library

    t0 = time.perf_counter()
    lib = load_library()
    out = {"build_s": lib.build_seconds, "library": lib.path,
           "device": device_name(args.device)}
    log(f"library {lib.path}: "
        + (f"built in {lib.build_seconds:.1f} s" if lib.build_seconds
           else "already built")
        + f" ({time.perf_counter() - t0:.1f} s to load)")
    if args.report:
        modes = list(MODES) if args.modes == ["all"] else args.modes
        out["report"] = report(args.size, load_simple_volume(args),
                               load_model_config(args), modes)
    return out


if __name__ == "__main__":
    main()
