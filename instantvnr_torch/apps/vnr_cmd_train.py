"""Headless training, the port's `vnr_cmd_train` (counterpart of
`apps/vnr_cmd_train.py`; the reference's apps/batch_trainer.cpp): train N
steps in chunks with loss logging and restart-on-bad-loss, report PSNR and
SSIM, write a checkpoint.

    python -m instantvnr_torch.apps.vnr_cmd_train --synthetic vorts \\
        --dims 64 --max-num-steps 1000 --save params.bson --report-psnr

`--save x.npz` writes the native exact-resume checkpoint (the whole
training state) and `--resume x.npz` continues from one, a file of the JAX
package's included. `--scene s.json` trains on a raw volume (`--timestep
k` of a time series); `--sampling-mode out-of-core` streams the scene's
file through the native block loader instead of loading it, and
`--sampling-mode analytic` trains on the `--synthetic` field itself (vorts
means its analytic twin, tubes) with no volume anywhere. `--volume x.vdb`
(`--vdb-grid name`) trains on an OpenVDB grid, in core or, out of core,
from a raw sidecar densified once next to the file.
"""
from __future__ import annotations

import argparse
import math
import time

from instantvnr_torch.apps.common import (
    CsvLogger,
    add_device_arg,
    add_model_args,
    add_volume_args,
    check_volume_arg,
    load_model_config,
    load_simple_volume,
    sync,
    volume_dims,
)


def vdb_sidecar(path: str, grid: str | None):
    """The raw float32 sidecar of a .vdb grid that the native loader
    streams (it reads contiguous rows, which a sparse tree has not),
    densified once next to the file, and its VolumeDesc. The sidecar's
    name holds the grid's name and the .vdb's size and mtime, so a rewrite
    of the .vdb, or another grid of it, never reuses a stale sidecar (the
    JAX package keys it on the size alone, ROADMAP Queue 3)."""
    import os

    import numpy as np

    from instantvnr_torch.config import VolumeDesc
    from instantvnr_torch.data.vdb import read_vdb

    st = os.stat(path)
    dense, info = read_vdb(path, grid)
    sidecar = f"{path}.{info.name}.{st.st_size}.{st.st_mtime_ns}.raw"
    dz, dy, dx = dense.shape
    if not (os.path.exists(sidecar)
            and os.path.getsize(sidecar) == dense.nbytes):
        with open(sidecar + ".tmp", "wb") as f:
            dense.astype(np.float32).tofile(f)
        os.replace(sidecar + ".tmp", sidecar)
        print(f"[vnr] densified {path} -> {sidecar}")
    return VolumeDesc(filename=sidecar, dims=(dx, dy, dz), dtype="FLOAT",
                      value_range=(float(dense.min()), float(dense.max())))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_volume_args(p)
    add_model_args(p)
    add_device_arg(p)
    p.add_argument("--save", default="params.bson",
                   help="output checkpoint: BSON (the reference format) or "
                   ".npz (the native exact-resume checkpoint)")
    p.add_argument("--resume", help="native .npz checkpoint to resume from "
                   "(batch_trainer.cpp:38-39 --resume)")
    p.add_argument("--report-psnr", action="store_true",
                   help="final PSNR/SSIM (batch_trainer.cpp:123-132)")
    p.add_argument("--log", help="CSV training curve (step, loss, time_s)")
    p.add_argument("--chunk", type=int, default=10,
                   help="steps per chunk (batch_trainer.cpp:97)")
    p.add_argument("--timestep", type=int, default=0,
                   help="time-series volumes: train on this timestep")
    p.add_argument("--sampling-mode", default="gpu",
                   choices=["gpu", "out-of-core", "analytic"],
                   help="gpu: the volume on the device; out-of-core: the "
                   "scene's raw file streamed in blocks; analytic: the "
                   "--synthetic field, no volume (the reference's "
                   "Sampler::load modes)")
    args = p.parse_args(argv)

    import torch

    from instantvnr_torch.api import NeuralVolume

    cfg = load_model_config(args)
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    simple = analytic = oc_sampler = None
    if args.sampling_mode == "analytic":
        from instantvnr_torch.data.procedural import AnalyticSampler

        kind = args.synthetic or "wavelet"
        kind = {"vorts": "tubes"}.get(kind, kind)
        analytic = AnalyticSampler.create(kind, seed=args.seed)
        dims = volume_dims(args)
        print(f"[vnr] analytic field '{kind}' (no volume), device {name}")
    elif args.sampling_mode == "out-of-core":
        from instantvnr_torch.config import load_scene_config
        from instantvnr_torch.data.outofcore import OutOfCoreSampler

        check_volume_arg(args)
        if args.volume:
            desc = vdb_sidecar(args.volume, args.vdb_grid)
        elif args.scene:
            desc = load_scene_config(args.scene).volume.at_timestep(
                args.timestep)
        else:
            raise SystemExit("out-of-core training reads a scene's raw file "
                             "(--scene) or a .vdb (--volume)")
        dims = desc.dims
        print(f"[vnr] volume {dims} (out-of-core, {desc.n_bytes / 1e9:.3f} "
              f"GB), device {name}")
        if desc.value_range is None:
            print("[vnr] scanning the value range (no 'range' in the "
                  "scene)...")
        oc_sampler = OutOfCoreSampler(desc)
        lo, hi = oc_sampler.value_range
        print(f"[vnr] unnormalized range {lo:g} {hi:g}; "
              f"{'native' if oc_sampler.is_native else 'numpy'} loader")
    else:
        simple = load_simple_volume(args)
        if args.timestep:
            simple.set_current_timestep(args.timestep)
            print(f"[vnr] timestep {args.timestep}/{simple.num_timesteps}")
        dims = simple.dims
        print(f"[vnr] volume {dims}, device {name}")
    if args.resume:
        if not args.resume.endswith(".npz"):
            raise SystemExit("--resume reads native .npz checkpoints")
        nv = NeuralVolume.from_checkpoint(args.resume, simple=simple,
                                          device=args.device)
        nv.train_batch = args.batch
        print(f"[vnr] resumed from {args.resume} at step {nv.step}")
    else:
        nv = NeuralVolume(cfg, simple=simple, dims=dims, seed=args.seed,
                          device=args.device, train_batch=args.batch)
    spec = nv.field.spec
    print(f"[vnr] model: {nv.field.n_params} params ({spec.n_levels} levels "
          f"× {spec.n_features} features"
          f"{', paired hash' if spec.paired else ''})")

    from instantvnr_torch.models.trainer import (train_out_of_core,
                                                 train_steps_source)

    source, run = ((analytic, train_steps_source) if analytic is not None
                   else (oc_sampler, train_out_of_core))

    def train_chunk(n):
        if source is None:
            return nv.train(n, fast_mode=False)
        nv.state = run(nv.field, source, nv.state, n, args.batch)
        nv.step += n
        return nv.statistics()

    logger = CsvLogger(args.log, ["step", "loss", "time_s"])
    t_start = time.time()
    prev_loss = float("inf")
    step = nv.step
    try:
        while step < args.max_num_steps:
            n = min(args.chunk, args.max_num_steps - step)
            t0 = time.time()
            stats = train_chunk(n)
            sync(args.device)
            dt = time.time() - t0
            step = stats.step
            # restart-on-bad-loss heuristic (batch_trainer.cpp:114-118)
            if not math.isfinite(stats.loss) or (
                    step > 100 and stats.loss > 10.0 * max(prev_loss, 1e-6)):
                print(f"[vnr] step {step}: bad loss {stats.loss:.5f}; "
                      "restarting the network")
                nv = NeuralVolume(cfg, simple=simple, dims=dims,
                                  seed=args.seed + step, device=args.device,
                                  train_batch=args.batch)
                step = 0
                prev_loss = float("inf")
                continue
            prev_loss = stats.loss
            print(f"[vnr] step {step:6d}  loss {stats.loss:.6f}  "
                  f"({n / dt:.1f} steps/s)")
            logger.log(step, stats.loss, time.time() - t_start)
    finally:
        logger.close()
        if oc_sampler is not None:
            oc_sampler.close()
    print(f"[vnr] total training time: {time.time() - t_start:.1f}s")
    if args.report_psnr and simple is not None:
        print(f"[vnr] PSNR: {nv.get_psnr():.2f} dB")
        print(f"[vnr] SSIM: {nv.get_mssim():.4f}")
    elif args.report_psnr and analytic is not None:
        # against the analytic field at the decode lattice
        from instantvnr_torch.models.metrics import psnr_vs

        gt = analytic.lattice_grid(dims, device=args.device)
        print(f"[vnr] PSNR vs the analytic field: "
              f"{float(psnr_vs(nv.field, nv.params, gt)):.2f} dB")
    if args.save:
        nv.save_params(args.save)
        print(f"[vnr] saved checkpoint: {args.save}")
    return nv


if __name__ == "__main__":
    main()
