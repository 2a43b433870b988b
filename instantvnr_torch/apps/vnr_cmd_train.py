"""Headless training, the port's `vnr_cmd_train` (counterpart of
`apps/vnr_cmd_train.py`; the reference's apps/batch_trainer.cpp): train N
steps in chunks with loss logging and restart-on-bad-loss, report PSNR and
SSIM, write a checkpoint.

    python -m instantvnr_torch.apps.vnr_cmd_train --synthetic vorts \\
        --dims 64 --max-num-steps 1000 --save params.bson --report-psnr

`--save x.npz` writes the native exact-resume checkpoint (the whole
training state) and `--resume x.npz` continues from one, a file of the JAX
package's included.
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
    load_model_config,
    load_simple_volume,
    sync,
)


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
    args = p.parse_args(argv)

    import torch

    from instantvnr_torch.api import NeuralVolume

    cfg = load_model_config(args)
    simple = load_simple_volume(args)
    dims = simple.dims
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    print(f"[vnr] volume {dims}, device {name}")
    if args.resume:
        if not args.resume.endswith(".npz"):
            raise SystemExit("--resume reads native .npz checkpoints")
        nv = NeuralVolume.from_checkpoint(args.resume, simple=simple,
                                          device=args.device)
        nv.train_batch = args.batch
        print(f"[vnr] resumed from {args.resume} at step {nv.step}")
    else:
        nv = NeuralVolume(cfg, simple=simple, seed=args.seed,
                          device=args.device, train_batch=args.batch)
    spec = nv.field.spec
    print(f"[vnr] model: {nv.field.n_params} params ({spec.n_levels} levels "
          f"× {spec.n_features} features)")

    logger = CsvLogger(args.log, ["step", "loss", "time_s"])
    t_start = time.time()
    prev_loss = float("inf")
    step = nv.step
    while step < args.max_num_steps:
        n = min(args.chunk, args.max_num_steps - step)
        t0 = time.time()
        stats = nv.train(n, fast_mode=False)
        sync(args.device)
        dt = time.time() - t0
        step = stats.step
        # restart-on-bad-loss heuristic (batch_trainer.cpp:114-118)
        if not math.isfinite(stats.loss) or (
                step > 100 and stats.loss > 10.0 * max(prev_loss, 1e-6)):
            print(f"[vnr] step {step}: bad loss {stats.loss:.5f}; "
                  "restarting the network")
            nv = NeuralVolume(cfg, simple=simple, seed=args.seed + step,
                              device=args.device, train_batch=args.batch)
            step = 0
            prev_loss = float("inf")
            continue
        prev_loss = stats.loss
        print(f"[vnr] step {step:6d}  loss {stats.loss:.6f}  "
              f"({n / dt:.1f} steps/s)")
        logger.log(step, stats.loss, time.time() - t_start)
    logger.close()
    print(f"[vnr] total training time: {time.time() - t_start:.1f}s")
    if args.report_psnr:
        print(f"[vnr] PSNR: {nv.get_psnr():.2f} dB")
        print(f"[vnr] SSIM: {nv.get_mssim():.4f}")
    if args.save:
        nv.save_params(args.save)
        print(f"[vnr] saved checkpoint: {args.save}")
    return nv


if __name__ == "__main__":
    main()
