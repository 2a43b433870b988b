"""Interactive online training, headless: the port's `vnr_int_online`
(counterpart of `apps/vnr_int_online.py`; the reference's
apps/int_dual_volume.cpp background loop, :498-699). Training steps run
inside the render loop with no pretraining; each frame also decodes a few
blobs progressively, so the decoded-grid frame shows the training as it
goes; a CSV logs each frame's step, loss, training and render time
(int_dual_volume.cpp:426-431).

    python -m instantvnr_torch.apps.vnr_int_online --synthetic vorts \\
        --dims 128 --frames 60 --train-steps-per-frame 10 --log online.csv

A frame: `train(steps)` (the hash grid's K3/K4 and the fused MLP's
training kernels), `decode_progressive(blobs)` (K3 and the fused MLP's
inference kernel on each blob), one DECODED_SLAB frame (`composite_slabs`).
`train_ms` and `render_ms` are host clocks around work that ends in a
wait for the card.
"""
from __future__ import annotations

import argparse
import time

from instantvnr_torch.apps.common import (
    CsvLogger,
    add_device_arg,
    add_model_args,
    add_volume_args,
    device_name,
    interactive_model_config,
    load_simple_volume,
    save_png,
)

CSV_HEADER = ["frame", "step", "loss", "train_ms", "render_ms", "fps"]


def main(argv=None):
    """Run the loop; → (the NeuralVolume, its DecodedRenderer)."""
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_volume_args(p)
    add_model_args(p)
    add_device_arg(p)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--train-steps-per-frame", type=int, default=10)
    p.add_argument("--infer-blobs-per-frame", type=int, default=2,
                   help="progressive decode blobs a frame (int_dual:662-674)")
    p.add_argument("--log", help="CSV: " + ",".join(CSV_HEADER))
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="save frame_XXXX.png every N frames")
    p.add_argument("--pause-training", action="store_true")
    args = p.parse_args(argv)

    from instantvnr_torch.api import NeuralVolume
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.utils.profiling import sync

    simple = load_simple_volume(args)
    cfg = interactive_model_config(args)
    nv = NeuralVolume(cfg, simple=simple, seed=args.seed,
                      train_batch=args.batch, device=args.device)
    dec = nv.get_decoder(args.size, args.size)
    d = max(simple.dims)
    dec.set_camera(Camera(eye=(0.15 * d, 0.1 * d, -2.0 * d),
                          center=(0, 0, 0), up=(0, 1, 0), fovy=45))

    print(f"[vnr] online training: {simple.dims} volume, "
          f"{args.train_steps_per_frame} steps/frame, "
          f"{args.infer_blobs_per_frame} blobs/frame, "
          f"device {device_name(args.device)}")
    logger = CsvLogger(args.log, CSV_HEADER)
    for frame in range(args.frames):
        t0 = time.perf_counter()
        if not args.pause_training:
            # the background_work training slice (int_dual_volume.cpp:662-674)
            nv.train(args.train_steps_per_frame, fast_mode=False)
            nv.decode_progressive(args.infer_blobs_per_frame)
            sync(dec.decoded)
        t_train = time.perf_counter() - t0

        t0 = time.perf_counter()
        dec.set_params(nv.params)
        sync(dec.render())
        t_render = time.perf_counter() - t0

        fps = 1.0 / max(t_train + t_render, 1e-9)
        stats = nv.statistics()
        logger.log(frame, stats.step, stats.loss, t_train * 1e3,
                   t_render * 1e3, fps)
        if frame % 10 == 0:
            print(f"[vnr] frame {frame:4d}  step {stats.step:6d}  "
                  f"loss {stats.loss:.5f}  train {t_train * 1e3:.0f}ms  "
                  f"render {t_render * 1e3:.0f}ms  {fps:.1f} fps")
        if args.snapshot_every and frame % args.snapshot_every == 0:
            save_png(dec.mapframe(), f"frame_{frame:04d}.png")
    logger.close()
    print(f"[vnr] final: step {nv.step}, loss {nv.get_training_loss():.5f}, "
          f"PSNR {nv.get_psnr():.2f} dB")
    return nv, dec


if __name__ == "__main__":
    main()
