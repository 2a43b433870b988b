"""Precompute a shadow (transmittance) volume, the port's
`generate_shadow_map` (counterpart of `apps/generate_shadow_map.py`; the
reference's apps/shadowmap.cu marches each voxel toward the light; here
the sheared cumulative-transmittance sweep of render/shadow.py).

    python -m instantvnr_torch.apps.generate_shadow_map --synthetic vorts \\
        --dims 64 --light 0.7 0.9 0.4 --output shadow.raw

With `--load`, the shadow of the decoded network (the scene's transfer
function when a volume is named, else the default one).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from instantvnr_torch.apps.common import (add_device_arg, add_volume_args,
                                          load_simple_volume, sync)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_volume_args(p)
    add_device_arg(p)
    p.add_argument("--load", help="checkpoint: the shadow of the decoded "
                   "network")
    p.add_argument("--light", type=float, nargs=3, default=[0.7, 0.9, 0.4])
    p.add_argument("--sampling-rate", type=float, default=1.0)
    p.add_argument("--output", default="shadow.raw",
                   help="raw float32 [dz, dy, dx] transmittance volume")
    args = p.parse_args(argv)

    from instantvnr_torch.render.shadow import shadow_volume_for

    if args.load:
        from instantvnr_torch.api import NeuralVolume
        from instantvnr_torch.config import TransferFunctionConfig
        from instantvnr_torch.utils.tfn import bake_transfer_function

        nv = NeuralVolume.from_checkpoint(args.load, device=args.device)
        grid = nv.decode_volume()
        if args.scene or args.synthetic:
            # the scene's TF (its data-unit range): the decoded shadows
            # match the ground truth's
            tf = load_simple_volume(args).tf
        else:
            tf = bake_transfer_function(TransferFunctionConfig(),
                                        device=args.device)
        dims = nv.dims
    else:
        simple = load_simple_volume(args)
        grid, tf, dims = simple.volume.data, simple.tf, simple.dims
    t0 = time.time()
    s = shadow_volume_for(grid, tf, tuple(args.light), args.sampling_rate)
    sync(args.device)
    s = s.cpu().numpy().astype(np.float32)
    print(f"[shadow] {dims} volume, light {args.light}: "
          f"{time.time() - t0:.1f}s, mean transmittance {s.mean():.3f}")
    s.tofile(args.output)
    print(f"[shadow] saved {args.output}")
    return s


if __name__ == "__main__":
    main()
