"""Isosurface extraction to OBJ, the port's `vnr_cmd_isosurface`
(counterpart of `apps/vnr_cmd_isosurface.py`; the reference's
apps/batch_isosurface.cpp): marching tetrahedra on a volume's grid, or
directly on the network of a checkpoint, decoded z-slab by z-slab.

    python -m instantvnr_torch.apps.vnr_cmd_isosurface --synthetic sphere \\
        --dims 64 --isovalue 0.5 --output iso.obj
    python -m instantvnr_torch.apps.vnr_cmd_isosurface --load params.npz \\
        --isovalue 0.5 --output iso.obj

On the card both run the `mt_count` / `mt_emit` kernels
(csrc/isosurface.cu); the OBJ is byte for byte the JAX app's for the same
mesh.
"""
from __future__ import annotations

import argparse
import time

from instantvnr_torch.apps.common import (add_device_arg, add_volume_args,
                                          load_simple_volume, sync)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_volume_args(p)
    add_device_arg(p)
    p.add_argument("--load", help="checkpoint: extract from the network")
    p.add_argument("--isovalue", type=float, default=0.5)
    p.add_argument("--output", default="isosurface.obj")
    p.add_argument("--no-weld", action="store_true",
                   help="write the raw triangle soup instead of the indexed "
                   "(edge-welded) mesh")
    args = p.parse_args(argv)

    from instantvnr_torch.ops.isosurface import (extract_isosurface,
                                                 extract_isosurface_network,
                                                 save_obj)

    t0 = time.time()
    if args.load:
        from instantvnr_torch.api import NeuralVolume

        nv = NeuralVolume.from_checkpoint(args.load, device=args.device)
        print(f"[iso] extracting from the network, dims {nv.dims}")
        verts, faces = extract_isosurface_network(
            nv.field, nv.params, nv.dims, args.isovalue,
            weld=not args.no_weld)
    else:
        simple = load_simple_volume(args)
        print(f"[iso] extracting from the volume, dims {simple.dims}")
        verts, faces = extract_isosurface(simple.volume.data, args.isovalue,
                                          weld=not args.no_weld)
    sync(args.device)
    print(f"[iso] {len(verts)} vertices, {len(faces)} triangles "
          f"in {time.time() - t0:.1f}s")
    save_obj(verts, faces, args.output)
    print(f"[iso] saved {args.output}")
    return verts, faces


if __name__ == "__main__":
    main()
