"""Checkpoint inspector, the port's `view_model` (counterpart of
`apps/view_model.py`; the reference's apps/view_model.cpp): print a
checkpoint's structure; with a reference volume and --evaluate, PSNR and
SSIM of the stored model (view_model.cpp:138-144).

    python -m instantvnr_torch.apps.view_model params.bson \\
        [--synthetic vorts --dims 64 --evaluate]

The checkpoint is a BSON file, a native `.npz` or an fV-SRN torch
checkpoint (`.pt`, `.pth`, `.ckpt`; models/fvsrn_import.py).
"""
from __future__ import annotations

import argparse
import os

from instantvnr_torch.apps.common import (
    add_device_arg,
    add_volume_args,
    load_simple_volume,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint")
    add_volume_args(p)
    add_device_arg(p)
    p.add_argument("--evaluate", action="store_true",
                   help="compute PSNR/SSIM against the volume")
    args = p.parse_args(argv)

    from instantvnr_torch.api import NeuralVolume
    from instantvnr_torch.serializer import load_checkpoint, load_native

    ckpt = args.checkpoint
    imported = ckpt.endswith((".pt", ".pth", ".ckpt"))
    # the structure is read on the CPU; --evaluate runs on --device
    if imported:
        # an fV-SRN torch checkpoint (the reference FvsrnNetwork's
        # inference-adapter role, fvsrn_network.cu:88-127)
        from instantvnr_torch.models.fvsrn_import import load_fvsrn_torch

        field, _ = load_fvsrn_torch(ckpt, device="cpu")
        mc, dims, meta = None, None, {}
        print("[view] format:         fV-SRN torch checkpoint (imported)")
    elif ckpt.endswith(".npz"):
        field, state, dims = load_native(ckpt, device="cpu")
        mc = None
        meta = {"step": int(state.opt.step), "loss": float(state.loss)}
        print("[view] format:         native exact-resume (.npz, full "
              "optimizer state)")
    else:
        field, _, mc, dims, meta = load_checkpoint(ckpt, device="cpu")
    info = {"dims": dims, "step": meta.get("step", "?"),
            "loss": meta.get("loss", "?"), "n_params": field.n_params}
    print(f"[view] volume dims:    {dims}")
    print(f"[view] trained steps:  {info['step']}  loss {info['loss']}")
    spec = getattr(field, "spec", None)
    if spec is not None:
        print(f"[view] encoding:       {spec.n_levels} levels × "
              f"{spec.n_features} features, 2^{spec.log2_hashmap_size} cap, "
              f"base res {spec.base_resolution}"
              + (", paired hash" if spec.paired else ""))
        print(f"[view] level sizes:    {spec.level_sizes}")
    else:  # the fV-SRN family
        c = field.cfg
        print(f"[view] encoding:       fV-SRN latent grid {c.latent_res} × "
              f"{c.latent_features} features, {c.fourier_bands} Fourier "
              "bands")
    net = field.cfg.network
    print(f"[view] mlp:            {net.n_neurons}×{net.n_hidden_layers} "
          f"{net.activation}")
    print(f"[view] total params:   {field.n_params}")
    if mc is not None:
        mx, my, mz = mc.dims
        print(f"[view] macrocell:      {mx}×{my}×{mz} cells")
    ckpt_bytes = os.path.getsize(ckpt)
    if dims is not None:
        raw_bytes = dims[0] * dims[1] * dims[2] * 4
        info["compression"] = raw_bytes / ckpt_bytes
        print(f"[view] compression:    {info['compression']:.1f}× "
              f"({ckpt_bytes} B vs {raw_bytes} B raw f32)")
    else:
        print(f"[view] checkpoint:     {ckpt_bytes} B (no volume dims "
              "stored; compression unknown)")
    if args.evaluate and (args.scene or args.synthetic or args.volume):
        simple = load_simple_volume(args)
        if imported:
            # an import has no container for from_checkpoint: evaluate the
            # imported field itself
            from instantvnr_torch.models.fvsrn_import import load_fvsrn_torch
            from instantvnr_torch.models.metrics import (decode_volume,
                                                         psnr_arrays,
                                                         ssim_arrays)
            from instantvnr_torch.models.network import render_params

            field, params = load_fvsrn_torch(ckpt, device=args.device)
            dec = decode_volume(field, render_params(params, field),
                                tuple(int(d) for d in simple.dims))
            info["psnr"] = float(psnr_arrays(dec, simple.volume.data))
            info["ssim"] = float(ssim_arrays(dec, simple.volume.data))
        else:
            nv = NeuralVolume.from_checkpoint(ckpt, simple=simple,
                                              device=args.device)
            info["psnr"], info["ssim"] = nv.get_psnr(), nv.get_mssim()
        print(f"[view] PSNR: {info['psnr']:.2f} dB")
        print(f"[view] SSIM: {info['ssim']:.4f}")
    return info


if __name__ == "__main__":
    main()
