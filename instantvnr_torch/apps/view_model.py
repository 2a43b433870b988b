"""Checkpoint inspector, the port's `view_model` (counterpart of
`apps/view_model.py`; the reference's apps/view_model.cpp): print a
checkpoint's structure; with a reference volume and --evaluate, PSNR and
SSIM of the stored model (view_model.cpp:138-144).

    python -m instantvnr_torch.apps.view_model params.bson \\
        [--synthetic vorts --dims 64 --evaluate]
"""
from __future__ import annotations

import argparse
import os

from instantvnr_torch.apps.common import (
    add_device_arg,
    add_volume_args,
    load_simple_volume,
)

_IMPORT_ITEM = ("ROADMAP 'Next slices' item 5 (data and model breadth: "
                "models/fvsrn_import.py)")


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
    if ckpt.endswith((".pt", ".pth", ".ckpt")):
        raise NotImplementedError("fV-SRN torch checkpoints are not ported "
                                  "yet: " + _IMPORT_ITEM)
    # the structure is read on the CPU; --evaluate runs on --device
    if ckpt.endswith(".npz"):
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
    spec = field.spec
    print(f"[view] encoding:       {spec.n_levels} levels × "
          f"{spec.n_features} features, 2^{spec.log2_hashmap_size} cap, "
          f"base res {spec.base_resolution}")
    print(f"[view] level sizes:    {spec.level_sizes}")
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
        nv = NeuralVolume.from_checkpoint(ckpt, simple=simple,
                                          device=args.device)
        info["psnr"], info["ssim"] = nv.get_psnr(), nv.get_mssim()
        print(f"[view] PSNR: {info['psnr']:.2f} dB")
        print(f"[view] SSIM: {info['ssim']:.4f}")
    return info


if __name__ == "__main__":
    main()
