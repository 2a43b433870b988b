#!/usr/bin/env python3
"""Time the port's kernels, full decode, frames, online round and 2^19
training step in several checkouts on one card, one process a run, in the
order given (parent, change, change, parent compares two commits).

    python3 scripts/compare_trees.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository: its
instantvnr_torch is built and imported there, and measured with the
helpers of this checkout's chip_smoke.py (the same inputs, timers and
checks as its phases). Per run, one JSON line:

- each fused-MLP kernel's device time (torch.profiler, the kernels whose
  names hold "fused_mlp" or "sum_partials") at the main path's shapes (a
  262,144-row decode blob; B = 2^16 for the training form);
- K4's device time (its kernel and the zeroing of the table) on the 2^14
  and 2^19 layouts at B = 2^16 (`chip_smoke.hash_inputs`);
- each instantiation of the slab compositor template by device time on
  one 512² orbit frame of the synthetic volume (plain, shaded, shadow,
  shaded + shadow), its inputs built by the tree's own
  `slab_composite_args` (`chip_smoke.composite_inputs`);
- the training chain end to end at B = 2^16 for 5 seeds
  (`chip_smoke.chain_end_to_end`): the rows to which the forward kernel
  and the plain forward hand the backward other inputs, and the errors;
- the full decode of the 2^19 model (host clock, median of 5);
- a DECODED_SLAB orbit of 512² frames and a shaded + shadowed one (host
  clock, frames 2-12, as chip_smoke's main path and views) and one
  frame's stages (CUDA events, `chip_smoke.phase_breakdown`: the inputs
  and the compositor of a plain and of a shaded + shadowed frame);
- the online round (train(10), full decode, one frame; median of rounds
  2-6) and the training step at 2^19 (CUDA events over 100 steps, and its
  device busy time from torch.profiler over 20).

Then the card's name and power limit, as nvidia-smi prints them. Needs one
card.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BREAKDOWN_KEYS = ("blob_hash_encode_ms", "blob_fused_mlp_ms",
                  "frame_inputs_ms", "frame_composite_ms", "frame_warp_ms",
                  "frame_total_ms", "frame_inputs_ext_ms",
                  "frame_composite_ext_ms", "frame_inputs_ops")
SLAB_VIEWS = {"composite_slabs": ("none", False, False),
              "ext_shaded": ("gradient", True, False),
              "ext_shadow": ("none", False, True),
              "ext_shaded+shadow": ("gradient", True, True)}


def chip_smoke():
    """This checkout's chip_smoke.py as a module; its helpers import the
    instantvnr_torch that comes first on sys.path (the tree's)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def measure():
    """One run in the current directory's checkout → one JSON line."""
    import torch

    sys.path.insert(0, os.getcwd())
    cs = chip_smoke()
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.ops import cuda_lib
    from instantvnr_torch.ops import fused_mlp as fm
    from instantvnr_torch.ops import hash_encoding as he
    from instantvnr_torch.render.raymarch import DEFAULT_LIGHT
    from instantvnr_torch.render.shadow import shadow_volume_for
    from instantvnr_torch.render.slabmarch import compute_gradient_volumes

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_lib.load_library()
    rec = {"tree": os.getcwd(), "load_library_s": time.perf_counter() - t0}

    # the kernel phases' inputs (phase_fused_mlp, phase_fused_mlp_train)
    field = NeuralField.from_config(ModelConfig())
    cfg = field.cfg.network
    blob_ws, blob, _ = cs.mlp_inputs(torch, field, cs.SEED + 1,
                                     b=cs.DIMS[0] * cs.DIMS[1] * 16)
    ws, x, g = cs.mlp_inputs(torch, field, cs.SEED + 5)
    z_out, zs = fm._kernel_train_forward(ws, x, cfg)
    names = ("fused_mlp", "sum_partials")
    rec.update(
        fused_mlp_ms=cs.device_ms(
            torch, lambda: fm.fused_mlp_apply(blob_ws, blob, cfg), names),
        fused_mlp_train_forward_ms=cs.device_ms(
            torch, lambda: fm._kernel_train_forward(ws, x, cfg), names),
        fused_mlp_backward_ms=cs.device_ms(
            torch, lambda: fm._kernel_backward(ws, x, zs, z_out, g, cfg),
            names),
        chain_end_to_end={
            seed: cs.chain_end_to_end(
                torch, *cs.mlp_inputs(torch, field, seed), cfg)
            for seed in (cs.SEED + 5 + 2 * k for k in range(5))})

    for log2 in (14, 19):
        spec, _, coords, g = cs.hash_inputs(torch, log2)
        rec[f"hash_encode_backward_2e{log2}_ms"] = cs.device_ms(
            torch, lambda: he._kernel_backward(spec.n_entries, coords, spec,
                                               g, torch.bfloat16),
            cs.K4_KERNELS)

    sv = api.SimpleVolume.synthetic(cs.DIMS, "vorts", device="cuda")
    vol = sv.volume.data
    grads = compute_gradient_volumes(vol)
    shadow = shadow_volume_for(vol, sv.tf, DEFAULT_LIGHT)
    cam = cs.orbit(1, cs.N_FRAMES, max(cs.DIMS))
    for name, (shading, shade, shadowed) in SLAB_VIEWS.items():
        comp, args = cs.composite_inputs(torch, sv.tf, cam, vol, shading,
                                         grads if shade else None,
                                         shadow if shadowed else None)
        rec[f"{name}_ms"] = cs.device_ms(torch, lambda: comp(*args),
                                         ("slab_composite_kernel",))
    nv = api.NeuralVolume(ModelConfig(), sv, seed=0, device="cuda",
                          train_batch=cs.TRAIN_BATCH)
    r = api.VNRenderer(nv, cs.SIZE, cs.SIZE, api.RenderMode.DECODED_SLAB)
    nv.train(20)
    nv.ensure_decoded(cs.SIZE, cs.SIZE)

    def decode():
        nv.params = dict(nv.params)  # a new identity: a full re-decode
        return host_ms(torch, lambda: nv.ensure_decoded(cs.SIZE, cs.SIZE))

    rec["decode_ms"] = float(np.median([decode() for _ in range(5)]))
    orbit = cs.run_orbit(torch, r, "frame")
    rec.update(frame_ms=orbit["ms_per_frame"],
               frame_ms_median=orbit["ms_per_frame_median"])
    r_ext = api.VNRenderer(nv, cs.SIZE, cs.SIZE, api.RenderMode.DECODED_SLAB)
    r_ext.set_slab_shading("gradient")
    r_ext.enable_shadows()
    orbit = cs.run_orbit(torch, r_ext, "frame_shaded_shadowed")
    rec.update(frame_shaded_shadowed_ms=orbit["ms_per_frame"],
               frame_shaded_shadowed_ms_median=orbit["ms_per_frame_median"])
    r_iso = api.VNRenderer(nv, cs.SIZE, cs.SIZE)
    r_iso.set_mode(api.RenderMode.ISOSURFACE_DECODED)
    r_iso.set_isovalue(float(nv.decode_volume().median()))
    breakdown = cs.phase_breakdown(torch, nv, api.VNRenderer(
        nv, cs.SIZE, cs.SIZE), r_iso)
    rec.update({k: breakdown[k] for k in BREAKDOWN_KEYS})

    def round_():
        nv.train(10)
        nv.ensure_decoded(cs.SIZE, cs.SIZE)
        r.render()
        r.mapframe()

    rounds = [host_ms(torch, round_) for _ in range(6)]
    rec["online_round_ms"] = float(np.median(rounds[1:]))

    nv.train(20, fast_mode=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    nv.train(100, fast_mode=True)
    end.record()
    torch.cuda.synchronize()
    rec["step_ms"] = start.elapsed_time(end) / 100
    rec["step_device_busy_ms"] = cs.device_ms(
        torch, lambda: nv.train(20, fast_mode=True), ("",), iters=1) / 20
    print(json.dumps(rec), flush=True)


def main():
    if sys.argv[1:] == ["--measure"]:
        measure()
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure"], cwd=os.path.abspath(tree),
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode or not lines:
            sys.stderr.write(out.stderr[-4000:])
            print(json.dumps({"tree": tree, "rc": out.returncode}),
                  flush=True)
            rc = 1
            continue
        rec = json.loads(lines[-1])
        rec["tree"] = tree
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
