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
- K3's device time on the 2^14 and 2^19 layouts' f32 tables at B = 2^16
  in bf16 compute (`chip_smoke.hash_inputs`, as a training step runs it)
  and on the 2^19 layout's bf16 table over a decode blob (262,144 grid
  points, as a decode runs it);
- K4's device time (its kernel and the zeroing of the table) on the 2^14
  and 2^19 layouts at B = 2^16 (`chip_smoke.hash_inputs`);
- the isosurface sweep's device time on one 512² orbit frame, its inputs
  built by the tree's own `slab_iso_args`;
- each instantiation of the slab compositor template by device time on
  one 512² orbit frame of the synthetic volume (plain, shaded, shadow,
  shaded + shadow), its inputs built by the tree's own
  `slab_composite_args` (`chip_smoke.composite_inputs`);
- the training chain end to end at B = 2^16 for 5 seeds
  (`chip_smoke.chain_end_to_end`): the rows to which the forward kernel
  and the plain forward hand the backward other inputs, and the errors;
- the full decode of the 2^19 model (host clock, median of 5);
- a DECODED_SLAB orbit of 512² frames, a shaded + shadowed one and an
  ISOSURFACE_DECODED one (host clock, frames 2-12, as chip_smoke's main
  path and views) and one frame's stages (CUDA events, `chip_smoke.phase_breakdown`: the inputs
  and the compositor of a plain and of a shaded + shadowed frame);
- the online round (train(10), full decode, one frame; median of rounds
  2-6) and the training step at 2^19 (CUDA events over 100 steps, and its
  device busy time from torch.profiler over 20);
- the wavefront's emission kernel at `chip_smoke.phase_raymarch_emit`'s
  shapes (R = 512², K = 8 and 16, 8 skips; device time), its backward
  (where the tree has one) at `chip_smoke.emit_backward_shapes`' three
  (R = 512², K = 8; the 128² ray frame's K = 4, fresh and after a first
  superstep; device time, one kernel a call) and the marching-
  tetrahedra kernels on its 33-plane slab of vorts 128³ (the kernels'
  device time, all the call's device work, the call by CUDA events);
- the compaction kernels at `chip_smoke.compaction_cases`' shapes (the
  band's compaction of the wavefront's 14 leaves and the path tracer's
  11 at m = 2^18 with copy back, the select form at 2^21, scatter_rows on
  a compaction's order, a frame's after three compactions and a random
  permutation): the device time of every kernel a call launches, and the
  call by CUDA events;
- NEURAL_WAVEFRONT at 512² on the 2^19 model with chip_smoke's seeded
  weights (`chip_smoke.run_wavefront_mode`: 6 orbit frames by the host
  clock, one profiled), the same mode through the compacted driver
  (`chip_smoke.run_compacted_mode`: masked and compacted frames, one
  fused frame profiled, with its compaction kernels' device ms), and the
  network's isosurface at 128³ on the 2^19 model after this script's 220
  training steps at `chip_smoke.TRAINED_ISO` (`chip_smoke.network_
  extraction`, 3 times: the median ms, the last call's stages).

Then the card's name and power limit, as nvidia-smi prints them. Needs one
card.

    python3 scripts/compare_trees.py --emission TREE [TREE ...]

reads only the emission's kernels (the forward at K = 8 and 16, the
backward at its three shapes) a run, with the count and a digest of each
one's SASS instructions in the tree's library (`cuobjdump -sass`, the
addresses and encodings left out: the same digest is the same machine
code): about 15 s a run once each tree is built, so that many readings of
each tree can alternate in one call.
"""
import hashlib
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
                  "frame_composite_ext_ms", "frame_inputs_ops",
                  "iso_frame_total_ms")
# the compaction kernels of the design before the current one (count,
# scan, partition, copy back; one scatter), matched by the names after "::"
# so that a profiled frame of an older tree counts its compaction too
PREVIOUS_COMPACTION_KERNELS = ("::count_kernel", "::scan_kernel",
                               "::partition_kernel", "::copy_back_kernel",
                               "::scatter_kernel")
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


def measure(emission_only=False):
    """One run in the current directory's checkout → one JSON line; with
    `emission_only` the emission's kernels alone."""
    import torch

    sys.path.insert(0, os.getcwd())
    cs = chip_smoke()
    cs.COMPACTION_KERNEL_NAMES += PREVIOUS_COMPACTION_KERNELS
    if emission_only:
        from instantvnr_torch import api
        from instantvnr_torch.ops import cuda_lib

        lib = cuda_lib.load_library()
        sv = api.SimpleVolume.synthetic(cs.DIMS, "vorts", device="cuda")
        print(json.dumps({"tree": os.getcwd(), **emission(torch, cs, sv),
                          "sass": sass_digests(lib.path)}), flush=True)
        return
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

    from instantvnr_torch.models.metrics import _grid_coords_slab

    for log2 in (14, 19):
        spec, table, coords, g = cs.hash_inputs(torch, log2)
        rec[f"hash_encode_forward_2e{log2}_ms"] = cs.device_ms(
            torch, lambda: he._kernel_forward(table, coords, spec,
                                              torch.bfloat16),
            ("hash_encode_forward_kernel",))
        rec[f"hash_encode_backward_2e{log2}_ms"] = cs.device_ms(
            torch, lambda: he._kernel_backward(spec.n_entries, coords, spec,
                                               g, torch.bfloat16),
            cs.K4_KERNELS)

    # the decode's K3: the 2^19 layout's bf16 table over a decode blob
    spec, table, _, _ = cs.hash_inputs(torch, 19)
    table16 = table.to(torch.bfloat16)
    blob = _grid_coords_slab(cs.DIMS, 0, 16, "cuda")
    rec["hash_encode_forward_decode_blob_ms"] = cs.device_ms(
        torch, lambda: he._kernel_forward(table16, blob, spec,
                                          torch.bfloat16),
        ("hash_encode_forward_kernel",))

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
    from instantvnr_torch.ops import iso_sweep as isw
    from instantvnr_torch.render.isosurf import IsoSettings, slab_iso_args
    from instantvnr_torch.render.slabmarch import camera_arrays, principal_axis

    axis, flipped = principal_axis(cam)
    iso_args, _ = slab_iso_args(vol, grads, cs.SIZE, cs.SIZE, IsoSettings(),
                                axis, flipped, camera_arrays(cam, "cuda"))
    iso = float(vol.median())
    rec["iso_sweep_ms"] = cs.device_ms(
        torch, lambda: isw.iso_sweep(*iso_args, iso), ("iso_sweep_kernel",))
    rec.update(emission_and_isosurface(torch, cs, sv))
    rec.update(compaction(torch, cs))
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
    orbit = cs.run_orbit(torch, r_iso, "frame_isosurface")
    rec.update(frame_isosurface_ms=orbit["ms_per_frame"],
               frame_isosurface_ms_median=orbit["ms_per_frame_median"])
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
    rec.update(wavefront_and_extraction(torch, cs, sv, nv))
    print(json.dumps(rec), flush=True)


def emission(torch, cs, sv):
    """raymarch_emit at the smoke's shapes (K = 8 and 16) and, where the
    tree has it, raymarch_emit_backward at its three, through the tree's
    own wrappers (the smoke's random cotangents)."""
    from instantvnr_torch.render import raymarch as rm

    org, dirn, t0, t1, _ = cs.wavefront_rays(
        torch, sv, cs.SIZE, cs.SIZE, cs.orbit(1, cs.N_FRAMES, max(cs.DIMS)))
    mc, skips = sv.macrocell, 8
    out = {}
    for k in (8, 16):
        state = rm.init_ray_state(t0, t1)
        (t, tce, ss), *_ = rm._emit_samples(org, dirn, t1, state, mc, 1.0, k,
                                            skips)
        state = state._replace(t=t, t_cell_end=tce, ss=ss)
        out["raymarch_emit_ms" if k == 8 else f"raymarch_emit_k{k}_ms"] = (
            cs.device_ms(torch, lambda: rm.raymarch_emit(
                org, dirn, t1, state, mc, 1.0, k, skips),
                ("raymarch_emit_kernel",)))
    if not hasattr(rm, "_kernel_emit_backward"):
        return out
    for name, o, d, t_far, state, k in cs.emit_backward_shapes(torch, sv):
        r = o.shape[0]
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 40 + k)
        grads = [torch.randn(sh, generator=gen, device="cuda")
                 for sh in ((r,),) * 3 + ((r, k),) * 2]
        ins = (o, d, t_far, state.t, state.t_cell_end, state.ss)
        out[f"raymarch_emit_backward[{name}]_ms"] = cs.device_ms(
            torch, lambda: rm._kernel_emit_backward(
                *ins, grads, (True,) * 6, mc, 1.0, k, skips, 1),
            ("raymarch_emit_backward_kernel",), per_call=1)
    return out


def sass_digests(lib_path, kernels=("raymarch_emit_kernel",
                                     "raymarch_emit_backward_kernel")):
    """{kernel: (SASS instructions, sha1 of their text)} of the library's
    functions whose names hold `<length><kernel>` (as mangled), from
    `cuobjdump -sass` with each line's address and encoding left out."""
    import re

    from instantvnr_torch.ops.cuda_lib import _nvcc

    sass = subprocess.run(
        [os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass",
         lib_path], capture_output=True, text=True, check=True).stdout
    lines, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((k for k in kernels if f"{len(k)}{k}" in m.group(1)),
                      None)
            if fn:
                lines[fn] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if fn and ins:
            lines[fn].append(ins.group(1))
    return {k: (len(v), hashlib.sha1("\n".join(v).encode()).hexdigest())
            for k, v in lines.items()}


def emission_and_isosurface(torch, cs, sv):
    """The emission's kernels (`emission`) and the marching-tetrahedra
    kernels at the smoke's shapes, through the tree's own wrappers."""
    from instantvnr_torch.ops import isosurface as mt

    out = emission(torch, cs, sv)
    vol = sv.volume.data
    g, iso = vol[:33].contiguous(), float(vol.median())

    def slab():
        return mt.extract_slab(g, iso, 0)

    out.update(isosurface_kernels_ms=cs.device_ms(torch, slab,
                                                  ("mt_count", "mt_emit")),
               isosurface_slab_device_ms=cs.device_ms(torch, slab, ("",)),
               isosurface_slab_call_ms=cs.cuda_ms(torch, slab))
    return out


def compaction(torch, cs):
    """The compaction kernels at the smoke's shapes, through the tree's own
    wrappers: the device time of every kernel a call launches (the two
    designs name their kernels apart) and the call by CUDA events."""
    out = {}
    for name, (fn, *_) in cs.compaction_cases(torch).items():
        out[f"compaction_{name}_ms"] = cs.device_ms(torch, fn, ("",))
        out[f"compaction_{name}_call_ms"] = cs.cuda_ms(torch, fn)
    return out


def wavefront_and_extraction(torch, cs, sv, nv):
    """A NEURAL_WAVEFRONT orbit on the seeded 2^19 model, and the trained
    nv's isosurface at 128³."""
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import params_from_numpy

    nv_w = api.NeuralVolume(ModelConfig(), sv, device="cuda")
    nv_w.params = params_from_numpy(cs.seeded_params(nv_w.field, cs.SEED),
                                    "cuda")
    cs.WAVEFRONT_FRAMES = 6
    wf = cs.run_wavefront_mode(torch, nv_w, "NEURAL_WAVEFRONT")
    cf = cs.run_compacted_mode(torch, nv_w, "NEURAL_WAVEFRONT", "none",
                               cs.SIZE)
    del nv_w
    ext = [cs.network_extraction(torch, nv, cs.TRAINED_ISO, "trained")
           for _ in range(3)]
    return {"neural_wavefront_frame_ms": wf["frame_ms"],
            "neural_wavefront_ms_median": float(np.median(wf["frame_ms"])),
            "neural_wavefront_supersteps": wf["supersteps"],
            "neural_wavefront_profiled": wf["profiled_frame"],
            "compacted_same_bits": cf["same_bits"],
            "compacted_kinds": cf["kinds"],
            "compacted_ms": cf["compacted_ms"],
            "compacted_profiled": cf["profiled_frame"],
            "extraction_ms": [e["ms"] for e in ext],
            "extraction_ms_median": float(np.median([e["ms"] for e in ext])),
            "extraction_triangles": ext[-1]["triangles"],
            "extraction_stages": ext[-1]["stages_profiled"]}


def main():
    if sys.argv[1:2] == ["--measure"]:
        measure(emission_only=sys.argv[2:] == ["--emission"])
        return 0
    mode = ["--emission"] if sys.argv[1:2] == ["--emission"] else []
    trees = sys.argv[1 + len(mode):]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", *mode], cwd=os.path.abspath(tree),
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
