#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root; needs one card)

Builds the CUDA kernels from instantvnr_torch/csrc with nvcc, holds each
kernel to its plain PyTorch version at the main path's shapes and times
both, then drives the main path through the user-facing entry points:
SimpleVolume.synthetic (vorts 128³) → NeuralVolume(ModelConfig()), the
2^19 reference schema with seeded random weights → VNRenderer(512²,
DECODED_SLAB): one full decode and an orbit of frames; then on the same
decode four more orbits: gradient shading, shading + shadows,
FULL_SHADOW_DECODED and ISOSURFACE_DECODED. Launch counts, reset before
each of these paths and read after it, prove which kernels each ran. A
breakdown shows where a blob's and a frame's time goes; then a BSON
checkpoint round trip. Any failed phase raises, so the script exits
non-zero. The last line is the JSON result; the line before it lists every
kernel with its numbers.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
SEED = 1234
N_FRAMES = 12
SIZE = 512
DIMS = (128, 128, 128)
# max |kernel − plain|: fused MLP as in tests/test_torch_fused_mlp.py (bf16
# rounding of hidden activations under another summation order flips
# isolated ulps); compositor: float32 sums in another order, amplified by
# the transfer function's slope (steep for the 70-knot TF)
MLP_ATOL = MLP_RTOL = 2e-2
MLP_MEAN_TOL = 1e-3
COMP_ATOL = {"default": 1e-4, "lut70": 1e-3}
# the extended compositor: as above, and with shading 2e-4 (the JAX package
# holds its shaded kernel to its scan there, test_slab_pallas.py:99: the
# specular cos_nh^40 amplifies summation order)
EXT_ATOL = {"shaded": 2e-4, "shadow": 1e-4, "shaded+shadow": 2e-4,
            "shaded,lut70": 1e-3}
# iso_sweep: a crossing within float32 noise of the isovalue may flip
ISO_FOUND_AGREE = 0.9999
ISO_ATOL = 1e-3
# operations per live pixel-slab beyond the resample and classification:
# gradient shading (view 6, its length and normalisation 10, normal 3, |n|^2
# and test 6, normalisation 5, cos_nl 6, half vector 3 + 10, cos_nh 6,
# specular 2, lit 1, cos_vn 6, headlight weight 3, 15 per channel: scivis 7,
# mix 4, lerp 4), the shadow factor (clamp 2, 1-amb, product, sum, 3
# channel products) and the first-hit test of iso_sweep (coverage 1,
# denominator 1, test 2, fraction 2 + select 1 + clamp 2, sign 4, newly 4,
# z 1, hit_z 3, hit_g 18, found 1)
SHADE_OPS, SHADOW_OPS, ISO_OPS = 112, 8, 40


def log(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def seeded_params(field, seed):
    """Numpy weights for the field: table uniform ±1 (an untrained ±1e-4
    table decodes to ~0, a transparent frame), He-normal MLP."""
    rng = np.random.default_rng(seed)
    spec, net = field.spec, field.cfg.network
    widths = ([spec.n_output_dims] + [net.n_neurons] * net.n_hidden_layers
              + [1])
    return {
        "table": rng.uniform(-1.0, 1.0, (spec.n_entries, spec.n_features)
                             ).astype(np.float32),
        "mlp": [(rng.standard_normal((a, b)) * math.sqrt(2.0 / a)
                 ).astype(np.float32) for a, b in zip(widths[:-1], widths[1:])],
    }


def orbit(i, n, d):
    """Camera i of n around the +y axis (apps/vnr_cmd_render.py:142-153)."""
    from instantvnr_torch.render.camera import Camera

    a = 2.0 * math.pi * i / n
    x, y, z = 0.15 * d, 0.1 * d, -2.0 * d
    eye = (x * math.cos(a) + z * math.sin(a), y,
           -x * math.sin(a) + z * math.cos(a))
    return Camera(eye=eye, center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                  fovy=45.0)


def phase_fused_mlp(torch, rows):
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField, params_from_numpy
    from instantvnr_torch.ops import fused_mlp as fm

    field = NeuralField.from_config(ModelConfig())
    cfg = field.cfg.network
    p = params_from_numpy(seeded_params(field, SEED + 1), "cuda")
    rng = np.random.default_rng(SEED + 2)
    x = torch.tensor(rng.standard_normal((rows, field.spec.n_output_dims)
                                         ).astype(np.float32),
                     device="cuda").to(torch.bfloat16)
    got = fm.fused_mlp_apply(p["mlp"], x, cfg)
    ref = fm.fused_mlp_reference(p["mlp"], x, cfg)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    err = float(diff.max())
    mean_err = float(diff.mean())
    ok = bool((diff <= MLP_ATOL + MLP_RTOL * ref.abs()).all()) and \
        mean_err <= MLP_MEAN_TOL
    ms = cuda_ms(torch, lambda: fm.fused_mlp_apply(p["mlp"], x, cfg))
    plain_ms = cuda_ms(torch, lambda: fm.fused_mlp_reference(p["mlp"], x, cfg))
    wb = [w.to(torch.bfloat16) for w in p["mlp"]]

    def library():  # a bf16 torch.matmul chain: timed only, never used
        h = x
        for w in wb[:-1]:
            h = torch.relu(torch.matmul(h, w))
        return torch.matmul(h, wb[-1])

    library_ms = cuda_ms(torch, library)
    widths = [w.shape for w in p["mlp"]]
    flops = 2 * rows * sum(a * b for a, b in widths)
    b_ms, b_by = bound_ms(nbytes(x, got) + sum(2 * a * b for a, b in widths),
                          flops, H100_BF16_FLOPS)
    rec = {"phase": "fused_mlp", "rows": rows, "max_abs_err": err,
           "mean_abs_err": mean_err, "tol": f"atol=rtol={MLP_ATOL}, "
           f"mean<={MLP_MEAN_TOL}", "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
           "gflop": flops / 1e9}
    log(rec)
    if not ok:
        raise AssertionError(f"fused_mlp kernel disagrees: {rec}")
    return rec


def composite_inputs(torch, tf, cam, volume, shading="none", grads=None,
                     shadow=None):
    from instantvnr_torch.render.slabmarch import (SlabSettings, camera_arrays,
                                                   principal_axis,
                                                   slab_composite_args)

    axis, flipped = principal_axis(cam)
    _, args, _ = slab_composite_args(
        volume, tf, camera_arrays(cam, "cuda"), SIZE, SIZE,
        SlabSettings(shading=shading), axis, flipped, grad_volumes=grads,
        shadow_volume=shadow)
    return args


def composite_ops(torch, args, per_px=None, n_fields=1):
    """Operations these inputs need, counting an FMA as 2: only pixels and
    slabs that are covered and not yet terminated (replayed here in plain
    PyTorch) need work. Each needs its nonzero resample products (a row of
    My or Mx has at most 2 nonzeros) for each of n_fields fields, then per
    pixel (per_px): normalize 4, termination test 1, classify (per control
    segment 12: v-x0, divide, clamp 2, 4 FMAs, as a segment's width and
    channel differences are constants; LUT 17: scale, floor, clamp 2, frac,
    4 x (difference, FMA)), opacity correction 4, blend 9. Returns (needed,
    dense resample, live pixel-slabs)."""
    from instantvnr_torch.ops import slab_composite as sc

    vol, my_all, mx_all, covy, covx, corr, ctrl, lut = args
    d, ay, ax = vol.shape
    hi, wi = corr.shape
    if per_px is None:
        per_px = 18 + (17 if lut is not None else 12 * (ctrl.shape[0] - 1))
    nnz_my = (my_all != 0).sum(-1)  # [D, hi]
    nnz_mx = (mx_all != 0).sum(-1)  # [D, wi]
    trans = torch.ones((hi, wi), dtype=torch.float32, device=vol.device)
    ops = torch.zeros((), dtype=torch.float64, device=vol.device)
    live_total = torch.zeros_like(ops)
    for k in range(d):
        live = ((covy[k][:, None] * covx[k][None, :]) != 0) & (
            trans > sc.TERM_THRESH)
        rows = live.any(dim=1)
        # tmp rows that are needed
        ops += n_fields * 2 * ax * (nnz_my[k] * rows).sum()
        ops += (live * (n_fields * 2 * nnz_mx[k][None, :] + per_px)).sum()
        live_total += live.sum()
        vals = my_all[k] @ vol[k] @ mx_all[k].T
        a = sc._classify_packed(ctrl, lut, vals)[..., 3]
        alpha = 1.0 - torch.pow(torch.clamp(1.0 - a, min=0.0), corr)
        trans = trans * (1.0 - alpha * live)
    return float(ops), n_fields * 2 * d * (hi * ay * ax + hi * wi * ax), \
        int(live_total)


def phase_composite(torch, name, tf, volume):
    from instantvnr_torch.ops import slab_composite as sc

    args = composite_inputs(torch, tf, orbit(1, N_FRAMES, max(DIMS)), volume)
    got_c, got_a = sc.composite_slabs(*args)
    ref_c, ref_a = sc.composite_slabs_reference(*args)
    torch.cuda.synchronize()
    err = max(float((got_c - ref_c).abs().max()),
              float((got_a - ref_a).abs().max()))
    ms = cuda_ms(torch, lambda: sc.composite_slabs(*args), iters=10)
    plain_ms = cuda_ms(torch, lambda: sc.composite_slabs_reference(*args),
                       iters=3, warmup=1)
    ops, dense_ops, live = composite_ops(torch, args)
    n_bytes = nbytes(*args) + 4 * args[5].numel() * 4
    b_ms, b_by = bound_ms(n_bytes, ops, H100_FP32_FLOPS)
    rec = {"phase": f"composite_slabs[{name}]", "form": "lut" if args[7]
           is not None else "controls", "kc": int(args[6].shape[0]),
           "shape": {"D": args[0].shape[0], "ay": args[0].shape[1],
                     "ax": args[0].shape[2], "hi": args[5].shape[0],
                     "wi": args[5].shape[1]},
           "max_abs_err": err, "tol": COMP_ATOL[name], "ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
           "bound_by": b_by, "mbytes": n_bytes / 1e6,
           "needed_gflop": ops / 1e9, "dense_gflop": dense_ops / 1e9,
           "live_pixel_slab_share": live / args[0].shape[0] / args[5].numel(),
           "alpha_max": float(ref_a.max())}
    log(rec)
    if not err <= COMP_ATOL[name] or not rec["alpha_max"] > 0.05:
        raise AssertionError(f"composite_slabs kernel disagrees: {rec}")
    return rec


def ext_ops(torch, args):
    """composite_ops for composite_slabs_ext: the same live pixel-slabs,
    their nonzero resample products for every field (value, gradient,
    shadow), classification, and the shading and shadow operations of
    SHADE_OPS and SHADOW_OPS. Returns (needed, dense resample, live
    pixel-slabs)."""
    fields, svol, my_all, mx_all, covy, covx, corr = args[:7]
    ctrl, lut = args[10], args[13]
    d, c_f, ay, ax = fields.shape
    hi, wi = corr.shape
    nf = c_f + (svol is not None)
    per_px = (18 + (17 if lut is not None else 12 * (ctrl.shape[0] - 1))
              + (SHADE_OPS if c_f == 4 else 0)
              + (SHADOW_OPS if svol is not None else 0))
    ops, dense, live = composite_ops(torch, (fields[:, 0], my_all, mx_all,
                                             covy, covx, corr, ctrl, lut),
                                     per_px=per_px, n_fields=nf)
    return ops, dense, live


def phase_composite_ext(torch, name, tf, volume, grads, shadow):
    from instantvnr_torch.ops import slab_composite as sc

    shade = "shaded" in name
    args = composite_inputs(torch, tf, orbit(1, N_FRAMES, max(DIMS)), volume,
                            "gradient" if shade else "none",
                            grads if shade else None,
                            shadow if "shadow" in name else None)
    got_c, got_a = sc.composite_slabs_ext(*args)
    ref_c, ref_a = sc.composite_slabs_ext_reference(*args)
    torch.cuda.synchronize()
    err = max(float((got_c - ref_c).abs().max()),
              float((got_a - ref_a).abs().max()))
    ms = cuda_ms(torch, lambda: sc.composite_slabs_ext(*args), iters=10)
    plain_ms = cuda_ms(torch, lambda: sc.composite_slabs_ext_reference(*args),
                       iters=3, warmup=1)
    ops, dense_ops, live = ext_ops(torch, args)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    n_bytes = nbytes(*tensors) + 4 * args[6].numel() * 4
    b_ms, b_by = bound_ms(n_bytes, ops, H100_FP32_FLOPS)
    fields = args[0]
    rec = {"phase": f"composite_slabs_ext[{name}]",
           "form": "lut" if args[13] is not None else "controls",
           "kc": int(args[10].shape[0]),
           "shape": {"D": fields.shape[0], "C": fields.shape[1],
                     "shadow": args[1] is not None, "ay": fields.shape[2],
                     "ax": fields.shape[3], "hi": args[6].shape[0],
                     "wi": args[6].shape[1]},
           "max_abs_err": err, "tol": EXT_ATOL[name], "ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
           "bound_by": b_by, "mbytes": n_bytes / 1e6,
           "needed_gflop": ops / 1e9, "dense_gflop": dense_ops / 1e9,
           "live_pixel_slab_share": live / fields.shape[0] / args[6].numel(),
           "alpha_max": float(ref_a.max())}
    log(rec)
    if not err <= EXT_ATOL[name] or not rec["alpha_max"] > 0.05:
        raise AssertionError(f"composite_slabs_ext kernel disagrees: {rec}")
    return rec


def iso_ops(torch, args, iso):
    """Operations the sweep's inputs need: at each slab only the pixels
    covered and not yet hit (replayed here in plain PyTorch) need their
    nonzero resample products for the 4 fields and ISO_OPS of the crossing
    test. Returns (needed, dense resample, live pixel-slabs)."""
    fields, my_all, mx_all, covy, covx = args
    d, _, ay, ax = fields.shape
    hi, wi = my_all.shape[1], mx_all.shape[1]
    nnz_my = (my_all != 0).sum(-1)
    nnz_mx = (mx_all != 0).sum(-1)
    found = torch.zeros((hi, wi), dtype=torch.bool, device=fields.device)
    prev_v = torch.zeros((hi, wi), dtype=torch.float32, device=fields.device)
    prev_ok = torch.zeros_like(found)
    ops = torch.zeros((), dtype=torch.float64, device=fields.device)
    live_total = torch.zeros_like(ops)
    for k in range(d):
        cov = (covy[k][:, None] * covx[k][None, :]) != 0
        live = cov & ~found
        rows = live.any(dim=1)
        ops += 4 * 2 * ax * (nnz_my[k] * rows).sum()
        ops += (live * (4 * 2 * nnz_mx[k][None, :] + ISO_OPS)).sum()
        live_total += live.sum()
        vals = my_all[k] @ fields[k, 0] @ mx_all[k].T
        found |= prev_ok & cov & ((prev_v - iso) * (vals - iso) <= 0.0)
        prev_v, prev_ok = vals, cov
    return float(ops), 4 * 2 * d * (hi * ay * ax + hi * wi * ax), \
        int(live_total)


def phase_iso_sweep(torch, volume, grads, iso):
    from instantvnr_torch.ops import iso_sweep as isw
    from instantvnr_torch.render.isosurf import IsoSettings, slab_iso_args
    from instantvnr_torch.render.slabmarch import camera_arrays, principal_axis

    cam = orbit(1, N_FRAMES, max(DIMS))
    axis, flipped = principal_axis(cam)
    args, _ = slab_iso_args(volume, grads, SIZE, SIZE, IsoSettings(), axis,
                            flipped, camera_arrays(cam, "cuda"))
    f1, z1, g1 = isw.iso_sweep(*args, iso)
    f2, z2, g2 = isw.iso_sweep_reference(*args, iso)
    torch.cuda.synchronize()
    agree = float((f1 == f2).float().mean())
    both = (f1 > 0.5) & (f2 > 0.5)
    err = max(float((z1 - z2)[both].abs().max()),
              float((g1 - g2)[both].abs().max()))
    ms = cuda_ms(torch, lambda: isw.iso_sweep(*args, iso), iters=10)
    plain_ms = cuda_ms(torch, lambda: isw.iso_sweep_reference(*args, iso),
                       iters=3, warmup=1)
    ops, dense_ops, live = iso_ops(torch, args, iso)
    hi, wi = f1.shape
    n_bytes = nbytes(*args) + 10 * hi * wi * 4
    b_ms, b_by = bound_ms(n_bytes, ops, H100_FP32_FLOPS)
    rec = {"phase": "iso_sweep", "iso": iso,
           "shape": {"D": args[0].shape[0], "ay": args[0].shape[2],
                     "ax": args[0].shape[3], "hi": hi, "wi": wi},
           "found_agree": agree, "found_agree_min": ISO_FOUND_AGREE,
           "max_abs_err": err, "tol": ISO_ATOL, "ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
           "bound_by": b_by, "mbytes": n_bytes / 1e6,
           "needed_gflop": ops / 1e9, "dense_gflop": dense_ops / 1e9,
           "live_pixel_slab_share": live / args[0].shape[0] / (hi * wi),
           "hit_share": float(f2.mean())}
    log(rec)
    if (agree < ISO_FOUND_AGREE or not err <= ISO_ATOL
            or not rec["hit_share"] > 0.05):
        raise AssertionError(f"iso_sweep kernel disagrees: {rec}")
    return rec


def phase_small_parity(torch):
    """The whole slice at a small size on the card (kernels) against the
    same slice on the CPU (plain versions), in every ported view."""
    from instantvnr_torch import api
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig)
    from instantvnr_torch.models.network import params_from_numpy

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=4,
                                              n_features_per_level=2,
                                              log2_hashmap_size=12),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=2))
    views = ("plain", "shaded+shadow", "full_shadow", "isosurface_decoded",
             "isosurface_reference")
    frames = {}
    for dev in ("cpu", "cuda"):
        sv = api.SimpleVolume.synthetic((32, 32, 32), "vorts", device=dev)
        nv = api.NeuralVolume(cfg, sv, device=dev)
        nv.params = params_from_numpy(seeded_params(nv.field, SEED + 3), dev)
        r = api.VNRenderer(nv, 40, 37)
        r.set_camera(orbit(2, N_FRAMES, 32))
        for view in views:
            if view == "shaded+shadow":
                r.set_slab_shading("gradient")
                r.enable_shadows()
            elif view == "full_shadow":
                r.set_slab_shading("none")
                r.disable_shadows()
                r.set_mode(api.RenderMode.FULL_SHADOW_DECODED)
            elif view.startswith("isosurface"):
                r.set_mode(api.RenderMode[view.upper()])
                r.set_isovalue(0.5)
            r.render()
            frames[dev, view] = r.mapframe()
    tol = 5e-3
    for view in views:
        diff = np.abs(frames["cuda", view] - frames["cpu", view])
        # a first hit within float32 noise of the isovalue may flip a pixel
        # of an isosurface view; the volume views hold every pixel
        share = float((diff.max(-1) <= tol).mean())
        rec = {"phase": f"small_slice_cuda_vs_cpu[{view}]",
               "max_abs_err": float(diff.max()), "tol": tol,
               "share_within_tol": share,
               "share_min": 0.995 if view.startswith("iso") else 1.0,
               "alpha_max": float(frames["cpu", view][..., 3].max())}
        log(rec)
        if share < rec["share_min"] or not rec["alpha_max"] > 0.05:
            raise AssertionError(f"small slice disagrees: {rec}")


def phase_breakdown(torch, nv, renderer, r_iso):
    """Where the main path's time goes: each stage of one decode blob and
    of one frame of each view timed alone with CUDA events, on the main
    path's inputs."""
    from instantvnr_torch.models.metrics import _grid_coords_slab
    from instantvnr_torch.models.network import render_params
    from instantvnr_torch.ops.fused_mlp import fused_mlp_apply
    from instantvnr_torch.ops.hash_encoding import hash_encode_packed
    from instantvnr_torch.render.raymarch import DEFAULT_LIGHT
    from instantvnr_torch.render.shadow import shadow_volume_for
    from instantvnr_torch.render.slabmarch import (_final_warp, camera_arrays,
                                                   compute_gradient_volumes,
                                                   principal_axis,
                                                   slab_composite_args)

    field = nv.field
    rp = render_params(nv.params, field)
    dev = nv.device
    coords = _grid_coords_slab(nv.dims, 0, 16, dev)
    feats = hash_encode_packed(rp["table"], rp["packed"], coords, field.spec,
                               compute_dtype=torch.bfloat16)
    cam = orbit(1, N_FRAMES, max(DIMS))
    impl = renderer._impl
    axis, flipped = principal_axis(cam)
    cam_arrays = camera_arrays(cam, dev)

    def inputs(settings, grads=None, shadow=None):
        return slab_composite_args(
            impl.decoded, impl.tf, cam_arrays, SIZE, SIZE, settings, axis,
            flipped, None, impl.transform, grads, shadow)

    comp, args, warp = inputs(impl.settings)
    color, alpha = comp(*args)
    grads = compute_gradient_volumes(impl.decoded)
    shadow = shadow_volume_for(impl.decoded, impl.tf, DEFAULT_LIGHT)
    shaded = dataclasses.replace(impl.settings, shading="gradient")
    comp_ext, args_ext, _ = inputs(shaded, grads, shadow)

    def frame(r):
        r.set_camera(cam)
        r.render()
        return r.mapframe()

    rec = {"phase": "breakdown",
           "render_params_ms": cuda_ms(torch, lambda: render_params(
               nv.params, field), iters=5),
           "blob_coords_ms": cuda_ms(torch, lambda: _grid_coords_slab(
               nv.dims, 0, 16, dev)),
           "blob_hash_encode_ms": cuda_ms(torch, lambda: hash_encode_packed(
               rp["table"], rp["packed"], coords, field.spec,
               compute_dtype=torch.bfloat16), iters=10),
           "blob_fused_mlp_ms": cuda_ms(torch, lambda: fused_mlp_apply(
               rp["mlp"], feats, field.cfg.network)),
           "frame_inputs_ms": cuda_ms(torch, lambda: inputs(impl.settings),
                                      iters=10),
           "frame_composite_ms": cuda_ms(torch, lambda: comp(*args),
                                         iters=10),
           "frame_warp_ms": cuda_ms(torch, lambda: _final_warp(
               color, alpha, *warp)),
           "frame_total_ms": cuda_ms(torch, lambda: frame(renderer),
                                     iters=10),
           # once per decode, and once per light change or decode
           "gradient_volumes_ms": cuda_ms(
               torch, lambda: compute_gradient_volumes(impl.decoded)),
           "shadow_volume_ms": cuda_ms(torch, lambda: shadow_volume_for(
               impl.decoded, impl.tf, DEFAULT_LIGHT), iters=5),
           # a shaded + shadowed frame's compositor inputs and kernel
           "frame_inputs_ext_ms": cuda_ms(
               torch, lambda: inputs(shaded, grads, shadow), iters=10),
           "frame_composite_ext_ms": cuda_ms(
               torch, lambda: comp_ext(*args_ext), iters=10),
           "iso_frame_total_ms": cuda_ms(torch, lambda: frame(r_iso),
                                         iters=10)}
    log(rec)
    return rec


def counters():
    """Every kernel's launch counter, by kernel name."""
    from instantvnr_torch.ops import fused_mlp as fm
    from instantvnr_torch.ops import iso_sweep as isw
    from instantvnr_torch.ops import slab_composite as sc

    return {"fused_mlp": fm.counter, "composite_slabs": sc.counter,
            "composite_slabs_ext": sc.ext_counter, "iso_sweep": isw.counter}


def run_orbit(torch, r, name):
    """An orbit of N_FRAMES through the renderer, each frame timed on the
    host clock from set_camera to the frame on the host; every launch count
    is set to 0 before and read after."""
    for c in counters().values():
        c.reset()
    frame_ms, alpha_max, rgb_mean, hit_share = [], [], [], []
    for i in range(N_FRAMES):
        t0 = time.perf_counter()
        r.set_camera(orbit(i, N_FRAMES, max(DIMS)))
        r.render()
        frame = r.mapframe()  # copies to the host: the frame is done
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if frame.shape != (SIZE, SIZE, 4) or not np.isfinite(frame).all():
            raise AssertionError(f"{name} frame {i}: bad shape or non-finite")
        alpha_max.append(float(frame[..., 3].max()))
        rgb_mean.append(float(frame[..., :3].mean()))
        hit_share.append(float((frame[..., 3] > 0.5).mean()))
    steady = frame_ms[1:]
    return {"phase": name, "first_frame_ms": frame_ms[0],
            "ms_per_frame": float(np.mean(steady)),
            "ms_per_frame_median": float(np.median(steady)),
            "fps": 1e3 / float(np.mean(steady)), "frames": N_FRAMES,
            "alpha_max_min": min(alpha_max),
            "rgb_mean": float(np.mean(rgb_mean)),
            "hit_share_min": min(hit_share),
            "launches": {n: c.launches for n, c in counters().items()}}


def check_launches(rec, launched):
    """Every kernel launched exactly as `launched` says, others never."""
    expect = {name: 0 for name in counters()}
    expect.update(launched)
    if rec["launches"] != expect:
        raise AssertionError(f"{rec['phase']}: launches {rec['launches']} != "
                             f"{expect}")


def phase_views(torch, nv, r, plain):
    """The four views of this slice, each a 12-frame orbit on the same
    NeuralVolume and decode as the unshaded orbit `plain`."""
    from instantvnr_torch import api

    views = []

    def check(rec, launched):
        log(rec)
        check_launches(rec, launched)
        if not rec["alpha_max_min"] > 0.05:
            raise AssertionError(f"{rec['phase']}: invisible frame")
        views.append(rec)

    r.set_slab_shading("gradient")
    check(run_orbit(torch, r, "view_shaded"),
          {"composite_slabs_ext": N_FRAMES})
    r.enable_shadows()
    check(run_orbit(torch, r, "view_shaded_shadowed"),
          {"composite_slabs_ext": N_FRAMES})
    r.set_slab_shading("none")
    r.disable_shadows()
    r.set_mode(api.RenderMode.FULL_SHADOW_DECODED)
    rec = run_orbit(torch, r, "view_full_shadow_decoded")
    rec["rgb_mean_unshaded"] = plain["rgb_mean"]
    check(rec, {"composite_slabs_ext": N_FRAMES})
    if not rec["rgb_mean"] < plain["rgb_mean"]:
        raise AssertionError("FULL_SHADOW_DECODED frames are not darker than "
                             f"the unshaded ones: {rec['rgb_mean']} vs "
                             f"{plain['rgb_mean']}")

    for c in counters().values():
        c.reset()
    t0 = time.perf_counter()
    r.set_mode(api.RenderMode.ISOSURFACE_DECODED)  # decode_volume()
    iso = float(nv.decode_volume().median())
    r.set_isovalue(iso)
    torch.cuda.synchronize()
    set_mode_ms = (time.perf_counter() - t0) * 1e3
    decode_launches = counters()["fused_mlp"].launches
    rec = run_orbit(torch, r, "view_isosurface_decoded")
    rec.update(isovalue=iso, set_mode_ms=set_mode_ms,
               decode_launches=decode_launches)
    check(rec, {"iso_sweep": N_FRAMES})
    if decode_launches != 8:
        raise AssertionError(f"ISOSURFACE_DECODED's decode_volume launched "
                             f"fused_mlp {decode_launches} times, not 8")
    if not rec["hit_share_min"] >= 0.05:
        raise AssertionError(f"isosurface hits under 5% of a frame: {rec}")
    return views


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig, TransferFunctionConfig
    from instantvnr_torch.models.network import params_from_numpy
    from instantvnr_torch.ops.cuda_lib import load_library
    from instantvnr_torch.render.raymarch import DEFAULT_LIGHT
    from instantvnr_torch.render.shadow import shadow_volume_for
    from instantvnr_torch.render.slabmarch import compute_gradient_volumes
    from instantvnr_torch.utils.tfn import bake_transfer_function

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log({"phase": "env", "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0],
         "device": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count()})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log({"phase": "precision", "matmul_allow_tf32": False,
         "cudnn_allow_tf32": False})

    lib = load_library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    log({"phase": "build", "seconds": lib.build_seconds,
         "library": os.path.relpath(lib.path, ROOT), "ptxas": ptxas})

    # -- kernel phases: each kernel against its plain version -------------
    sv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cuda")
    vol = sv.volume.data
    blob_rows = DIMS[0] * DIMS[1] * 16
    mlp = phase_fused_mlp(torch, blob_rows)
    knots = np.linspace(0.0, 1.0, 70)
    alphas = np.random.default_rng(SEED + 4).uniform(0.0, 0.9, 70)
    tf70 = bake_transfer_function(TransferFunctionConfig(
        colors=((0.0, 0.2, 0.3, 0.9), (0.5, 0.9, 0.6, 0.1),
                (1.0, 1.0, 0.2, 0.2)),
        alphas=tuple((float(a), float(b)) for a, b in zip(knots, alphas))),
        device="cuda")
    comp = phase_composite(torch, "default", sv.tf, vol)
    phase_composite(torch, "lut70", tf70, vol)
    grads = compute_gradient_volumes(vol)
    shadow = shadow_volume_for(vol, sv.tf, DEFAULT_LIGHT)
    ext = {name: phase_composite_ext(torch, name, tf, vol, grads, shadow)
           for name, tf in (("shaded", sv.tf), ("shadow", sv.tf),
                            ("shaded+shadow", sv.tf),
                            ("shaded,lut70", tf70))}
    iso = phase_iso_sweep(torch, vol, grads, float(vol.median()))
    phase_small_parity(torch)

    # -- main path: counts from 0, then decode + an orbit of frames --------
    nv = api.NeuralVolume(ModelConfig(), sv, device="cuda")
    nv.params = params_from_numpy(seeded_params(nv.field, SEED), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters().values():
        c.reset()
    t0 = time.perf_counter()
    nv.ensure_decoded(SIZE, SIZE)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    decode_launches = counters()["fused_mlp"].launches
    r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode.DECODED_SLAB)
    rec = run_orbit(torch, r, "main_path")
    grid = nv.get_decoder().decoded
    rec.update(model="ModelConfig() 2^19, 8x8 levels, 64x4 MLP",
               volume=f"vorts {DIMS}", frame=f"{SIZE}^2",
               decode_ms=decode_ms, decode_launches=decode_launches,
               grid_mean=float(grid.mean()), grid_std=float(grid.std()))
    log(rec)
    plain = rec
    if decode_launches != nv.n_blobs or nv.n_blobs != 8:
        raise AssertionError(f"decode launched fused_mlp {decode_launches} "
                             f"times for {nv.n_blobs} blobs")
    check_launches(rec, {"composite_slabs": N_FRAMES})
    if rec["alpha_max_min"] <= 0.05:
        raise AssertionError(f"invisible frame: {rec}")

    # -- the views of this slice on the same decode -----------------------
    views = phase_views(torch, nv, r, plain)
    log({"phase": "main_path_memory",
         "max_memory_allocated": torch.cuda.max_memory_allocated()})
    phase_breakdown(torch, nv, api.VNRenderer(nv, SIZE, SIZE), r)

    # -- BSON checkpoint round trip ---------------------------------------
    ckpt_dir = os.path.join(ROOT, "instantvnr_torch", "_build")
    os.makedirs(ckpt_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ckpt_dir) as tmp:
        path = os.path.join(tmp, "smoke.bson")
        nv.save_params(path)
        nv2 = api.NeuralVolume.from_checkpoint(path, device="cuda")
        r2 = api.VNRenderer(nv2, SIZE, SIZE)
        r2.set_camera(orbit(0, N_FRAMES, max(DIMS)))
        r2.render()
        f2 = r2.mapframe()
        ckpt_bytes = os.path.getsize(path)
    if not np.isfinite(f2).all() or not f2[..., 3].max() > 0.05:
        raise AssertionError("checkpoint round trip rendered a bad frame")
    log({"phase": "bson_roundtrip", "alpha_max": float(f2[..., 3].max()),
         "bytes": ckpt_bytes})

    # launches: totals over the main-path runs (the plain orbit with its
    # decode, then the four views)
    runs = [plain] + views
    total = {name: sum(v["launches"][name] for v in runs)
             for name in counters()}
    total["fused_mlp"] += decode_launches + views[-1]["decode_launches"]
    csrc = "instantvnr_torch/csrc/"
    tpu = "instantvnr_tpu/ops/pallas/"

    def row(name, source, replaces, rec):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": tpu + replaces, "launches": total[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]}

    kernels = [
        row("fused_mlp", "fused_mlp.cu", "fused_mlp.py:135", mlp),
        row("composite_slabs", "slab_composite.cu", "slab_composite.py:242",
            comp),
        row("composite_slabs_ext", "slab_composite.cu",
            "slab_composite.py:292", ext["shaded+shadow"]),
        row("iso_sweep", "iso_sweep.cu", "iso_sweep.py:99", iso),
    ]
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
