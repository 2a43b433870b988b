#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root; needs one card)

Builds the CUDA kernels from instantvnr_torch/csrc with nvcc, holds each
kernel to its plain PyTorch version at the main path's shapes and times
both, then drives the main path through the user-facing entry points:
SimpleVolume.synthetic (vorts 128³) → NeuralVolume(ModelConfig()), the
2^19 reference schema with seeded random weights → VNRenderer(512²,
DECODED_SLAB): one full decode and an orbit of frames, with launch counts
proving both kernels ran, and a breakdown of where a blob's and a frame's
time goes; then a BSON checkpoint round trip. Any failed
phase raises, so the script exits non-zero. The last line is the JSON
result; the line before it lists every kernel with its numbers.
"""
from __future__ import annotations

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


def composite_inputs(torch, tf, cam, volume):
    from instantvnr_torch.render.slabmarch import (SlabSettings, camera_arrays,
                                                   principal_axis,
                                                   slab_composite_args)

    axis, flipped = principal_axis(cam)
    args, _ = slab_composite_args(volume, tf, camera_arrays(cam, "cuda"),
                                  SIZE, SIZE, SlabSettings(), axis, flipped)
    return args


def composite_ops(torch, args):
    """Operations these inputs need, counting an FMA as 2: only pixels and
    slabs that are covered and not yet terminated (replayed here in plain
    PyTorch) need work. Each needs its nonzero resample products (a row of
    My or Mx has at most 2 nonzeros), then per pixel: normalize 4,
    termination test 1, classify (per control segment 12: v-x0, divide,
    clamp 2, 4 FMAs, as a segment's width and channel differences are
    constants; LUT 17: scale, floor, clamp 2, frac, 4 x (difference, FMA)),
    opacity correction 4, blend 9. Returns (needed, dense resample, live
    pixel-slabs)."""
    from instantvnr_torch.ops import slab_composite as sc

    vol, my_all, mx_all, covy, covx, corr, ctrl, lut = args
    d, ay, ax = vol.shape
    hi, wi = corr.shape
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
        ops += 2 * ax * (nnz_my[k] * rows).sum()  # tmp rows that are needed
        ops += (live * (2 * nnz_mx[k][None, :] + per_px)).sum()
        live_total += live.sum()
        vals = my_all[k] @ vol[k] @ mx_all[k].T
        a = sc._classify_packed(ctrl, lut, vals)[..., 3]
        alpha = 1.0 - torch.pow(torch.clamp(1.0 - a, min=0.0), corr)
        trans = trans * (1.0 - alpha * live)
    return float(ops), 2 * d * (hi * ay * ax + hi * wi * ax), \
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


def phase_small_parity(torch):
    """The whole slice at a small size on the card (kernels) against the
    same slice on the CPU (plain versions)."""
    from instantvnr_torch import api
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig)
    from instantvnr_torch.models.network import params_from_numpy

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=4,
                                              n_features_per_level=2,
                                              log2_hashmap_size=12),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=2))
    frames = {}
    for dev in ("cpu", "cuda"):
        sv = api.SimpleVolume.synthetic((32, 32, 32), "vorts", device=dev)
        nv = api.NeuralVolume(cfg, sv, device=dev)
        nv.params = params_from_numpy(seeded_params(nv.field, SEED + 3), dev)
        r = api.VNRenderer(nv, 40, 37)
        r.set_camera(orbit(2, N_FRAMES, 32))
        r.render()
        frames[dev] = r.mapframe()
    err = float(np.abs(frames["cuda"] - frames["cpu"]).max())
    rec = {"phase": "small_slice_cuda_vs_cpu", "max_abs_err": err,
           "tol": 5e-3, "alpha_max": float(frames["cpu"][..., 3].max())}
    log(rec)
    if not err <= 5e-3 or not rec["alpha_max"] > 0.05:
        raise AssertionError(f"small slice disagrees: {rec}")


def phase_breakdown(torch, nv, renderer):
    """Where the main path's time goes: each stage of one decode blob and
    one frame timed alone with CUDA events, on the main path's inputs."""
    from instantvnr_torch.models.metrics import _grid_coords_slab
    from instantvnr_torch.models.network import render_params
    from instantvnr_torch.ops.fused_mlp import fused_mlp_apply
    from instantvnr_torch.ops.hash_encoding import hash_encode_packed
    from instantvnr_torch.ops.slab_composite import composite_slabs
    from instantvnr_torch.render.slabmarch import (_final_warp, camera_arrays,
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
    args, warp = slab_composite_args(
        impl.decoded, impl.tf, camera_arrays(cam, dev), SIZE, SIZE,
        impl.settings, axis, flipped, None, impl.transform)
    color, alpha = composite_slabs(*args)

    def frame():
        renderer.set_camera(cam)
        renderer.render()
        return renderer.mapframe()

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
           "frame_inputs_ms": cuda_ms(torch, lambda: slab_composite_args(
               impl.decoded, impl.tf, camera_arrays(cam, dev), SIZE, SIZE,
               impl.settings, axis, flipped, None, impl.transform), iters=10),
           "frame_composite_ms": cuda_ms(torch, lambda: composite_slabs(
               *args), iters=10),
           "frame_warp_ms": cuda_ms(torch, lambda: _final_warp(
               color, alpha, *warp)),
           "frame_total_ms": cuda_ms(torch, frame, iters=10)}
    log(rec)
    return rec


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
    from instantvnr_torch.ops import fused_mlp as fm
    from instantvnr_torch.ops import slab_composite as sc
    from instantvnr_torch.ops.cuda_lib import load_library
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
             if "registers" in ln or "Compiling entry" in ln]
    log({"phase": "build", "seconds": lib.build_seconds,
         "library": os.path.relpath(lib.path, ROOT), "ptxas": ptxas})

    # -- kernel phases: each kernel against its plain version -------------
    sv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cuda")
    blob_rows = DIMS[0] * DIMS[1] * 16
    mlp = phase_fused_mlp(torch, blob_rows)
    knots = np.linspace(0.0, 1.0, 70)
    alphas = np.random.default_rng(SEED + 4).uniform(0.0, 0.9, 70)
    tf70 = bake_transfer_function(TransferFunctionConfig(
        colors=((0.0, 0.2, 0.3, 0.9), (0.5, 0.9, 0.6, 0.1),
                (1.0, 1.0, 0.2, 0.2)),
        alphas=tuple((float(a), float(b)) for a, b in zip(knots, alphas))),
        device="cuda")
    comp = phase_composite(torch, "default", sv.tf, sv.volume.data)
    phase_composite(torch, "lut70", tf70, sv.volume.data)
    phase_small_parity(torch)

    # -- main path: counts from 0, then decode + an orbit of frames --------
    nv = api.NeuralVolume(ModelConfig(), sv, device="cuda")
    nv.params = params_from_numpy(seeded_params(nv.field, SEED), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.counter.reset()
    sc.counter.reset()
    t0 = time.perf_counter()
    nv.ensure_decoded(SIZE, SIZE)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    decode_launches = fm.counter.launches
    r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode.DECODED_SLAB)
    frame_ms, alpha_max = [], []
    for i in range(N_FRAMES):
        r.set_camera(orbit(i, N_FRAMES, max(DIMS)))
        t0 = time.perf_counter()
        r.render()
        frame = r.mapframe()  # copies to the host: the frame is done
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if frame.shape != (SIZE, SIZE, 4) or not np.isfinite(frame).all():
            raise AssertionError(f"frame {i}: bad shape or non-finite")
        alpha_max.append(float(frame[..., 3].max()))
    launches = {"fused_mlp": fm.counter.launches,
                "composite_slabs": sc.counter.launches}
    grid = nv.get_decoder().decoded
    steady = frame_ms[1:]
    rec = {"phase": "main_path", "model": "ModelConfig() 2^19, 8x8 levels, "
           "64x4 MLP", "volume": f"vorts {DIMS}", "frame": f"{SIZE}^2",
           "decode_ms": decode_ms, "first_frame_ms": frame_ms[0],
           "ms_per_frame": float(np.mean(steady)),
           "ms_per_frame_median": float(np.median(steady)),
           "fps": 1e3 / float(np.mean(steady)), "frames": N_FRAMES,
           "alpha_max_min": min(alpha_max), "launches": launches,
           "decode_launches": decode_launches,
           "grid_mean": float(grid.mean()), "grid_std": float(grid.std()),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(rec)
    if decode_launches != nv.n_blobs or nv.n_blobs != 8:
        raise AssertionError(f"decode launched fused_mlp {decode_launches} "
                             f"times for {nv.n_blobs} blobs")
    if launches["fused_mlp"] != 8 or launches["composite_slabs"] != N_FRAMES:
        raise AssertionError(f"kernel launches {launches} != one per blob "
                             f"and one per frame")
    if min(alpha_max) <= 0.05:
        raise AssertionError(f"invisible frame: alpha max {alpha_max}")
    phase_breakdown(torch, nv, r)

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

    kernels = [
        {"name": "fused_mlp", "route": "cuda",
         "source": "instantvnr_torch/csrc/fused_mlp.cu",
         "replaces": "instantvnr_tpu/ops/pallas/fused_mlp.py:135",
         "launches": launches["fused_mlp"],
         "max_abs_err": mlp["max_abs_err"], "ms": mlp["ms"],
         "plain_ms": mlp["plain_ms"], "bound_ms": mlp["bound_ms"],
         "bound_by": mlp["bound_by"], "library_ms": mlp["library_ms"]},
        {"name": "composite_slabs", "route": "cuda",
         "source": "instantvnr_torch/csrc/slab_composite.cu",
         "replaces": "instantvnr_tpu/ops/pallas/slab_composite.py:242",
         "launches": launches["composite_slabs"],
         "max_abs_err": comp["max_abs_err"], "ms": comp["ms"],
         "plain_ms": comp["plain_ms"], "bound_ms": comp["bound_ms"],
         "bound_by": comp["bound_by"], "library_ms": None},
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
