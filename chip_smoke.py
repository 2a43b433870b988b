#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root; needs one card)

Builds the CUDA kernels from instantvnr_torch/csrc with nvcc (and checks
in their SASS that the fused-MLP kernels run on the tensor cores), holds
each kernel to its plain PyTorch version at the main path's shapes and
times both, then drives the main paths through the user-facing entry
points:

- serving: SimpleVolume.synthetic (vorts 128³) → NeuralVolume(ModelConfig()),
  the 2^19 reference schema with seeded random weights → VNRenderer(512²,
  DECODED_SLAB): one full decode (through the hash-grid and fused-MLP
  kernels, held to the plain packed decode) and an orbit of frames; then
  on the same decode four more orbits: gradient shading, shading + shadows,
  FULL_SHADOW_DECODED and ISOSURFACE_DECODED; a breakdown of a blob and a
  frame; a BSON checkpoint round trip; small frames of volumes one voxel
  thick on the card against the CPU;
- the exact wavefront: raymarch_emit against its plain version on a 512²
  frame's rays; the seven wavefront modes (NEURAL_WAVEFRONT, _GRADIENT,
  _SSH with streaming_cache="none" on the 2^19 model, REFERENCE_RAYMARCH,
  _GRADIENT, _SSH, FULL_SHADOW_REFERENCE) at 512², with supersteps,
  launches and the device's busy time of a profiled frame; the same modes
  small on the card against the CPU; a degenerate camera in DECODED_SLAB
  (wavefront fallback) and ISOSURFACE_DECODED (brute-force marcher);
- the path tracer and the brick cache: pt_track and pt_resolve against
  their plain versions on a 512² frame's rays (after the first event and
  a later one), brick_sample against its plain version on a superstep's
  samples from four pools (f16 and f32, ss = 1 and 2); PATHTRACE_REFERENCE,
  _DECODED and _NEURAL at 512² (progressive frames, events, launches, a
  profiled frame, the mean against a longer run's); the brick wavefront
  (NEURAL_WAVEFRONT, _GRADIENT and _SSH on the default streaming_cache
  "auto", and "hq" and "lazy") at 512²; small path-traced frames on the
  card against the CPU from one uniform stream;
- checkpoints and CLI: a native .npz round trip that resumes exactly, and
  the port's CLI in-process (train → .npz → render → view_model);
- training: NeuralVolume.train(1000) at B = 2^16 on the 2^14 layout (PSNR
  and SSIM against the reference's bar, and against a control loop built
  here from the plain functions), on the 2^19 reference schema over three
  seeds, a breakdown of a step, and the online loop: rounds of train(10),
  a full re-decode and a frame;
- isosurfaces: mt_count + mt_emit against their plain version on the
  vorts 128³ grid and the serving model's decoded slabs (bit for bit),
  extract_isosurface_network on the 2^19 model (seeded and trained) with
  its stages and peak memory, and the grid path;
- real volumes in: a diva scene of two 256³ big-endian UNSIGNED_SHORT
  timesteps (load, train, DECODED_SLAB, switch the timestep, again),
  analytic training on the tubes field and out-of-core training from a
  512³ uint8 file through the native loader (its rate, the idle share,
  the in-core step beside it), and the data CLI (each --sampling-mode,
  vnr_cmd_isosurface, generate_shadow_map, a render of timestep 1);
- the interactive path: the port's vnr_int_online for 30 frames at 2^14
  (its default) and at 2^19 (each frame's launches held to the slice's:
  10 training steps through K1 train, K2, K3, K4, 2 decode blobs through
  K3 + K1, one composite_slabs), the web viewer in-process on 127.0.0.1
  driven over HTTP through a camera drag, a TF edit, shading and three
  modes with training on (its served frames a second, split into
  training, render and PNG encode), the facade's setters small on the
  card against the CPU with memory_query and free_temporary_memory, and
  vnr_cmd_render --profile writing a Chrome trace that names the kernels;
- the twelfth slice: the 10 × 7 DECODED_SLAB frame whose edge pixel sees
  a ray graze the volume (card against CPU, the pixel 0); K3 and K4 in the
  paired hash layout against their plain versions at the 2^19 schema,
  B = 2^16 and 2^19, timed beside the tcnn layout's; a 2^19 training step
  in each layout and the paired model's decode and frame; the
  differentiable march (RaymarchSettings.fixed_steps) on the 2^19 model at
  128², forward and backward timed, its launches exact, its gradients on
  the card against the CPU, and the same frame differentiated in its
  camera rays with the params frozen; fV-SRN trained, decoded, rendered
  (and against the CPU), through a native .npz and, imported from a torch state dict,
  through view_model; VDB files in OpenVDB's layout (a byte-built fixture,
  vorts 128³ written and read, trained on and rendered, a decode saved as
  .vdb);
- the thirteenth slice, parallelism on torch.distributed, in child
  processes (this process joins no group): a world-1 NCCL group runs 20
  data-parallel steps of the 2^19 model (the host-batch step against
  train_step_hostbatch bit for bit on one gradient, each step's launches
  exact, timed against the single-device step in turns) and the
  slab-sharded frame of the serving decode; two gloo ranks sharing the
  card run the DP step on split halves against the whole batch (and time
  its 93.6 MB all-reduce), the tensor-parallel step (levels 0-3 and 4-7,
  its gradient against the single-device one, 20 steps), two experts (50
  steps each, the stitched decode's PSNR and seam), the ray-sharded
  NEURAL_WAVEFRONT frame and the slab-sharded frames (plain and shadowed)
  against the single-device frames, with their collectives counted;
- the compacted driver: compact_rows and scatter_rows against their plain
  versions bit for bit (the band's and the tracer's leaves at m = 2^18
  with copy back, the select form at 2^21, edge sizes, all live and none
  live, a CUDA graph of three launches replayed with new flags;
  scatter_rows on three permutations), timed beside their bounds and
  PyTorch; then the compacted wavefront (six cells) and tracer (three
  modes) against the masked march, frame by frame, serialized, replayed
  and fused, with the compaction kernels' device time in a profiled
  fused frame;
- the coordinate gradient: hash_encode_coords_backward (the encoding's
  gradient with respect to its coordinates) on the 2^19 schema at
  B = 2^16, tcnn and paired layouts, f32 and bf16 compute, against its
  plain version and a float64 oracle, its bits equal over two launches,
  timed beside the plain version; the differentiable march's frame
  differentiated in its rays (above);
- the emission's backward: raymarch_emit_backward against its plain
  version (autograd of the plain emission) at the emission phase's shapes
  and the ray frame's, its bits equal over two launches, timed beside the
  plain version; in the ray-differentiated frame one launch for each
  emission whose outputs reach the loss, and the frame's backward split by
  device time (torch.profiler) into the emission's backward, the
  coordinate pass, K2 and the rest; the coordinate pass also on one
  sampling superstep's positions of that frame.

Launch counts, reset before each of these paths and read after it, prove
which kernels each ran. Any failed phase raises, so the script exits
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
# training: the reference's batch and step count (BENCH_r05's quality bar
# is 56.62 dB / SSIM 0.9997 at 2^14, a median of 52.85 dB at 2^19)
TRAIN_BATCH = 1 << 16
TRAIN_STEPS = 1000
SEEDS_2E14 = (0, 1, 2, 3, 4)
SEEDS_2E19 = (0, 1, 2)
TAIL_CHUNKS = 10  # the PSNR after each of the last 10 chunks of 10 steps
ONLINE_ROUNDS = 5
# the online app (apps/vnr_int_online.py): frames, steps and blobs a frame
ONLINE_FRAMES, ONLINE_STEPS, ONLINE_BLOBS = 30, 10, 2
# the viewer: seconds of served frames timed in DECODED_SLAB with training
VIEWER_WINDOW_S = 3.0
# bars: SSIM (kernel runs' median) and the 2^19 median are asserted; the
# 55 dB of one 2^14 run is reported against the measured spread (PERF.md);
# the kernel path may not lose more than KERNEL_LOSS_MAX_DB against its
# plain control, as the mean over 5 seeds of each run's tail median (the
# TPU's Pallas training lost 6 dB, instantvnr_tpu/models/network.py:214-220;
# a run's tail median spreads over about 2 dB, so a difference of two such
# means has a standard error of about 1.2 dB: 4 dB is 3 of them)
PSNR_BAR_2E14, SSIM_MIN, PSNR_MIN_2E19 = 55.0, 0.999, 49.0
KERNEL_LOSS_MAX_DB = 4.0
# a gradient's kernels, each launched once (K3, K1's training form, K2, K4)
GRAD_KERNELS = ("fused_mlp_train_forward", "fused_mlp_backward",
                "hash_encode_forward", "hash_encode_backward")
# a training step's: the gradient's, then Adam's tree in one launch
TRAIN_KERNELS = GRAD_KERNELS + ("adam_step",)
# the MLP backward against its plain version, as a share of each
# gradient's largest entry: dW sums float32 products in another order;
# dx is rounded to bf16 (one step is 2^-8 of its value)
MLP_DW_RTOL, MLP_DX_RTOL = 1e-3, 1e-2
# end to end, the rows to which the forward kernel and the plain forward
# hand the backward other inputs, as a share of B: an activation rounded to
# the other bf16 neighbour, or on the other side of a ReLU kink, where the
# tensor core's f32 sum differs from cuBLAS's in the last bits. Measured
# 0.31-0.35% of 2^16 rows over 5 seeds (PERF.md, scripts/compare_trees.py):
# 1% is about 3× the largest, and a fault in a rounding point parts nearly
# every row
PARTED_ROWS_MAX = 0.01
# the hash grid: bf16 features within a bf16 step at |v| ≤ 2 (the 8-corner
# sum in another order); the gradient table summed by float atomics in a
# varying order, held as tests/test_ops.py:257 holds its oracle
HASH_FWD_ATOL = 1e-2
HASH_BWD_ATOL, HASH_BWD_RTOL = 5e-4, 1e-4
# a full decode of the 2^19 model on the card: 8 blobs, each one K3 gather
# of the bf16 table and one fused_mlp launch
DECODE_LAUNCHES = {"fused_mlp": 8, "hash_encode_forward": 8}
# K4's device time: its kernel and the wrapper's zeroing of the table
K4_KERNELS = ("hash_encode_backward_kernel", "FillFunctor")
# the wavefront (render/raymarch.py): frames a mode in wavefront_views, and
# the f32 operations of one DDA probe of raymarch_emit (need_new and range
# tests 3, the probe point 7, per axis its cell 2 and exit 11, the flat
# index 10, the occupancy test 1, and an entered cell's rate and quantized
# step 17) and of one emitted slot (9), for its operations bound
WAVEFRONT_FRAMES = 2
EMIT_PROBE_OPS, EMIT_SLOT_OPS = 77, 9
WAVEFRONT_MODES = ("NEURAL_WAVEFRONT", "NEURAL_WAVEFRONT_GRADIENT",
                   "NEURAL_WAVEFRONT_SSH", "REFERENCE_RAYMARCH",
                   "REFERENCE_GRADIENT", "REFERENCE_SSH",
                   "FULL_SHADOW_REFERENCE")
# a small wavefront frame on the card against the CPU, from the same
# jitter: the emission is exact on both devices; the neural modes' samples
# part where the fused MLP rounds a bf16 activation the other way (the
# decode's tolerance), and through a steep transfer function a pixel may
# move far: the pixels within 5e-3 of the CPU's must be at least
# WAVEFRONT_SHARE_MIN of the frame (2 of 1,480 parted in PR 7's run)
WAVEFRONT_SHARE_MIN = 0.99
# the path tracer (render/pathtrace.py): its three modes, the progressive
# frames a mode is timed over and the longer run its mean is held to
# (PT_MEAN_BAND of the longer mean: the MC noise of a 512² frame's mean is
# well under 1%); pt_kernels compares at the first event and at
# PT_LATE_EVENT (shadow rays in flight); pt_resolve's floats within
# PT_RESOLVE_RTOL of max(1, |x|) (log1pf, sinf and cosf of two builds of
# the CUDA math library); small frames on the card against the CPU: at
# least PT_SHARE_MIN of the pixels within PT_PIXEL_TOL (a path parts where
# those functions, or the network's bf16 rounding, differ)
PT_MODES = ("PATHTRACE_REFERENCE", "PATHTRACE_DECODED", "PATHTRACE_NEURAL")
PT_FRAMES, PT_LONG_FRAMES, PT_MEAN_BAND = 4, 12, 0.05
PT_LATE_EVENT = 12
PT_RESOLVE_RTOL = 1e-6
PT_PIXEL_TOL, PT_SHARE_MIN = 1e-5, 0.99
# f32 operations for the bounds: a tracking probe of pt_track (the probe
# point 7, per axis its cell 3 and exit 11, the flat index 10, majorant,
# clamps and the crossing test 10), pt_resolve's control chain a segment
# (sub, div, 2 clamps, 4 × sub, mul, add) and the rest of its event
# (classification set-up 4, decisions 10, radiance 12, the sphere ~50 with
# sin and cos, roulette 10, phase 6, restart ~30), brick_sample a sample
# (per axis ~15, weights 22, the sum 15)
PT_PROBE_OPS, PT_CONTROL_OPS, PT_RESOLVE_OPS = 60, 16, 122
BRICK_SAMPLE_OPS = 82
# brick_sample's pools: (name, dtype, supersample, lattice)
BRICK_POOLS = (("f16,ss1,exact", "float16", 1, "exact"),
               ("f32,ss1,decoded", "float32", 1, "decoded"),
               ("f16,ss2,exact", "float16", 2, "exact"),
               ("f32,ss2,exact", "float32", 2, "exact"))
# the brick wavefront: (mode, streaming_cache)
BRICK_WAVEFRONT = (("NEURAL_WAVEFRONT", "auto"),
                   ("NEURAL_WAVEFRONT_GRADIENT", "auto"),
                   ("NEURAL_WAVEFRONT_SSH", "auto"),
                   ("NEURAL_WAVEFRONT", "hq"), ("NEURAL_WAVEFRONT", "lazy"))
# an .npz resume on the card: params and moments after one more step, as a
# share of each array's largest entry (K4's atomics sum in a varying order)
NPZ_RTOL = 1e-5
# the ninth slice's training runs (2^19; analytic 250 steps, out-of-core
# 230) must have learned: over a floor and by at least DATA_PSNR_GAIN over
# the same model untrained (both PSNRs are logged)
DATA_PSNR_MIN = 20.0
DATA_PSNR_GAIN = 5.0
# an out-of-core run and an in-core twin fed the same coords (targets
# sampled from the volume in memory) must agree in PSNR within this; the
# in-core run of uniform batches is no yardstick: in 230 steps the loader
# draws ~100 of the 256 blocks, with replacement
OOC_PSNR_GAP = 2.0
# a batch of the native out-of-core loader against the in-memory volume's
# trilinear sample at its coords (float32 rounding of the coords moves a
# sample by ~3e-5 voxel; a wrong value or coordinate moves it by ~1e-2)
OOC_BATCH_ATOL = 1e-4
# the isovalue of the trained model's extraction (the tubes' surface)
TRAINED_ISO = 0.25
# the fused-MLP kernel functions that must hold tensor-core MMAs (SASS)
MMA_KERNELS = {"fused_mlp_forward": ("fused_mlp_forward_kernel", "Lb0E"),
               "fused_mlp_train_forward": ("fused_mlp_forward_kernel",
                                           "Lb1E"),
               "fused_mlp_backward": ("fused_mlp_backward_kernel", "")}


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


def device_ms(torch, fn, pattern, iters=20, per_call=None):
    """Mean device time per call of the kernels whose names contain
    `pattern`, from torch.profiler: the kernel alone, without the host
    time of its wrapper (which a call of a kernel under 0.2 ms can
    exceed, so CUDA events around the calls would time the host). With
    `per_call`, the kernels a call launches: a reading that lost events
    (torch.profiler drops some now and then) is taken again, up to 5
    times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(p in e.name for p in pattern)]
        if per_call is None or len(events) == per_call * iters:
            return sum(kernel_us(e) for e in events) / iters / 1e3
    raise AssertionError(f"torch.profiler saw {len(events)} launches of "
                         f"{pattern}, not {per_call * iters}")


def kernel_us(event):
    return getattr(event, "device_time", None) or event.cuda_time


def library_times(torch, fn):
    """A library call timed as the port's kernels are, by the device time
    of every kernel it launches (torch.profiler), and by CUDA events around
    the calls (host dispatch included) → (device ms, call ms)."""
    return device_ms(torch, fn, ("",)), cuda_ms(torch, fn)


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors):
    """Bytes of the tensors, of those inside tuples too (the pairs)."""
    return sum(nbytes(*t) if isinstance(t, tuple)
               else t.numel() * t.element_size()
               for t in tensors if t is not None)


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
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.ops import fused_mlp as fm

    field = NeuralField.from_config(ModelConfig())
    cfg = field.cfg.network
    ws, x, _ = mlp_inputs(torch, field, SEED + 1, b=rows)
    got = fm.fused_mlp_apply(ws, x, cfg)
    ref = fm.fused_mlp_reference(ws, x, cfg)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    err = float(diff.max())
    mean_err = float(diff.mean())
    ok = bool((diff <= MLP_ATOL + MLP_RTOL * ref.abs()).all()) and \
        mean_err <= MLP_MEAN_TOL
    call_ms = cuda_ms(torch, lambda: fm.fused_mlp_apply(ws, x, cfg))
    ms = device_ms(torch, lambda: fm.fused_mlp_apply(ws, x, cfg),
                   ("fused_mlp_forward_kernel",))
    plain_ms = cuda_ms(torch, lambda: fm.fused_mlp_reference(ws, x, cfg))
    wb = [w.to(torch.bfloat16) for w in ws]

    def library():  # a bf16 torch.matmul chain: timed only, never used
        h = x
        for w in wb[:-1]:
            h = torch.relu(torch.matmul(h, w))
        return torch.matmul(h, wb[-1])

    library_ms, library_call_ms = library_times(torch, library)
    widths = [w.shape for w in ws]
    flops = 2 * rows * sum(a * b for a, b in widths)
    b_ms, b_by = bound_ms(nbytes(x, got) + sum(2 * a * b for a, b in widths),
                          flops, H100_BF16_FLOPS)
    rec = {"phase": "fused_mlp", "rows": rows, "max_abs_err": err,
           "mean_abs_err": mean_err, "tol": f"atol=rtol={MLP_ATOL}, "
           f"mean<={MLP_MEAN_TOL}", "ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms,
           "library_ms": library_ms, "library_call_ms": library_call_ms,
           "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9}
    log(rec)
    if not ok:
        raise AssertionError(f"fused_mlp kernel disagrees: {rec}")
    return rec


def rel_err(a, r):
    """max |a − r| as a share of r's largest entry (lists: the largest)."""
    if isinstance(a, (list, tuple)):
        return max(rel_err(u, v) for u, v in zip(a, r))
    return float((a.double() - r.double()).abs().max()
                 / r.double().abs().max())


def mlp_inputs(torch, field, seed, b=TRAIN_BATCH):
    """The fused MLP's inputs at the field's widths: its seeded weights,
    bf16 features [b, n_in] and an L1 loss's cotangent ±1/b."""
    from instantvnr_torch.models.network import params_from_numpy

    ws = params_from_numpy(seeded_params(field, seed), "cuda")["mlp"]
    rng = np.random.default_rng(seed + 1)
    x = torch.tensor(rng.standard_normal((b, field.spec.n_output_dims)
                                         ).astype(np.float32),
                     device="cuda").to(torch.bfloat16)
    g = torch.tensor(np.sign(rng.standard_normal((b, 1))).astype(np.float32)
                     / b, device="cuda")
    return ws, x, g


def parted_rows(torch, cfg, fwd_a, fwd_b):
    """Rows to which two training forwards, each (z_out, zs), hand the
    backward other inputs: a hidden activation rounded to another bf16
    value, or another act'(z) (the two sides of a ReLU kink) → (bool [B],
    the counts of rows and elements that part)."""
    from instantvnr_torch.ops.fused_mlp import act_grad
    from instantvnr_torch.ops.mlp import apply_activation

    (za, zsa), (zb, zsb) = fwd_a, fwd_b
    act, out_act = cfg.activation, cfg.output_activation
    h_flips = (apply_activation(zsa, act).to(torch.bfloat16)
               != apply_activation(zsb, act).to(torch.bfloat16))
    d_flips = act_grad(zsa, act) != act_grad(zsb, act)
    out_flips = act_grad(za, out_act) != act_grad(zb, out_act)
    rows = (h_flips | d_flips).any(-1).any(0) | out_flips.any(-1)
    return rows, {"rows_parted": int(rows.sum()),
                  "bf16_activation_flips": int(h_flips.sum()),
                  "act_grad_flips": int(d_flips.sum() + out_flips.sum())}


def chain_end_to_end(torch, ws, x, g, cfg):
    """The training chain end to end: the backward kernel on the forward
    kernel's residuals against the plain backward on the same residuals
    (every row), and against the plain forward and backward. Where the two
    forwards round an activation to neighbouring bf16 values, or fall on
    two sides of a ReLU kink, a row's backward takes other inputs and its
    dx moves by a whole unit's share: those rows are counted, and the two
    chains are compared on the others (the cotangent of a parted row set
    to 0 in both) and on all rows (reported) → {max rel errors, counts}."""
    from instantvnr_torch.ops import fused_mlp as fm

    kf = fm._kernel_train_forward(ws, x, cfg)
    pf = fm._plain_train_forward(ws, x, cfg)
    parted, counts = parted_rows(torch, cfg, kf, pf)
    kept = g * (~parted).to(g.dtype)[:, None]
    kernel = fm._kernel_backward(ws, x, kf[1], kf[0], g, cfg)
    runs = {"kernel_chain": (kernel, fm._plain_backward(ws, x, kf[1], kf[0],
                                                        g, cfg)),
            "vs_plain_chain_agreeing_rows": (
                fm._kernel_backward(ws, x, kf[1], kf[0], kept, cfg),
                fm._plain_backward(ws, x, pf[1], pf[0], kept, cfg)),
            "vs_plain_chain_all_rows": (
                kernel, fm._plain_backward(ws, x, pf[1], pf[0], g, cfg))}
    torch.cuda.synchronize()
    out = {"rows": x.shape[0], **counts}
    for name, ((dx_a, dw_a), (dx_b, dw_b)) in runs.items():
        out[name] = {"dw_max_rel_err": rel_err(dw_a, dw_b),
                     "dx_max_rel_err": rel_err(dx_a, dx_b)}
    return out


def phase_fused_mlp_train(torch):
    """The training form at the reference widths and B = 2^16: the forward
    kernel (y, zs) and the backward kernel (every dW, dx) against the plain
    training form on the same inputs, every dW also against a float64
    oracle, two runs of the backward bit for bit, and the chain end to end
    (chain_end_to_end)."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.ops import fused_mlp as fm

    field = NeuralField.from_config(ModelConfig())
    cfg = field.cfg.network
    ws, x, g = mlp_inputs(torch, field, SEED + 5)
    b = x.shape[0]
    z1, zs1 = fm._kernel_train_forward(ws, x, cfg)
    z2, zs2 = fm._plain_train_forward(ws, x, cfg)
    # the backward kernel and its plain version on the same inputs (the
    # plain forward's residuals), twice, and the float64 oracle on them:
    # the plain chain in float64 (every h_kᵀ g_z of the bf16 layer inputs)
    dx1, dw1 = fm._kernel_backward(ws, x, zs2, z2, g, cfg)
    dx2, dw2 = fm._plain_backward(ws, x, zs2, z2, g, cfg)
    _, dw_f64 = fm._plain_backward([w.double() for w in ws], x.double(), zs2,
                                   z2, g.double(), cfg)
    dx3, dw3 = fm._kernel_backward(ws, x, zs2, z2, g, cfg)
    torch.cuda.synchronize()
    same_bits = torch.equal(dx1, dx3) and all(
        torch.equal(a, r) for a, r in zip(dw1, dw3))
    oracle_err = rel_err(dw1, dw_f64)
    e2e = chain_end_to_end(torch, ws, x, g, cfg)
    e2e_ok = all(e2e[k]["dw_max_rel_err"] <= MLP_DW_RTOL
                 and e2e[k]["dx_max_rel_err"] <= MLP_DX_RTOL
                 for k in ("kernel_chain", "vs_plain_chain_agreeing_rows")
                 ) and e2e["rows_parted"] <= PARTED_ROWS_MAX * b

    fwd_err = max(float((z1 - z2).abs().max()), float((zs1 - zs2).abs().max()))
    fwd_ok = all(bool((a - r).abs().le(MLP_ATOL + MLP_RTOL * r.abs()).all())
                 for a, r in ((z1, z2), (zs1, zs2)))
    dw_err = rel_err(dw1, dw2)
    dx_err = rel_err(dx1, dx2)
    bwd_abs = max([float((a - r).abs().max()) for a, r in zip(dw1, dw2)]
                  + [float((dx1.float() - dx2.float()).abs().max())])
    fwd_call = cuda_ms(torch, lambda: fm._kernel_train_forward(ws, x, cfg))
    fwd_ms = device_ms(torch, lambda: fm._kernel_train_forward(ws, x, cfg),
                       ("fused_mlp_forward_kernel",))
    fwd_plain = cuda_ms(torch, lambda: fm._plain_train_forward(ws, x, cfg))
    bwd_call = cuda_ms(torch, lambda: fm._kernel_backward(ws, x, zs1, z1, g,
                                                          cfg))
    bwd_ms = device_ms(torch, lambda: fm._kernel_backward(ws, x, zs1, z1, g,
                                                          cfg),
                       ("fused_mlp_backward_kernel", "sum_partials_kernel"))
    bwd_plain = cuda_ms(torch, lambda: fm._plain_backward(ws, x, zs2, z2, g,
                                                          cfg))
    # library: a bf16 torch.matmul chain, forward, and its autograd backward
    wb = [w.to(torch.bfloat16).requires_grad_() for w in ws]
    xl = x.clone().requires_grad_()

    def chain():
        h = xl
        for w in wb[:-1]:
            h = torch.relu(torch.matmul(h, w))
        return torch.matmul(h, wb[-1])

    lib_fwd, lib_fwd_call = library_times(torch, chain)
    y_lib = chain()
    g16 = g.to(torch.bfloat16)
    lib_bwd, lib_bwd_call = library_times(torch, lambda: torch.autograd.grad(
        y_lib, [xl] + wb, g16, retain_graph=True))
    widths = [tuple(w.shape) for w in ws]
    macs = b * sum(a * c for a, c in widths)
    w_bytes = sum(2 * a * c for a, c in widths)
    fb_ms, fb_by = bound_ms(nbytes(x, z1, zs1) + w_bytes, 2 * macs,
                            H100_BF16_FLOPS)
    # the backward's products (g_h = g_z·W_kᵀ and dW_k = h_kᵀ g_z, 4 × macs
    # operations) take float32 cotangents. On the float32 pipes they are
    # operations-bound; split into three bf16 terms each (3 × 4 × macs bf16
    # tensor-core operations) the same bytes bound them
    bwd_bytes = nbytes(x, zs1, z1, g, dx1, *dw1) + w_bytes
    bf_ms, bf_by = bound_ms(bwd_bytes, 4 * macs, H100_FP32_FLOPS)
    bb_ms, bb_by = bound_ms(bwd_bytes, 3 * 4 * macs, H100_BF16_FLOPS)
    fwd = {"phase": "fused_mlp_train_forward", "rows": b,
           "max_abs_err": fwd_err, "tol": f"atol=rtol={MLP_ATOL}",
           "ms": fwd_ms, "call_ms": fwd_call, "plain_ms": fwd_plain,
           "library_ms": lib_fwd, "library_call_ms": lib_fwd_call,
           "bound_ms": fb_ms, "bound_by": fb_by,
           "mbytes": (nbytes(x, z1, zs1) + w_bytes) / 1e6}
    bwd = {"phase": "fused_mlp_backward", "rows": b, "max_abs_err": bwd_abs,
           "dw_max_rel_err": dw_err, "dx_max_rel_err": dx_err,
           "dw_f64_oracle_max_rel_err": oracle_err,
           "two_runs_same_bits": same_bits,
           "end_to_end": e2e,
           "tol": f"dW {MLP_DW_RTOL} (also vs the float64 oracle), dx "
                  f"{MLP_DX_RTOL} of the largest entry, on the same inputs "
                  f"and end to end (the kernel chain; the plain chain's "
                  f"agreeing rows); parted rows <= {PARTED_ROWS_MAX} of B",
           "ms": bwd_ms, "call_ms": bwd_call, "plain_ms": bwd_plain,
           "library_ms": lib_bwd, "library_call_ms": lib_bwd_call,
           "bound_ms": bb_ms, "bound_by": bb_by,
           "bound_derivation": "bytes x, zs, z_out, g, dx, dW, W at 3.35 "
           "TB/s vs 3 x 4 x MACs bf16 at 989 TFLOP/s (split-bf16 tensor "
           "cores)",
           "bound_f32_pipes_ms": bf_ms, "bound_f32_pipes_by": bf_by,
           "mbytes": bwd_bytes / 1e6, "gflop": 4 * macs / 1e9}
    log(fwd)
    log(bwd)
    if (not fwd_ok or dw_err > MLP_DW_RTOL or dx_err > MLP_DX_RTOL
            or oracle_err > MLP_DW_RTOL or not same_bits or not e2e_ok):
        raise AssertionError(f"fused MLP training kernels disagree: {fwd} "
                             f"{bwd}")
    return fwd, bwd


def _dense_oracle(torch, spec, coords, g, levels):
    """float64 np.add.at of each corner's bf16-rounded product of weight
    and cotangent row, over the given levels → {level: [size, F]}."""
    from instantvnr_torch.ops import hash_encoding as he

    b, nl, nf = coords.shape[0], spec.n_levels, spec.n_features
    idx, w = he.corner_indices_and_weights(spec, coords)
    idx = idx.reshape(b, nl, 8)
    contrib = (g.to(torch.bfloat16).reshape(b, nl, 1, nf)
               * w.to(torch.bfloat16).reshape(b, nl, 8, 1))
    out = {}
    for lvl in levels:
        off, size = spec.level_offsets[lvl], spec.level_sizes[lvl]
        ref = np.zeros((size, nf))
        np.add.at(ref, (idx[:, lvl] - off).reshape(-1).cpu().numpy(),
                  contrib[:, lvl].double().reshape(-1, nf).cpu().numpy())
        out[lvl] = ref
    return out


def hash_inputs(torch, log2):
    """The hash-grid kernels' inputs on a layout of the reference schema:
    (spec, f32 table ±1, B = 2^16 coords, a bf16 cotangent [B, L·F]),
    drawn from a seed."""
    from instantvnr_torch.config import EncodingConfig
    from instantvnr_torch.ops import hash_encoding as he

    spec = he.HashGridSpec.from_config(EncodingConfig(log2_hashmap_size=log2))
    gen = torch.Generator(device="cuda").manual_seed(SEED + log2)
    table = torch.rand((spec.n_entries, spec.n_features), generator=gen,
                       device="cuda") * 2.0 - 1.0
    coords = torch.rand((TRAIN_BATCH, 3), generator=gen, device="cuda")
    g = torch.randn((TRAIN_BATCH, spec.n_output_dims), generator=gen,
                    device="cuda").to(torch.bfloat16)
    return spec, table, coords, g


def phase_hash_encode(torch, name, log2):
    """The hash-grid kernels on a layout of the reference schema at
    B = 2^16 in bf16 compute from the f32 master table, as a training step
    runs them: forward against the plain gather, backward against the plain
    index_add_ and, on the 2^19 layout's dense levels, a float64 oracle."""
    from instantvnr_torch.ops import hash_encoding as he

    spec, table, coords, g = hash_inputs(torch, log2)
    b = TRAIN_BATCH
    bf16 = torch.bfloat16
    n = spec.n_entries
    out = he.hash_encode(table, coords, spec, bf16)
    ref = he.hash_encode_reference(table, coords, spec, bf16)
    grad = he._kernel_backward(n, coords, spec, g, bf16)
    grad_ref = he._plain_backward(n, coords, spec, g, bf16)
    torch.cuda.synchronize()
    fwd_err = float((out.float() - ref.float()).abs().max())
    bwd_err = float((grad - grad_ref).abs().max())
    bwd_ok = bool((grad - grad_ref).abs().le(
        HASH_BWD_ATOL + HASH_BWD_RTOL * grad_ref.abs()).all())
    oracle_err = None
    dense = [lvl for lvl in range(spec.n_levels) if spec.level_is_dense[lvl]]
    if log2 == 19:
        for lvl, ref_l in _dense_oracle(torch, spec, coords, g, dense).items():
            off, size = spec.level_offsets[lvl], spec.level_sizes[lvl]
            got = grad[off:off + size].double().cpu().numpy()
            err = np.abs(got - ref_l)
            oracle_err = max(oracle_err or 0.0, float(err.max()))
            bwd_ok &= bool((err <= HASH_BWD_ATOL
                            + HASH_BWD_RTOL * np.abs(ref_l)).all())
    idx, w = he.corner_indices_and_weights(spec, coords)
    rows = int(torch.unique(idx).numel())
    row_bytes = spec.n_features * 4
    fwd_call = cuda_ms(torch, lambda: he._kernel_forward(table, coords,
                                                         spec, bf16))
    fwd_ms = device_ms(torch, lambda: he._kernel_forward(table, coords, spec,
                                                         bf16),
                       ("hash_encode_forward_kernel",))
    fwd_plain = cuda_ms(torch, lambda: he._gather_encode(table, coords, spec,
                                                         bf16))
    bwd_call = cuda_ms(torch, lambda: he._kernel_backward(n, coords, spec,
                                                          g, bf16))
    # the wrapper's zeroing of the gradient table is the function's too
    bwd_ms = device_ms(torch, lambda: he._kernel_backward(n, coords, spec, g,
                                                          bf16),
                       K4_KERNELS)
    bwd_plain = cuda_ms(torch, lambda: he._plain_backward(n, coords, spec, g,
                                                          bf16))
    # library yardsticks on precomputed corners (timed only): a weighted
    # embedding_bag sum, and index_add_ of the weighted cotangents
    bags = idx.reshape(-1, 8)
    bag_w = w.reshape(-1, 8)
    lib_fwd, lib_fwd_call = library_times(
        torch, lambda: torch.nn.functional.embedding_bag(
            bags, table, per_sample_weights=bag_w, mode="sum"))
    contrib = (g.float().reshape(b, spec.n_levels, 1, spec.n_features)
               * w.reshape(b, spec.n_levels, 8, 1)).reshape(-1,
                                                            spec.n_features)
    flat = idx.reshape(-1)
    lib_bwd, lib_bwd_call = library_times(
        torch, lambda: torch.zeros_like(table).index_add_(0, flat, contrib))
    # bytes: each distinct row once, coords, the features (forward); coords,
    # the cotangent and the whole f32 gradient table written (backward)
    fwd_bytes = rows * row_bytes + nbytes(coords, out)
    bwd_bytes = nbytes(coords, g, grad) + rows * row_bytes
    lanes = b * spec.n_levels
    fwd_ops = lanes * (12 + 8 * (5 + 3 * spec.n_features))
    bwd_ops = lanes * 8 * (5 + 2 * spec.n_features)
    fb_ms, fb_by = bound_ms(fwd_bytes, fwd_ops, H100_FP32_FLOPS)
    bb_ms, bb_by = bound_ms(bwd_bytes, bwd_ops, H100_FP32_FLOPS)
    common = {"layout": f"2^{log2}", "batch": b, "levels": spec.n_levels,
              "features": spec.n_features, "table_mb": nbytes(table) / 1e6,
              "gathered_mb": lanes * 8 * row_bytes / 1e6,
              "distinct_rows": rows}
    fwd = {"phase": f"hash_encode_forward[{name}]", **common,
           "max_abs_err": fwd_err, "tol": HASH_FWD_ATOL, "ms": fwd_ms,
           "call_ms": fwd_call, "plain_ms": fwd_plain, "library_ms": lib_fwd,
           "library_call_ms": lib_fwd_call, "bound_ms": fb_ms,
           "bound_by": fb_by, "mbytes": fwd_bytes / 1e6}
    bwd = {"phase": f"hash_encode_backward[{name}]", **common,
           "max_abs_err": bwd_err, "oracle_max_abs_err": oracle_err,
           "tol": f"atol={HASH_BWD_ATOL}, rtol={HASH_BWD_RTOL}",
           "ms": bwd_ms, "call_ms": bwd_call, "plain_ms": bwd_plain,
           "library_ms": lib_bwd, "library_call_ms": lib_bwd_call,
           "bound_ms": bb_ms, "bound_by": bb_by, "mbytes": bwd_bytes / 1e6}
    log(fwd)
    log(bwd)
    if not fwd_err <= HASH_FWD_ATOL or not bwd_ok:
        raise AssertionError(f"hash-grid kernels disagree: {fwd} {bwd}")
    return fwd, bwd


def mma_counts(lib_path):
    """Tensor-core MMA instructions (HMMA, HGMMA) in the SASS of each
    instantiation of the fused-MLP kernels, from `cuobjdump -sass` of the
    built library → {kernel: {"W=<width>": count}}."""
    import re

    from instantvnr_torch.ops.cuda_lib import _nvcc

    sass = subprocess.run(
        [os.path.join(os.path.dirname(_nvcc()), "cuobjdump"), "-sass",
         lib_path], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = None
            for name, (pattern, flag) in MMA_KERNELS.items():
                width = re.search(r"ILi(\d+)E", m.group(1))
                if pattern in m.group(1) and flag in m.group(1) and width:
                    fn = counts.setdefault(name, {})
                    key = f"W={width.group(1)}"
                    fn[key] = 0
        elif fn is not None and re.search(r"\bH(G)?MMA\b", line):
            fn[key] += 1
    return counts


def launches_during(fn):
    """(fn(), the launches of every kernel counter made while fn ran)."""
    before = {n: c.launches for n, c in counters().items()}
    out = fn()
    return out, {n: c.launches - before[n] for n, c in counters().items()}


def add_launches(total, delta):
    for n, v in delta.items():
        total[n] = total.get(n, 0) + v


def run_training(torch, sv, cfg, seed, name):
    """TRAIN_STEPS steps through the facade, chunks of 10 at B = 2^16: a
    warm-up (the online macrocell update at its end), 100 steps timed with
    CUDA events, then the last TAIL_CHUNKS chunks of 10 with the PSNR
    after each (the tail). Launches are counted over the
    train() calls alone, not over the PSNR decodes between them."""
    from instantvnr_torch import api

    nv = api.NeuralVolume(cfg, sv, seed=seed, device="cuda",
                          train_batch=TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    t0 = time.perf_counter()
    warmup = TRAIN_STEPS - 100 - 10 * TAIL_CHUNKS
    _, d = launches_during(lambda: nv.train(warmup, chunk=10))
    add_launches(launches, d)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, d = launches_during(lambda: nv.train(100, fast_mode=True, chunk=10))
    end.record()
    torch.cuda.synchronize()
    add_launches(launches, d)
    ms = start.elapsed_time(end) / 100
    tail = []
    for _ in range(TAIL_CHUNKS):
        _, d = launches_during(lambda: nv.train(10, fast_mode=True))
        add_launches(launches, d)
        tail.append(nv.get_psnr())
    wall_s = time.perf_counter() - t0
    rec = {"phase": name, "seed": seed, "steps": nv.get_training_step(),
           "batch": TRAIN_BATCH, "ms_per_step": ms,
           "msamples_per_s": TRAIN_BATCH / ms / 1e3, "wall_s": wall_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "psnr_tail": tail,
           "psnr_tail_median": float(np.median(tail)),
           "loss": nv.get_training_loss(),
           "test_loss": nv.get_testing_loss(), "psnr": tail[-1],
           "ssim": nv.get_mssim()}
    expect = {n: (TRAIN_STEPS if n in TRAIN_KERNELS else 0)
              for n in counters()}
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches} != {expect}")
    return nv, rec


def run_plain_control(torch, sv, cfg, seed, name, mlp_fn):
    """The same seed, batch, steps and PSNR tail as run_training, in a loop
    built here from the plain functions (plain hash encode, `mlp_fn`,
    adam_update_plain) on CUDA tensors: no kernel may launch in its
    steps."""
    from instantvnr_torch import api
    from instantvnr_torch.data.sampler import sample_static
    from instantvnr_torch.models.metrics import psnr_vs
    from instantvnr_torch.models.optimizer import (adam_update_plain,
                                                   mlp_l2_mask)
    from instantvnr_torch.ops.hash_encoding import hash_encode_reference

    nv = api.NeuralVolume(cfg, sv, seed=seed, device="cuda",
                          train_batch=TRAIN_BATCH)
    field, vol = nv.field, sv.volume.data
    state = nv.state
    params, opt = state.params, state.opt

    def step(params, opt):
        coords, targets = sample_static(vol, state.generator, TRAIN_BATCH)
        live = [p.detach().requires_grad_() for p in
                [params["table"], *params["mlp"]]]
        feats = hash_encode_reference(live[0], coords, field.spec,
                                      torch.bfloat16)
        pred = mlp_fn(live[1:], feats, field.cfg.network)
        loss = torch.mean(torch.abs(pred - targets))
        grads = torch.autograd.grad(loss, live)
        return adam_update_plain(field.cfg.optimizer, params,
                                 {"table": grads[0], "mlp": list(grads[1:])},
                                 opt, l2_mask=mlp_l2_mask(params)), loss

    launches, tail = {}, []
    t0 = time.perf_counter()
    for i in range(1, TRAIN_STEPS + 1):
        ((params, opt), loss), d = launches_during(lambda: step(params, opt))
        add_launches(launches, d)
        if i > TRAIN_STEPS - 10 * TAIL_CHUNKS and i % 10 == 0:
            tail.append(float(psnr_vs(field, params, vol)))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if any(launches.values()):
        raise AssertionError(f"{name}: the plain loop launched {launches}")
    nv.state = state._replace(params=params, opt=opt, loss=loss.detach())
    return {"phase": name, "seed": seed, "steps": TRAIN_STEPS,
            "wall_s": wall_s, "launches_in_steps": launches,
            "psnr_tail": tail, "psnr_tail_median": float(np.median(tail)),
            "loss": nv.get_training_loss(),
            "test_loss": nv.get_testing_loss(), "psnr": tail[-1],
            "ssim": nv.get_mssim()}


def phase_training(torch, sv):
    """train_2e14 through the kernels against its plain control and the
    bf16-cotangent autograd of mlp_apply, over SEEDS_2E14; then train_2e19
    over SEEDS_2E19. The 1000-step PSNR swings by several dB from one
    10-step chunk to the next, so each run records the PSNR after each of
    its last 10 chunks, and the variants compare the mean over seeds of
    each run's tail median."""
    from instantvnr_torch.config import EncodingConfig, ModelConfig
    from instantvnr_torch.ops import fused_mlp as fm
    from instantvnr_torch.ops.mlp import mlp_apply

    cfg14 = ModelConfig(encoding=EncodingConfig(log2_hashmap_size=14))
    mlps = {"plain": fm.fused_mlp_train_reference,
            "autodiff": lambda w, x, c: mlp_apply(
                w, x, c, compute_dtype=torch.bfloat16)}
    runs = {"kernel": [], "plain": [], "autodiff": []}
    for seed in SEEDS_2E14:
        _, rec = run_training(torch, sv, cfg14, seed,
                              f"train_2e14[seed {seed}]")
        log(rec)
        runs["kernel"].append(rec)
        for kind, fn in mlps.items():
            rec = run_plain_control(torch, sv, cfg14, seed,
                                    f"train_2e14_{kind}_control[seed {seed}]",
                                    fn)
            log(rec)
            runs[kind].append(rec)
    k14 = runs["kernel"][0]
    pooled = {kind: float(np.median([v for r in rs for v in r["psnr_tail"]]))
              for kind, rs in runs.items()}
    mean_tail = {kind: float(np.mean([r["psnr_tail_median"] for r in rs]))
                 for kind, rs in runs.items()}
    at_1000 = {kind: [r["psnr"] for r in rs] for kind, rs in runs.items()}
    ssim_med = float(np.median([r["ssim"] for r in runs["kernel"]]))
    summary = {
        "phase": "train_2e14", "seeds": list(SEEDS_2E14),
        "psnr_seed0_step1000": k14["psnr"], "ssim_seed0": k14["ssim"],
        "ms_per_step_seed0": k14["ms_per_step"],
        "psnr_pooled_tail_median": pooled,
        "psnr_mean_of_tail_medians": mean_tail, "psnr_step1000": at_1000,
        "ssim_median_kernel": ssim_med,
        "kernel_minus_plain_db": mean_tail["kernel"] - mean_tail["plain"],
        "bar_55db_seed0_met": k14["psnr"] >= PSNR_BAR_2E14,
        "bar_55db_pooled_met": pooled["kernel"] >= PSNR_BAR_2E14,
        "bar_within_1db_of_control_met":
            abs(mean_tail["kernel"] - mean_tail["plain"]) <= 1.0,
        "reference": "56.621 dB, SSIM 0.9997 (BENCH_r05, one TPU run)"}
    log(summary)
    if (ssim_med < SSIM_MIN
            or summary["kernel_minus_plain_db"] < -KERNEL_LOSS_MAX_DB):
        raise AssertionError(f"train_2e14 fails its checks: {summary}")
    runs19 = []
    nv19 = None
    for seed in SEEDS_2E19:
        nv, rec = run_training(torch, sv, ModelConfig(), seed,
                               f"train_2e19[seed {seed}]")
        log(rec)
        runs19.append(rec)
        if nv19 is None:
            nv19 = nv
    psnrs = [r["psnr"] for r in runs19]
    summary19 = {
        "phase": "train_2e19", "seeds": list(SEEDS_2E19),
        "psnr_median": float(np.median(psnrs)),
        "psnr_spread": max(psnrs) - min(psnrs),
        "psnr_pooled_tail_median": float(np.median(
            [v for r in runs19 for v in r["psnr_tail"]])),
        "ssim_median": float(np.median([r["ssim"] for r in runs19])),
        "ms_per_step_median": float(np.median(
            [r["ms_per_step"] for r in runs19])),
        "max_memory_allocated": max(r["max_memory_allocated"]
                                    for r in runs19),
        "reference": "median 52.845 dB, spread 3.754 dB, SSIM 0.9996 "
                     "(BENCH_r05)"}
    log(summary19)
    if summary19["psnr_median"] < PSNR_MIN_2E19:
        raise AssertionError(f"train_2e19 misses its bar: {summary19}")
    return k14, nv19


def adam_record(torch, cfg, params, grads, state):
    """The adam_step kernel on a tree against the plain form: p', m' and v'
    bit for bit; the kernel's time by CUDA events over launches of its C
    entry back to back on outputs made once (the card's time sets it: a
    launch's host work is a ctypes call; profiled readings of this kernel
    lost up to 16 of 20 events), the wrapper's call, the plain form's
    device time and that of one PyTorch call as the yardstick,
    torch._fused_adam_ in place on copies, by CUDA events over calls back
    to back (its ε and decay are its own; the port never calls it)."""
    from instantvnr_torch.models import optimizer as opt
    from instantvnr_torch.ops import adam as kadam
    from instantvnr_torch.ops.cuda_lib import load_library

    mask = opt.mlp_l2_mask(params)

    def kernel():
        return opt.adam_update(cfg, params, grads, state, l2_mask=mask)

    def plain():
        return opt.adam_update_plain(cfg, params, grads, state, l2_mask=mask)

    (new, st), (ref, rst) = kernel(), plain()
    pairs = list(zip(
        [*opt._leaves(new), *opt._leaves(st.mu), *opt._leaves(st.nu)],
        [*opt._leaves(ref), *opt._leaves(rst.mu), *opt._leaves(rst.nu)]))
    leaves, gs, mu, nu = (opt._leaves(t)
                          for t in (params, grads, state.mu, state.nu))
    n = sum(p.numel() for p in leaves)
    s = opt.adam_scalars(cfg, state.step + 1)
    tables = kadam.pack_groups(list(zip(leaves, gs, mu, nu)),
                               list(zip(*map(opt._leaves, (new, st.mu,
                                                          st.nu)))),
                               opt._l2_flags(cfg, params, mask))
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def launches():
        for table in tables:
            lib.call("adam_step", table.ctypes.data, len(table), *s, stream)

    copies = [[t.clone() for t in tree] for tree in (leaves, mu, nu)]
    steps = [torch.tensor(float(state.step), device=leaves[0].device)
             for _ in leaves]
    plain_ms, plain_call_ms = library_times(torch, plain)
    library_ms = cuda_ms(torch, lambda: torch._fused_adam_(
        copies[0], gs, copies[1], copies[2], [], steps, lr=s.lr,
        beta1=s.beta1, beta2=s.beta2, weight_decay=0.0, eps=s.epsilon,
        amsgrad=False, maximize=False))
    ms, by = bound_ms(28 * n, 0, 1.0)
    return {"phase": "adam_step", "leaves": len(leaves), "params": n,
            "step": state.step + 1, "launches_a_call": len(tables),
            "differing": sum(int((a != b).sum()) for a, b in pairs),
            "max_abs_err": max(float((a - b).abs().max()) for a, b in pairs),
            "ms": cuda_ms(torch, launches), "call_ms": cuda_ms(torch, kernel),
            "plain_ms": plain_ms, "plain_call_ms": plain_call_ms,
            "library_ms": library_ms, "bound_ms": ms, "bound_by": by}


def phase_train_breakdown(torch, nv):
    """Where a training step's time goes at 2^19: each stage of one step
    alone (CUDA events, on the trained params and a fresh batch), Adam's
    kernel against its plain form (adam_record), then the device time of 20
    steps by kernel from torch.profiler, and the device's busy share of
    their wall time."""
    from torch.profiler import ProfilerActivity, profile

    from instantvnr_torch.data.sampler import sample_static
    from instantvnr_torch.models import trainer
    from instantvnr_torch.ops import fused_mlp as fm
    from instantvnr_torch.ops import hash_encoding as he

    field, vol = nv.field, nv.simple.volume.data
    spec, net, bf16 = field.spec, field.cfg.network, torch.bfloat16
    state = nv.state
    params = state.params
    coords, targets = sample_static(vol, state.generator, TRAIN_BATCH)
    feats = he._kernel_forward(params["table"], coords, spec, bf16)
    z_out, zs = fm._kernel_train_forward(params["mlp"], feats, net)
    g = torch.sign(z_out - targets) / TRAIN_BATCH
    _, grads = trainer.value_and_grad(field, params, coords, targets)

    def step():
        return trainer.train_step(field, vol, state, TRAIN_BATCH)

    rec = {"phase": "train_breakdown", "layout": "2^19",
           "sample_ms": cuda_ms(torch, lambda: sample_static(
               vol, state.generator, TRAIN_BATCH)),
           "hash_forward_ms": cuda_ms(torch, lambda: he._kernel_forward(
               params["table"], coords, spec, bf16)),
           "mlp_forward_ms": cuda_ms(torch, lambda: fm._kernel_train_forward(
               params["mlp"], feats, net)),
           "mlp_backward_ms": cuda_ms(torch, lambda: fm._kernel_backward(
               params["mlp"], feats, zs, z_out, g, net)),
           # the features stand in for the cotangent: same shape and type
           "hash_backward_ms": cuda_ms(torch, lambda: he._kernel_backward(
               spec.n_entries, coords, spec, feats, bf16)),
           "zero_grad_table_ms": cuda_ms(torch, lambda: torch.zeros_like(
               params["table"])),
           "adam": adam_record(torch, field.cfg.optimizer, params, grads,
                               state.opt),
           "value_and_grad_ms": cuda_ms(torch, lambda: trainer.value_and_grad(
               field, params, coords, targets)),
           "step_ms": cuda_ms(torch, step)}
    n = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    nv.train(n, fast_mode=True)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        nv.train(n, fast_mode=True)
        torch.cuda.synchronize()
    groups = {"fused_mlp_backward": ("fused_mlp_backward_kernel",
                                     "sum_partials_kernel"),
              "fused_mlp_train_forward": ("fused_mlp_forward_kernel",),
              "hash_encode_backward": ("hash_encode_backward_kernel",),
              "hash_encode_forward": ("hash_encode_forward_kernel",),
              "adam_step": ("adam_step_kernel",),
              "zero fill": ("FillFunctor",)}
    device = {name: 0.0 for name in list(groups) + ["other"]}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        us = kernel_us(ev)
        name = next((k for k, pats in groups.items()
                     if any(p in ev.name for p in pats)), "other")
        device[name] += us / 1e3 / n
    busy = sum(device.values())
    rec.update({"profiled_steps": n, "device_ms_per_step": device,
                "device_busy_ms_per_step": busy,
                "ms_per_step_unprofiled": step_ms,
                "device_idle_share": max(0.0, 1.0 - busy / step_ms),
                "device_ops_per_step": n_kernels / n})
    log(rec)
    if rec["adam"]["differing"]:
        raise AssertionError(f"adam_step differs from its plain form: "
                             f"{rec['adam']}")
    return rec


def phase_online_loop(torch, nv):
    """The paper's in-loop mode at 2^19: rounds of train(10), a full
    re-decode and one 512² DECODED_SLAB frame; every round re-decodes and
    its frame differs from the last."""
    from instantvnr_torch import api

    r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode.DECODED_SLAB)
    r.set_camera(orbit(1, N_FRAMES, max(DIMS)))
    r.render()
    prev = r.mapframe()
    rounds = []
    for i in range(ONLINE_ROUNDS):
        for c in counters().values():
            c.reset()
        t0 = time.perf_counter()
        nv.train(10)
        nv.ensure_decoded(SIZE, SIZE)
        r.render()
        frame = r.mapframe()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {n: c.launches for n, c in counters().items()}
        change = float(np.abs(frame - prev).max())
        rounds.append({"ms": ms, "launches": launches, "frame_change": change,
                       "alpha_max": float(frame[..., 3].max())})
        expect = {n: 0 for n in counters()}
        # 10 steps, then a full decode: 8 blobs through K3 and the MLP
        expect.update({n: 10 for n in TRAIN_KERNELS},
                      fused_mlp=8, composite_slabs=1)
        expect["hash_encode_forward"] += 8
        if launches != expect or not change > 0.0 or \
                not np.isfinite(frame).all():
            raise AssertionError(f"online round {i}: {rounds[-1]}, "
                                 f"expected launches {expect}")
        prev = frame
    rec = {"phase": "online_loop", "layout": "2^19", "rounds": rounds,
           "ms_per_round": float(np.mean([x["ms"] for x in rounds[1:]]))}
    log(rec)
    return rec


def model_json(tmp, log2):
    """A model file of the reference schema with a 2^log2 hash table."""
    path = os.path.join(tmp, f"model{log2}.json")
    with open(path, "w") as f:
        json.dump({"encoding": {"log2_hashmap_size": log2}}, f)
    return path


def phase_online_app(torch, tmp, log2):
    """The port's vnr_int_online at full width, vorts 128³ at 512²:
    ONLINE_FRAMES frames of train(ONLINE_STEPS), ONLINE_BLOBS decode blobs
    and a DECODED_SLAB frame. 2^14 is the app's default (the JAX package's
    cap); 2^19 the reference schema through --model. Each frame's
    launches (read at the end of its render) must be the slice's, every
    frame finite, the last one visible, the steps 10 a frame in the CSV,
    and the final PSNR over DATA_PSNR_MIN."""
    from instantvnr_torch.apps import vnr_int_online
    from instantvnr_torch.render import decoded

    name = f"online_app[2^{log2}]"
    csv_path = os.path.join(tmp, f"online{log2}.csv")
    argv = ["--synthetic", "vorts", "--dims", str(DIMS[0]), "--size",
            str(SIZE), "--frames", str(ONLINE_FRAMES),
            "--train-steps-per-frame", str(ONLINE_STEPS),
            "--infer-blobs-per-frame", str(ONLINE_BLOBS), "--log", csv_path]
    if log2 != 14:
        argv += ["--model", model_json(tmp, log2)]
    render = decoded.DecodedRenderer.render
    frames, per_frame, seen = [], [], {}

    def recording(self):
        out = render(self)
        now = {n: c.launches for n, c in counters().items()}
        per_frame.append({n: now[n] - seen.get(n, 0) for n in now})
        seen.update(now)
        frames.append(out)
        return out

    for c in counters().values():
        c.reset()
    decoded.DecodedRenderer.render = recording
    t0 = time.perf_counter()
    try:
        nv, dec = vnr_int_online.main(argv)
    finally:
        decoded.DecodedRenderer.render = render
    wall_s = time.perf_counter() - t0
    psnr = nv.get_psnr()
    stages = online_stages(torch, nv, dec)
    with open(csv_path) as f:
        rows = [ln.strip().split(",") for ln in f]
    header, rows = rows[0], rows[1:]
    col = {k: [float(r[i]) for r in rows] for i, k in enumerate(header)}
    stack = torch.stack([f.reshape(SIZE, SIZE, 4) for f in frames])
    alpha = stack[..., 3].amax(dim=(1, 2)).cpu().numpy()
    expect = {n: 0 for n in counters()}
    expect.update({n: ONLINE_STEPS for n in TRAIN_KERNELS},
                  fused_mlp=ONLINE_BLOBS, composite_slabs=1)
    expect["hash_encode_forward"] += ONLINE_BLOBS
    launches = {n: sum(f[n] for f in per_frame) for n in counters()}
    rec = {"phase": name, "model": f"ModelConfig() at 2^{log2}",
           "frames": len(rows), "wall_s": wall_s,
           "train_ms_median": float(np.median(col["train_ms"][1:])),
           "render_ms_median": float(np.median(col["render_ms"][1:])),
           "fps_median": float(np.median(col["fps"][1:])),
           "first_frame_ms": col["train_ms"][0] + col["render_ms"][0],
           "steps": [int(v) for v in col["step"]],
           "loss_last": col["loss"][-1],
           "alpha_max_last": float(alpha[-1]),
           "all_finite": bool(torch.isfinite(stack).all()),
           "psnr": psnr, "psnr_min": DATA_PSNR_MIN, "stages": stages,
           "launches_per_frame_expected": expect,
           "frames_with_expected_launches": sum(f == expect
                                                for f in per_frame),
           "launches": launches}
    log({k: v for k, v in rec.items() if k != "steps"})
    if (header != ["frame", "step", "loss", "train_ms", "render_ms", "fps"]
            or len(rows) != ONLINE_FRAMES or len(per_frame) != ONLINE_FRAMES
            or rec["steps"] != [ONLINE_STEPS * (i + 1)
                                for i in range(ONLINE_FRAMES)]
            or rec["frames_with_expected_launches"] != ONLINE_FRAMES
            or not rec["all_finite"] or not rec["alpha_max_last"] > 0.05
            or not rec["psnr"] > DATA_PSNR_MIN):
        bad = [f for f in per_frame if f != expect][:2]
        raise AssertionError(f"{name} fails its checks: {rec}; frames "
                             f"with other launches: {bad}")
    return rec


def online_stages(torch, nv, dec, n=5):
    """Where an online frame's time goes, after the app's run: n more
    frames with each stage ended by a wait for the card (train; the
    progressive decode, which first rebinds the new params, the bf16
    table's repack; the render), the medians in ms; then one frame under
    torch.profiler, its device busy time and idle share."""
    from instantvnr_torch.utils.profiling import sync

    def frame():
        nv.train(ONLINE_STEPS, fast_mode=False)
        nv.decode_progressive(ONLINE_BLOBS)
        dec.set_params(nv.params)
        return dec.render()

    parts = {"train": lambda: nv.train(ONLINE_STEPS, fast_mode=False),
             "decode": lambda: nv.decode_progressive(ONLINE_BLOBS),
             "render": dec.render}
    times = {k: [] for k in parts}
    for _ in range(n):
        for k, fn in parts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sync(fn())
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    out = {f"{k}_ms": float(np.median(v)) for k, v in times.items()}
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(kernel_us(e) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    out.update(profiled_wall_ms=wall, profiled_device_busy_ms=busy,
               profiled_device_idle_share=1.0 - busy / wall)
    return out


def http_get(base, path, data=None, timeout=60.0):
    """GET (POST with data) of the viewer; → the body, or the HTTP status
    of a refusal. Retries while no frame has been served (503)."""
    import urllib.error
    import urllib.request

    deadline = time.perf_counter() + timeout
    while True:
        req = urllib.request.Request(
            base + path, data=data,
            method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            if e.code != 503 or time.perf_counter() > deadline:
                return e.code
        time.sleep(0.05)


def png_rgba(data):
    """The viewer's PNG (8-bit RGBA, filter-0 scanlines) → [H, W, 4]."""
    import struct
    import zlib

    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h = hdr[:2]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 4 * w + 1)
    return raw[:, 1:].reshape(h, w, 4)


def phase_viewer(torch, tmp):
    """The port's viewer in-process on 127.0.0.1, port 0, at full width
    (the reference schema, vorts 128³, 512²) with training on, driven over
    HTTP as the browser drives it: the page, a frame, a camera drag, a TF
    edit, shading on, NEURAL_WAVEFRONT, PATHTRACE_NEURAL and back to
    DECODED_SLAB. After each edit a frame rendered after it must differ
    from the one before, the step must advance and no error may have been
    caught; then the served frames a second over VIEWER_WINDOW_S, split
    into the loop's training, render and PNG-encode time; /api/quit ends
    the server and the render thread."""
    import threading

    from instantvnr_torch.apps import vnr_int_viewer as viewer

    args = viewer.parse_args([
        "--synthetic", "vorts", "--dims", str(DIMS[0]), "--size", str(SIZE),
        "--model", model_json(tmp, 19), "--port", "0"])
    for c in counters().values():
        c.reset()
    t0 = time.perf_counter()
    app = viewer.build_app(args)
    server, loop = viewer.serve(app, "127.0.0.1", 0)
    http = threading.Thread(target=server.serve_forever, daemon=True)
    http.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    steps, edits = [], []

    def state():
        return json.loads(http_get(base, "/api/state"))

    def frame_after(f0, mode, what):
        """The first PNG of a frame begun after the edit at frame f0."""
        deadline = time.perf_counter() + 120
        while True:
            s = state()
            if s["frame"] >= f0 + 2 and s["mode"] == mode:
                return s, png_rgba(http_get(base, "/frame.png"))
            if s["errors"] or time.perf_counter() > deadline:
                raise AssertionError(f"viewer, {what}: {s}")
            time.sleep(0.02)

    try:
        page = http_get(base, "/")
        img = png_rgba(http_get(base, "/frame.png"))
        first_s = time.perf_counter() - t0
        if (b"instantvnr_torch viewer" not in page
                or img.shape != (SIZE, SIZE, 4) or not img[..., 3].max() > 12):
            raise AssertionError(f"viewer: first frame {img.shape}, alpha "
                                 f"{img[..., 3].max()}")
        prev = img
        for what, path, data, mode in (
                ("camera drag", "/api/camera?yaw=0.6&pitch=0.3", None,
                 "DECODED_SLAB"),
                ("TF edit", "/api/tf", json.dumps(
                    {"colors": [[0.0, 0.9, 0.2, 0.1], [1.0, 0.2, 0.6, 1.0]],
                     "alphas": [[0.0, 0.0], [0.5, 0.3], [1.0, 0.9]]}
                ).encode(), "DECODED_SLAB"),
                ("shading on", "/api/shading?on=1", None, "DECODED_SLAB"),
                ("NEURAL_WAVEFRONT", "/api/mode?name=NEURAL_WAVEFRONT",
                 None, "NEURAL_WAVEFRONT"),
                ("PATHTRACE_NEURAL", "/api/mode?name=PATHTRACE_NEURAL",
                 None, "PATHTRACE_NEURAL"),
                ("DECODED_SLAB", "/api/mode?name=DECODED_SLAB", None,
                 "DECODED_SLAB"),
                ("shading off", "/api/shading?on=0", None, "DECODED_SLAB")):
            f0 = state()["frame"]
            n0 = len(app.timings)
            if http_get(base, path, data) != b"ok":
                raise AssertionError(f"viewer refused {path}")
            s, img = frame_after(f0, mode, what)
            change = int(np.abs(img.astype(np.int16) - prev).max())
            steps.append(s["step"])
            edits.append({"edit": what, "mode": s["mode"], "step": s["step"],
                          "errors": s["errors"], "frame_change_u8": change,
                          "alpha_max_u8": int(img[..., 3].max()),
                          "loop_ms_median": float(np.median(
                              [sum(t) for t in list(app.timings)[n0:]]
                              or [0.0]))})
            if (s["errors"] or change == 0 or len(steps) > 1
                    and steps[-1] <= steps[-2]):
                raise AssertionError(f"viewer after {what}: {edits[-1]}, "
                                     f"{s['last_error']}")
            prev = img
        # served frames a second in DECODED_SLAB with training
        f0, n0, w0 = state()["frame"], len(app.timings), time.perf_counter()
        time.sleep(VIEWER_WINDOW_S)
        s = state()
        served_fps = (s["frame"] - f0) / (time.perf_counter() - w0)
        window = list(app.timings)[n0:]
        if http_get(base, "/api/quit") != b"bye":
            raise AssertionError("viewer: /api/quit refused")
        loop.join(timeout=120)
        http.join(timeout=30)
    finally:
        app.stop_event.set()
        server.shutdown()
        server.server_close()
        loop.join(timeout=120)
    launches = {n: c.launches for n, c in counters().items()}
    train, render, encode = (float(np.median([t[i] for t in window]))
                             for i in range(3))
    rec = {"phase": "viewer", "model": "ModelConfig() 2^19",
           "frame": f"{SIZE}^2", "first_frame_s": first_s, "edits": edits,
           "served_fps": served_fps, "window_frames": len(window),
           "train_ms_median": train, "render_ms_median": render,
           "encode_ms_median": encode,
           "encode_share": encode / (train + render + encode),
           "errors": s["errors"], "step": s["step"],
           "render_thread_alive": loop.is_alive(),
           "http_thread_alive": http.is_alive(), "launches": launches}
    log(rec)
    must = ("composite_slabs", "composite_slabs_ext", "raymarch_emit",
            "brick_sample", "pt_track", "pt_resolve", "fused_mlp",
            *TRAIN_KERNELS)
    if (s["errors"] or loop.is_alive() or http.is_alive() or not window
            or not all(launches[n] > 0 for n in must)):
        raise AssertionError(f"viewer fails its checks: {rec}")
    return rec


def phase_facade_cuda_vs_cpu(torch):
    """The facade's setters at phase_small_parity's size on the card
    against the CPU: DECODED_SLAB after set_transfer_function (a config,
    then a TransferFunctionObject) and set_framebuffer_size, every pixel
    within 5e-3; PATHTRACE_DECODED after reset_accumulation, from one
    uniform stream, PT_SHARE_MIN of the pixels within PT_PIXEL_TOL. Then
    memory_query, and free_temporary_memory returning a freed block's
    memory to the card."""
    from instantvnr_torch import api
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig,
                                         TransferFunctionConfig)
    from instantvnr_torch.models.network import params_from_numpy

    class Stream:
        def __init__(self):
            self.g = torch.Generator().manual_seed(SEED)

        def tau(self, r, device):
            return torch.rand(r, generator=self.g).to(device)

        def event(self, r, device):
            return torch.rand((6, r), generator=self.g).to(device)

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=4,
                                              n_features_per_level=2,
                                              log2_hashmap_size=12),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=2))
    tf1 = TransferFunctionConfig(
        colors=((0.0, 1.0, 0.1, 0.0), (1.0, 0.9, 0.8, 0.1)),
        alphas=((0.0, 0.0), (0.4, 0.5), (1.0, 0.9)))
    tf2 = api.TransferFunctionObject()
    tf2.set_color(((0.0, 0.1, 0.3, 1.0), (0.6, 0.9, 0.9, 0.2),
                   (1.0, 1.0, 0.1, 0.1)))
    tf2.set_alpha(((0.0, 0.1), (1.0, 0.7)))
    frames = {}
    for dev in ("cpu", "cuda"):
        sv = api.SimpleVolume.synthetic((32, 32, 32), "vorts", device=dev)
        nv = api.NeuralVolume(cfg, sv, device=dev)
        nv.params = params_from_numpy(seeded_params(nv.field, SEED + 3), dev)
        r = api.VNRenderer(nv, 40, 37)
        r.set_camera(orbit(2, N_FRAMES, 32))
        for view, setter in (("tf_config", lambda: r.set_transfer_function(
                tf1)), ("tf_handle", lambda: r.set_transfer_function(tf2)),
                ("framebuffer_size", lambda: r.set_framebuffer_size(33, 50))):
            setter()
            r.render()
            frames[dev, view] = r.mapframe()
        r.set_mode(api.RenderMode.PATHTRACE_DECODED)
        jitter = torch.rand((33 * 50, 2),
                            generator=torch.Generator().manual_seed(SEED + 1))
        r._impl._next_jitter = lambda j=jitter.to(dev): j
        r._impl._uniforms = Stream
        for _ in range(2):
            r.render()
        r.reset_accumulation()
        if r._impl.frame_index != 0:
            raise AssertionError("reset_accumulation left frame_index "
                                 f"{r._impl.frame_index}")
        r.render()
        frames[dev, "reset_accumulation"] = r.mapframe()
    for view in ("tf_config", "tf_handle", "framebuffer_size",
                 "reset_accumulation"):
        pt = view == "reset_accumulation"
        tol = PT_PIXEL_TOL if pt else 5e-3
        diff = np.abs(frames["cuda", view] - frames["cpu", view]).max(-1)
        rec = {"phase": f"facade_cuda_vs_cpu[{view}]",
               "shape": list(frames["cuda", view].shape),
               "max_abs_err": float(diff.max()), "tol": tol,
               "share_within_tol": float((diff <= tol).mean()),
               "share_min": PT_SHARE_MIN if pt else 1.0,
               "alpha_max": float(frames["cpu", view][..., 3].max())}
        log(rec)
        if (rec["share_within_tol"] < rec["share_min"]
                or not rec["alpha_max"] > 0.05
                or rec["shape"] != [50, 33, 4]
                and view in ("framebuffer_size", "reset_accumulation")):
            raise AssertionError(f"facade setters disagree: {rec}")
    query = api.memory_query()
    torch.cuda.synchronize()
    block = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    del block
    reserved = torch.cuda.memory_reserved()
    api.free_temporary_memory()
    rec = {"phase": "facade_memory", "memory_query": query,
           "reserved_before_free": reserved,
           "reserved_after_free": torch.cuda.memory_reserved()}
    log(rec)
    stats = query.get("cuda:0", {})
    if (set(stats) != {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
            or not 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"]
            or not rec["reserved_after_free"] < reserved):
        raise AssertionError(f"memory_query / free_temporary_memory: {rec}")


def phase_profile_trace(torch, tmp, ckpt):
    """vnr_cmd_render --profile DIR on the card from a checkpoint: the
    Chrome trace of DECODED_SLAB frames must name the slab compositor's
    kernel, that of exact NEURAL_WAVEFRONT frames the hash grid's and the
    fused MLP's."""
    from instantvnr_torch.apps import vnr_cmd_render

    want = {"decoded": ("slab_composite_kernel",),
            "neural": ("hash_encode_forward_kernel",
                       "fused_mlp_forward_kernel")}
    rec = {"phase": "profile_trace"}
    for mode, kernels in want.items():
        logdir = os.path.join(tmp, f"trace_{mode}")
        t0 = time.perf_counter()
        vnr_cmd_render.main(
            ["--load", ckpt, "--mode", mode, "--size", "256", "--num-frames",
             "2", "--warmup", "1", "--output", "", "--profile", logdir]
            + (["--streaming-cache", "none"] if mode == "neural" else []))
        path = os.path.join(logdir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        found = {k: sum(k in n for n in names) > 0 for k in kernels}
        rec[mode] = {"seconds": time.perf_counter() - t0,
                     "trace_bytes": os.path.getsize(path),
                     "events": len(events), "kernels_named": found}
        if not all(found.values()):
            log(rec)
            raise AssertionError(f"profile_trace: {mode} trace lacks "
                                 f"{[k for k, v in found.items() if not v]}")
    log(rec)
    return rec


def composite_inputs(torch, tf, cam, volume, shading="none", grads=None,
                     shadow=None):
    """(compositor, its args) for one 512² frame of `cam`, as the checkout's
    slab_composite_args builds them."""
    from instantvnr_torch.render.slabmarch import (SlabSettings, camera_arrays,
                                                   principal_axis,
                                                   slab_composite_args)

    axis, flipped = principal_axis(cam)
    comp, args, _ = slab_composite_args(
        volume, tf, camera_arrays(cam, "cuda"), SIZE, SIZE,
        SlabSettings(shading=shading), axis, flipped, grad_volumes=grads,
        shadow_volume=shadow)
    return comp, args


def composite_ops(torch, args, per_px=None, n_fields=1):
    """Operations these inputs need, counting an FMA as 2: only pixels and
    slabs that are covered and not yet terminated (replayed here in plain
    PyTorch, through the pairs densified) need work. Each needs its nonzero
    resample products (a row of My or Mx has at most 2 nonzeros) for each
    of n_fields fields, then per pixel (per_px): normalize 4, termination
    test 1, classify (per control segment 12: v-x0, divide, clamp 2, 4
    FMAs, as a segment's width and channel differences are constants; LUT
    17: scale, floor, clamp 2, frac, 4 x (difference, FMA)), opacity
    correction 4, blend 9. Returns (needed, dense resample, live
    pixel-slabs)."""
    from instantvnr_torch.ops import slab_composite as sc
    from instantvnr_torch.render.slabmarch import _densify_pairs

    vol, y_pairs, x_pairs, covy, covx, corr, ctrl, lut = args
    d, ay, ax = vol.shape
    hi, wi = corr.shape
    my_all = _densify_pairs(y_pairs, ay)
    mx_all = _densify_pairs(x_pairs, ax)
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


def dense_matrix_bytes(d, hi, wi, ay, ax):
    """The f32 bytes of the dense [D, hi, ay] and [D, wi, ax] interpolation
    stacks that the pairs replace (the dense design read them every frame)."""
    return 4 * d * (hi * ay + wi * ax)


def composite_record(torch, name, comp, args, plain, tol, ops, dense_ops,
                     live, n_bytes, bytes_dense, extra):
    """Run the compositor against its plain version, time both (the kernel
    by device time and by CUDA events, host work included), and the bounds
    of these inputs and of the dense inputs they replace → the phase's
    record."""
    got_c, got_a = comp(*args)
    ref_c, ref_a = plain(*args)
    torch.cuda.synchronize()
    err = max(float((got_c - ref_c).abs().max()),
              float((got_a - ref_a).abs().max()))
    ms = device_ms(torch, lambda: comp(*args), ("slab_composite_kernel",))
    call_ms = cuda_ms(torch, lambda: comp(*args), iters=10)
    plain_ms = cuda_ms(torch, lambda: plain(*args), iters=3, warmup=1)
    b_ms, b_by = bound_ms(n_bytes, ops, H100_FP32_FLOPS)
    bd_ms, bd_by = bound_ms(n_bytes + bytes_dense, ops, H100_FP32_FLOPS)
    rec = {"phase": name, **extra, "max_abs_err": err, "tol": tol, "ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": b_ms, "bound_by": b_by, "mbytes": n_bytes / 1e6,
           "bound_dense_inputs_ms": bd_ms, "bound_dense_inputs_by": bd_by,
           "mbytes_dense_inputs": (n_bytes + bytes_dense) / 1e6,
           "needed_gflop": ops / 1e9, "dense_gflop": dense_ops / 1e9,
           "live_pixel_slab_share": live,
           "alpha_max": float(ref_a.max())}
    log(rec)
    if not err <= tol or not rec["alpha_max"] > 0.05:
        raise AssertionError(f"{name}: the kernel disagrees: {rec}")
    return rec


def phase_composite(torch, name, tf, volume):
    from instantvnr_torch.ops import slab_composite as sc

    comp, args = composite_inputs(torch, tf, orbit(1, N_FRAMES, max(DIMS)),
                                  volume)
    vol, corr, ctrl, lut = args[0], args[5], args[6], args[7]
    (d, ay, ax), (hi, wi) = vol.shape, corr.shape
    ops, dense_ops, live = composite_ops(torch, args)
    # each input once (the pairs included), the 4 output planes once
    n_bytes = nbytes(*args) + 4 * corr.numel() * 4
    return composite_record(
        torch, f"composite_slabs[{name}]", comp, args,
        sc.composite_slabs_reference, COMP_ATOL[name], ops, dense_ops,
        live / d / corr.numel(), n_bytes,
        dense_matrix_bytes(d, hi, wi, ay, ax) - nbytes(args[1], args[2]),
        {"form": "lut" if lut is not None else "controls",
         "kc": int(ctrl.shape[0]),
         "shape": {"D": d, "ay": ay, "ax": ax, "hi": hi, "wi": wi}})


def ext_ops(torch, args):
    """composite_ops for composite_slabs_ext: the same live pixel-slabs,
    their nonzero resample products for every field (value, gradient,
    shadow), classification, and the shading and shadow operations of
    SHADE_OPS and SHADOW_OPS. Returns (needed, dense resample, live
    pixel-slabs)."""
    fields, svol, y_pairs, x_pairs, covy, covx, corr = args[:7]
    ctrl, lut = args[10], args[13]
    c_f = fields.shape[1]
    nf = c_f + (svol is not None)
    per_px = (18 + (17 if lut is not None else 12 * (ctrl.shape[0] - 1))
              + (SHADE_OPS if c_f == 4 else 0)
              + (SHADOW_OPS if svol is not None else 0))
    return composite_ops(torch, (fields[:, 0], y_pairs, x_pairs, covy, covx,
                                 corr, ctrl, lut), per_px=per_px, n_fields=nf)


def phase_composite_ext(torch, name, tf, volume, grads, shadow):
    from instantvnr_torch.ops import slab_composite as sc

    shade = "shaded" in name
    comp, args = composite_inputs(
        torch, tf, orbit(1, N_FRAMES, max(DIMS)), volume,
        "gradient" if shade else "none", grads if shade else None,
        shadow if "shadow" in name else None)
    fields, corr, ctrl, lut = args[0], args[6], args[10], args[13]
    d, c_f, ay, ax = fields.shape
    hi, wi = corr.shape
    ops, dense_ops, live = ext_ops(torch, args)
    # every input but perm (three ints) once, the 4 output planes once
    n_bytes = nbytes(*args[:12], args[13]) + 4 * corr.numel() * 4
    return composite_record(
        torch, f"composite_slabs_ext[{name}]", comp, args,
        sc.composite_slabs_ext_reference, EXT_ATOL[name], ops, dense_ops,
        live / d / corr.numel(), n_bytes,
        dense_matrix_bytes(d, hi, wi, ay, ax) - nbytes(args[2], args[3]),
        {"form": "lut" if lut is not None else "controls",
         "kc": int(ctrl.shape[0]),
         "shape": {"D": d, "C": c_f, "shadow": args[1] is not None,
                   "ay": ay, "ax": ax, "hi": hi, "wi": wi}})


def iso_ops(torch, args, iso):
    """Operations the sweep's inputs need, counting an FMA as 2: at each slab
    only the pixels covered and not yet hit (replayed here in plain PyTorch,
    through the pairs) need their nonzero resample products for the 4 fields
    (counted separably, as composite_ops does) and ISO_OPS of the crossing
    test. Returns (needed, dense resample, live pixel-slabs)."""
    from instantvnr_torch.ops.slab_composite import resample_pairs

    fields, y_pairs, x_pairs, covy, covx = args
    d, _, ay, ax = fields.shape
    hi, wi = covy.shape[1], covx.shape[1]
    nnz_my = (y_pairs[1] != 0).sum(-1)  # [D, hi]
    nnz_mx = (x_pairs[1] != 0).sum(-1)  # [D, wi]
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
        vals = resample_pairs(fields[k, 0], (y_pairs[0][k], y_pairs[1][k]),
                              (x_pairs[0][k], x_pairs[1][k]))
        found |= prev_ok & cov & ((prev_v - iso) * (vals - iso) <= 0.0)
        prev_v, prev_ok = vals, cov
    return float(ops), 4 * 2 * d * (hi * ay * ax + hi * wi * ax), \
        int(live_total)


def phase_iso_sweep(torch, volume, grads, iso):
    """The sweep on one 512² orbit frame's inputs (the pairs) against its
    plain version: found must agree on ISO_FOUND_AGREE of the pixels and
    hit_z, hit_g within ISO_ATOL where both found a hit (the kernel is
    expected to equal it bit for bit). Timed by device time and by CUDA
    events; bounds of these inputs and of the dense inputs of the previous
    design (the two [D, n, n_in] matrix stacks, 10 state planes)."""
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
    same_bits = (torch.equal(f1, f2) and torch.equal(z1, z2)
                 and torch.equal(g1, g2))
    ms = device_ms(torch, lambda: isw.iso_sweep(*args, iso),
                   ("iso_sweep_kernel",))
    call_ms = cuda_ms(torch, lambda: isw.iso_sweep(*args, iso), iters=10)
    plain_ms = cuda_ms(torch, lambda: isw.iso_sweep_reference(*args, iso),
                       iters=3, warmup=1)
    ops, dense_ops, live = iso_ops(torch, args, iso)
    fields, y_pairs, x_pairs, covy, covx = args
    d, _, ay, ax = fields.shape
    hi, wi = f1.shape
    # each input once (the pairs included), the 5 output planes once
    n_bytes = nbytes(*args) + 5 * hi * wi * 4
    bytes_dense = (nbytes(fields, covy, covx) + 10 * hi * wi * 4
                   + dense_matrix_bytes(d, hi, wi, ay, ax))
    b_ms, b_by = bound_ms(n_bytes, ops, H100_FP32_FLOPS)
    bd_ms, bd_by = bound_ms(bytes_dense, ops, H100_FP32_FLOPS)
    rec = {"phase": "iso_sweep", "iso": iso,
           "shape": {"D": d, "ay": ay, "ax": ax, "hi": hi, "wi": wi},
           "found_agree": agree, "found_agree_min": ISO_FOUND_AGREE,
           "found_mismatches": int((f1 != f2).sum()),
           "max_abs_err": err, "tol": ISO_ATOL, "same_bits": same_bits,
           "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "mbytes": n_bytes / 1e6, "bound_dense_inputs_ms": bd_ms,
           "bound_dense_inputs_by": bd_by,
           "mbytes_dense_inputs": bytes_dense / 1e6,
           "needed_gflop": ops / 1e9, "dense_gflop": dense_ops / 1e9,
           "live_pixel_slab_share": live / d / (hi * wi),
           "hit_share": float(f2.mean())}
    log(rec)
    if (agree < ISO_FOUND_AGREE or not err <= ISO_ATOL
            or not rec["hit_share"] > 0.05):
        raise AssertionError(f"iso_sweep kernel disagrees: {rec}")
    return rec


# volumes one voxel thick (dx, dy, dz) and an eye each whose slabs hold the
# one-voxel axis (tests/test_torch_slab_composite.py holds the CPU's frames
# to the JAX package's at these dims)
ONE_VOXEL = (((16, 1, 16), (3, 20, -40)), ((16, 1, 16), (40, 15, 5)),
             ((16, 16, 1), (60, 9, 7)), ((16, 16, 1), (-4, 66, 3)))


def phase_one_voxel(torch):
    """A DECODED_SLAB and an isosurface frame of each ONE_VOXEL volume
    through the kernels on the card against the plain path on the CPU; each
    frame launches its kernel once."""
    from instantvnr_torch.accel import macrocell
    from instantvnr_torch.config import TransferFunctionConfig
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.render.decoded import DecodedRenderer
    from instantvnr_torch.render.isosurf import IsoRenderer
    from instantvnr_torch.utils.tfn import bake_transfer_function

    tol = 5e-3
    for dims, eye in ONE_VOXEL:
        cam = Camera(eye=eye, center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
                     fovy=40.0)
        for view in ("decoded_slab", "isosurface"):
            frames, launches = {}, {}
            for dev in ("cpu", "cuda"):
                vol = synthetic_volume(dims, kind="vorts", device=dev)
                tf = bake_transfer_function(TransferFunctionConfig(),
                                            device=dev)
                if view == "decoded_slab":
                    r = DecodedRenderer(32, 32, macrocell.build(
                        vol.data, vol.dims, tf), tf, vol.dims,
                        initial_volume=vol.data, device=dev)
                else:
                    r = IsoRenderer(32, 32, vol.data, tf, isovalue=float(
                        vol.data.median()), device=dev)
                r.set_camera(cam)
                frames[dev], launches[dev] = launches_during(
                    lambda: (r.render(), r.mapframe())[1])
            diff = np.abs(frames["cuda"] - frames["cpu"])
            share = float((diff.max(-1) <= tol).mean())
            kernel = ("composite_slabs" if view == "decoded_slab"
                      else "iso_sweep")
            expect = {n: int(n == kernel) for n in counters()}
            rec = {"phase": f"one_voxel_cuda_vs_cpu[{view}, {dims}, {eye}]",
                   "max_abs_err": float(diff.max()), "tol": tol,
                   "share_within_tol": share,
                   "share_min": 0.995 if view == "isosurface" else 1.0,
                   "alpha_max": float(frames["cpu"][..., 3].max()),
                   "launches": launches["cuda"]}
            log(rec)
            if (share < rec["share_min"] or not rec["alpha_max"] > 0.3
                    or launches["cuda"] != expect
                    or any(launches["cpu"].values())):
                raise AssertionError(f"one-voxel frame disagrees: {rec}")


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


def dispatched_ops(torch, fn):
    """The PyTorch operations fn dispatches (a TorchDispatchMode count):
    the host issues each, so a stage of many small ones is host-bound."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def phase_breakdown(torch, nv, renderer, r_iso):
    """Where the main path's time goes: each stage of one decode blob and
    of one frame of each view timed alone with CUDA events, on the main
    path's inputs."""
    from instantvnr_torch.models.metrics import _grid_coords_slab
    from instantvnr_torch.models.network import render_params
    from instantvnr_torch.ops.fused_mlp import fused_mlp_apply
    from instantvnr_torch.ops.hash_encoding import hash_encode
    from instantvnr_torch.ops.iso_sweep import iso_sweep
    from instantvnr_torch.render.isosurf import slab_iso_args
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
    # the decode's gather: K3 on the bf16 table
    feats = hash_encode(rp["table"], coords, field.spec,
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

    frame(r_iso)  # the isosurface view's gradients are cached from here on
    iso_impl = r_iso._impl

    def iso_inputs():
        return slab_iso_args(iso_impl.grid, iso_impl._grads, SIZE, SIZE,
                             iso_impl.settings, axis, flipped, cam_arrays,
                             iso_impl.transform)[0]

    iso_args = iso_inputs()

    rec = {"phase": "breakdown",
           "render_params_ms": cuda_ms(torch, lambda: render_params(
               nv.params, field), iters=5),
           "blob_coords_ms": cuda_ms(torch, lambda: _grid_coords_slab(
               nv.dims, 0, 16, dev)),
           "blob_hash_encode_ms": cuda_ms(torch, lambda: hash_encode(
               rp["table"], coords, field.spec,
               compute_dtype=torch.bfloat16)),
           "blob_fused_mlp_ms": cuda_ms(torch, lambda: fused_mlp_apply(
               rp["mlp"], feats, field.cfg.network)),
           "frame_inputs_ms": cuda_ms(torch, lambda: inputs(impl.settings),
                                      iters=10),
           "frame_inputs_ops": dispatched_ops(torch, lambda: inputs(
               impl.settings)),
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
           "frame_inputs_ext_ops": dispatched_ops(
               torch, lambda: inputs(shaded, grads, shadow)),
           "frame_composite_ext_ms": cuda_ms(
               torch, lambda: comp_ext(*args_ext), iters=10),
           "iso_frame_total_ms": cuda_ms(torch, lambda: frame(r_iso),
                                         iters=10),
           # an isosurface frame's sweep inputs and kernel
           "iso_frame_inputs_ms": cuda_ms(torch, iso_inputs, iters=10),
           "iso_frame_inputs_ops": dispatched_ops(torch, iso_inputs),
           "iso_frame_sweep_ms": cuda_ms(
               torch, lambda: iso_sweep(*iso_args, iso_impl.isovalue),
               iters=10)}
    log(rec)
    return rec


def counters():
    """Every kernel's launch counter, by kernel name."""
    from instantvnr_torch.ops import adam as kadam
    from instantvnr_torch.ops import brick_sample as bs
    from instantvnr_torch.ops import compaction as cp
    from instantvnr_torch.ops import fused_mlp as fm
    from instantvnr_torch.ops import hash_encoding as he
    from instantvnr_torch.ops import iso_sweep as isw
    from instantvnr_torch.ops import isosurface as mt
    from instantvnr_torch.ops import pathtrace as opt
    from instantvnr_torch.ops import slab_composite as sc
    from instantvnr_torch.render import raymarch as rm

    return {"fused_mlp": fm.counter,
            "fused_mlp_train_forward": fm.train_forward_counter,
            "fused_mlp_backward": fm.backward_counter,
            "hash_encode_forward": he.counter,
            "hash_encode_backward": he.backward_counter,
            "hash_encode_forward_paired": he.paired_counter,
            "hash_encode_backward_paired": he.paired_backward_counter,
            "hash_encode_coords_backward": he.coords_counter,
            "composite_slabs": sc.counter,
            "composite_slabs_ext": sc.ext_counter, "iso_sweep": isw.counter,
            "raymarch_emit": rm.emit_counter,
            "raymarch_emit_backward": rm.emit_backward_counter,
            "pt_track": opt.track_counter,
            "pt_resolve": opt.resolve_counter, "brick_sample": bs.counter,
            "mt_count/mt_emit": mt.counter,
            "compact_rows": cp.compact_counter,
            "scatter_rows": cp.scatter_counter, "adam_step": kadam.counter}


def decode_launches(torch, fn):
    """A decode with every launch count set to 0 just before and the plain
    packed gather refused: → (fn(), the kernels it launched, by count)."""
    from instantvnr_torch.models import network

    plain = network.hash_encode_packed

    def refuse(*args, **kw):
        raise AssertionError("the card's decode called the plain packed "
                             "gather")

    for c in counters().values():
        c.reset()
    network.hash_encode_packed = refuse
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        network.hash_encode_packed = plain
    return out, {n: c.launches for n, c in counters().items() if c.launches}


def plain_packed_decode(torch, nv):
    """The grid of nv's params through the plain versions on the card, blob
    by blob as decode_volume runs: hash_encode_packed of the render params'
    bf16 table and its corner-packed dense levels, then the plain MLP."""
    from instantvnr_torch.models.metrics import _grid_coords_slab
    from instantvnr_torch.models.network import render_params
    from instantvnr_torch.ops import fused_mlp as fm
    from instantvnr_torch.ops import hash_encoding as he

    field = nv.field
    rp = render_params(nv.params, field)
    packed = he.packed_dense_tables(rp["table"], field.spec)
    dx, dy, dz = nv.dims
    blobs = []
    for z0 in range(0, dz, 16):
        feats = he.hash_encode_packed(
            rp["table"], packed, _grid_coords_slab(nv.dims, z0, 16, "cuda"),
            field.spec, compute_dtype=torch.bfloat16)
        blobs.append(fm.fused_mlp_reference(rp["mlp"], feats,
                                            field.cfg.network
                                            ).reshape(16, dy, dx))
    return torch.cat(blobs)[:dz]


def phase_decode_vs_plain(torch, nv, grid):
    """The main path's decoded grid against plain_packed_decode of the same
    params, at the decode tolerance: the fused MLP's, as the port holds its
    decode to the JAX package's (tests/test_torch_slice.py)."""
    ref = plain_packed_decode(torch, nv)
    diff = (grid - ref).abs()
    rec = {"phase": "decode_vs_plain_packed", "max_abs_err": float(diff.max()),
           "mean_abs_err": float(diff.mean()),
           "tol": f"atol=rtol={MLP_ATOL}, mean<={MLP_MEAN_TOL}"}
    log(rec)
    if not (bool((diff <= MLP_ATOL + MLP_RTOL * ref.abs()).all())
            and rec["mean_abs_err"] <= MLP_MEAN_TOL):
        raise AssertionError(f"the decoded grid misses the plain packed "
                             f"decode: {rec}")


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

    t0 = time.perf_counter()
    # the mode's grid is nv.decode_volume(), cached on the params
    grid, decode = decode_launches(torch, lambda: (r.set_mode(
        api.RenderMode.ISOSURFACE_DECODED), nv.decode_volume())[1])
    iso = float(grid.median())
    r.set_isovalue(iso)
    torch.cuda.synchronize()
    set_mode_ms = (time.perf_counter() - t0) * 1e3
    rec = run_orbit(torch, r, "view_isosurface_decoded")
    rec.update(isovalue=iso, set_mode_ms=set_mode_ms,
               decode_launches=decode)
    check(rec, {"iso_sweep": N_FRAMES})
    if decode != DECODE_LAUNCHES:
        raise AssertionError(f"ISOSURFACE_DECODED's decode_volume launched "
                             f"{decode}, not {DECODE_LAUNCHES}")
    if not rec["hit_share_min"] >= 0.05:
        raise AssertionError(f"isosurface hits under 5% of a frame: {rec}")
    return views


def wavefront_rays(torch, sv, w, h, cam):
    """The voxel-space rays of a frame over sv, and its flipped light."""
    from instantvnr_torch.render.raymarch import DEFAULT_LIGHT
    from instantvnr_torch.render.renderer import _frame_rays
    from instantvnr_torch.render.slabmarch import camera_arrays

    org, dirn, t0, t1, light, _, _ = _frame_rays(
        w, h, camera_arrays(cam, sv.device),
        torch.tensor(sv.dims, dtype=torch.float32, device=sv.device),
        torch.tensor(DEFAULT_LIGHT, device=sv.device), sv.transform)
    return org, dirn, t0, t1, light


def phase_raymarch_emit(torch, sv):
    """raymarch_emit on the neural wavefront's shapes (R = 512² rays of an
    orbit frame over vorts 128³, K = 8 slots, 8 skips), from the state after
    a first superstep, against the plain _emit_samples: equal bit for bit.
    Timed by device time and CUDA events; the bound from this run's bytes
    and the operations of the probes its data needs."""
    from instantvnr_torch.render import raymarch as rm

    org, dirn, t0, t1, _ = wavefront_rays(torch, sv, SIZE, SIZE,
                                          orbit(1, N_FRAMES, max(DIMS)))
    mc = sv.macrocell
    k, skips = 8, 8
    state = rm.init_ray_state(t0, t1)
    (t, tce, ss), *_ = rm._emit_samples(org, dirn, t1, state, mc, 1.0, k,
                                        skips)
    state = state._replace(t=t, t_cell_end=tce, ss=ss)

    def kernel():
        return rm.raymarch_emit(org, dirn, t1, state, mc, 1.0, k, skips)

    def plain():
        return rm._emit_samples(org, dirn, t1, state, mc, 1.0, k, skips)

    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    outs = list(zip(got[0] + got[1:], ref[0] + ref[1:]))
    same_bits = all(torch.equal(g, r) for g, r in outs)
    err = max(float((g.float() - r.float()).abs().max()) for g, r in outs)
    probes = rm._emit_samples(org, dirn, t1, state, mc, 1.0, k, skips,
                              count_probes=True)[-1]
    r = org.shape[0]
    n_bytes = (nbytes(org, dirn, t1, state.t, state.t_cell_end, state.ss,
                      mc.max_opacity) + nbytes(*got[0], *got[1:]))
    ops = probes * EMIT_PROBE_OPS + r * k * EMIT_SLOT_OPS
    b_ms, b_by = bound_ms(n_bytes, ops, H100_FP32_FLOPS)
    rec = {"phase": "raymarch_emit", "rays": r, "slots": k,
           "max_skips": skips, "probes": probes,
           "valid_slots": int(ref[3].sum()), "same_bits": same_bits,
           "max_abs_err": err, "tol": "bit for bit",
           "ms": device_ms(torch, kernel, ("raymarch_emit_kernel",)),
           "call_ms": cuda_ms(torch, kernel),
           "plain_ms": cuda_ms(torch, plain, iters=3, warmup=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "mbytes": n_bytes / 1e6, "gflop": ops / 1e9}
    log(rec)
    if not same_bits:
        raise AssertionError(f"raymarch_emit differs from its plain "
                             f"version: {rec}")
    return rec


def emit_backward_record(torch, name, org, dirn, t_far, state, mc, k,
                         skips):
    """raymarch_emit_backward on one emission's inputs and random
    cotangents of all five outputs, against the plain backward (EMIT_BWD_
    RTOL of each leaf's largest entry) and its bits over two launches;
    device time beside the plain version's and the bound from this run's
    bytes and the operations of the probes its data needs."""
    from instantvnr_torch.render import raymarch as rm

    r = org.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40 + k)
    grads = [torch.randn(sh, generator=gen, device="cuda")
             for sh in ((r,),) * 3 + ((r, k),) * 2]
    ins = (org, dirn, t_far, state.t, state.t_cell_end, state.ss)
    args = (mc, 1.0, k, skips, 1)
    need = (True,) * 6

    def kernel():
        return rm._kernel_emit_backward(*ins, grads, need, *args)

    def plain():
        return rm._plain_emit_backward(*ins, grads, need, *args)

    got, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    leaves = ("org", "dirn", "t_far", "t", "t_cell_end", "ss")
    errs = {n: float((g - w).abs().max()) for n, g, w in zip(leaves, got,
                                                              ref)}
    largest = {n: float(w.abs().max()) for n, w in zip(leaves, ref)}
    ok = all(errs[n] <= EMIT_BWD_RTOL * largest[n] for n in leaves)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    probes = rm._emit_samples(org, dirn, t_far, state, mc, 1.0, k, skips,
                              count_probes=True)[-1]
    n_bytes = (nbytes(*ins, mc.max_opacity) + nbytes(*grads)
               + nbytes(*got))
    ops = (probes * EMIT_BWD_PROBE_OPS + r * k * EMIT_BWD_SLOT_OPS
           + r * EMIT_BWD_RAY_OPS)
    b_ms, b_by = bound_ms(n_bytes, ops, H100_FP32_FLOPS)
    rec = {"phase": f"raymarch_emit_backward[{name}]", "rays": r,
           "slots": k, "max_skips": skips, "probes": probes,
           "max_abs_err_by_leaf": errs, "largest_by_leaf": largest,
           "max_abs_err": max(errs.values()),
           "tol": f"{EMIT_BWD_RTOL} of each leaf's largest entry",
           "same_bits": all(torch.equal(a, b) for a, b in zip(got, again)),
           "finite": finite,
           "ms": device_ms(torch, kernel,
                           ("raymarch_emit_backward_kernel",), per_call=1),
           "call_ms": cuda_ms(torch, kernel),
           "plain_ms": cuda_ms(torch, plain, iters=3, warmup=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "mbytes": n_bytes / 1e6, "gflop": ops / 1e9}
    log(rec)
    if not (ok and rec["same_bits"] and finite
            and max(largest.values()) > 0):
        raise AssertionError(f"raymarch_emit_backward differs from its "
                             f"plain version: {rec}")
    return rec


def emit_backward_shapes(torch, sv):
    """The emission's backward's three main-path shapes over sv: R = 512²
    orbit rays over vorts 128³, K = 8 (the emission phase's, the state
    after a first superstep), and the differentiable march's 128² frame's
    rays, K = FIXED_ITERS, from the fresh state and after a first
    superstep; 8 skips → [(name, org, dirn, t_far, state, K)]."""
    from instantvnr_torch.render import raymarch as rm

    shapes = []
    for name, size, k, cam, fresh in (
            (f"{SIZE}^2", SIZE, 8, orbit(1, N_FRAMES, max(DIMS)), False),
            (f"{FIXED_SIZE}^2 frame, fresh", FIXED_SIZE, FIXED_ITERS,
             orbit(0, N_FRAMES, max(DIMS)), True),
            (f"{FIXED_SIZE}^2 frame", FIXED_SIZE, FIXED_ITERS,
             orbit(0, N_FRAMES, max(DIMS)), False)):
        org, dirn, t0, t1, _ = wavefront_rays(torch, sv, size, size, cam)
        state = rm.init_ray_state(t0, t1)
        if not fresh:
            (t, tce, ss), *_ = rm._emit_samples(org, dirn, t1, state,
                                                sv.macrocell, 1.0, k, 8)
            state = state._replace(t=t, t_cell_end=tce, ss=ss)
        shapes.append((name, org, dirn, t1, state, k))
    return shapes


def phase_raymarch_emit_backward(torch, sv):
    """raymarch_emit_backward at its three main-path shapes
    (emit_backward_shapes) → the 512² record (the kernels line's)."""
    recs = [emit_backward_record(torch, name, org, dirn, t_far, state,
                                 sv.macrocell, k, 8)
            for name, org, dirn, t_far, state, k in
            emit_backward_shapes(torch, sv)]
    return recs[0]


def run_wavefront_mode(torch, nv, mode):
    """WAVEFRONT_FRAMES frames of one wavefront mode at SIZE² on an orbit,
    the launch counts from 0 before and read after; then one more frame
    under torch.profiler for the device's busy time against the host's
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    from instantvnr_torch import api

    r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode[mode],
                       streaming_cache="none")
    torch.cuda.synchronize()
    for c in counters().values():
        c.reset()
    frame_ms, supersteps, alpha_max = [], [], []
    for i in range(WAVEFRONT_FRAMES):
        t0 = time.perf_counter()
        r.set_camera(orbit(i, N_FRAMES, max(DIMS)))
        r.render()
        frame = r.mapframe()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        supersteps.append(r.last_stats["supersteps"])
        if frame.shape != (SIZE, SIZE, 4) or not np.isfinite(frame).all():
            raise AssertionError(f"{mode} frame {i}: bad shape or "
                                 "non-finite")
        alpha_max.append(float(frame[..., 3].max()))
    launches = {n: c.launches for n, c in counters().items()}
    # a rolled-back frame's serialized redo marches too
    supersteps.append(r._impl.redo_stats.get("supersteps", 0))
    r.set_camera(orbit(WAVEFRONT_FRAMES, N_FRAMES, max(DIMS)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.render()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(kernel_us(e) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"phase": f"wavefront[{mode}]", "frames": WAVEFRONT_FRAMES,
            "frame_ms": frame_ms, "ms_per_frame": float(np.mean(frame_ms)),
            "supersteps": supersteps, "alpha_max_min": min(alpha_max),
            "launches": launches,
            "profiled_frame": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                               "device_idle_share": 1.0 - busy_ms / wall_ms,
                               "supersteps": r.last_stats["supersteps"]}}


def phase_wavefront_views(torch, nv):
    """The seven wavefront modes of this slice at SIZE² on the main path's
    2^19 model and vorts volume: every emission through raymarch_emit (one
    launch a superstep, the SSH shadow march's included), the neural modes'
    samples through K3 and K1, no other kernel."""
    recs = []
    torch.cuda.reset_peak_memory_stats()
    for mode in WAVEFRONT_MODES:
        rec = run_wavefront_mode(torch, nv, mode)
        log(rec)
        ln = rec["launches"]
        neural = mode.startswith("NEURAL")
        others = {n: v for n, v in ln.items()
                  if n not in ("raymarch_emit", "fused_mlp",
                               "hash_encode_forward", "compact_rows",
                               "scatter_rows")}
        if (ln["raymarch_emit"] != sum(rec["supersteps"])
                or any(others.values())
                or (ln["fused_mlp"] > 0) != neural
                or ln["fused_mlp"] != ln["hash_encode_forward"]
                or not rec["alpha_max_min"] > 0.05):
            raise AssertionError(f"{mode}: wrong launches or an invisible "
                                 f"frame: {rec}")
        recs.append(rec)
    log({"phase": "wavefront_memory",
         "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return recs


def phase_wavefront_cuda_vs_cpu(torch):
    """Each wavefront mode at a small size (a 4-level model with seeded
    weights, vorts 32³, 40 × 37) on the card against the CPU, the same
    jitter handed to both."""
    from instantvnr_torch import api
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig)
    from instantvnr_torch.models.network import params_from_numpy

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=4,
                                              n_features_per_level=2,
                                              log2_hashmap_size=12),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=2))
    w, h = 40, 37
    jitter = torch.rand(w * h, generator=torch.Generator().manual_seed(SEED))
    frames = {}
    for dev in ("cpu", "cuda"):
        sv = api.SimpleVolume.synthetic((32, 32, 32), "vorts", device=dev)
        nv = api.NeuralVolume(cfg, sv, device=dev)
        nv.params = params_from_numpy(seeded_params(nv.field, SEED + 3), dev)
        for mode in WAVEFRONT_MODES:
            r = api.VNRenderer(nv, w, h, api.RenderMode[mode],
                               streaming_cache="none")
            r._impl._next_jitter = lambda j=jitter.to(dev): j
            r.set_camera(orbit(2, N_FRAMES, 32))
            r.render()
            frames[dev, mode] = r.mapframe()
    tol = 5e-3
    for mode in WAVEFRONT_MODES:
        diff = np.abs(frames["cuda", mode] - frames["cpu", mode])
        share = float((diff.max(-1) <= tol).mean())
        rec = {"phase": f"wavefront_cuda_vs_cpu[{mode}]",
               "max_abs_err": float(diff.max()),
               "mean_abs_err": float(diff.mean()), "tol": tol,
               "share_within_tol": share, "share_min": WAVEFRONT_SHARE_MIN,
               "alpha_max": float(frames["cpu", mode][..., 3].max())}
        log(rec)
        if share < WAVEFRONT_SHARE_MIN or not rec["alpha_max"] > 0.05:
            raise AssertionError(f"small wavefront frame disagrees: {rec}")


def phase_fallbacks(torch, nv):
    """A degenerate camera (the eye inside the volume, looking along a
    diagonal with a wide fov: a frustum corner looks backward along the
    principal axis, so no slab factorization) in DECODED_SLAB, on the main
    path's decoded grid, through the wavefront (raymarch_emit, no
    compositor), and in ISOSURFACE_DECODED through the brute-force
    first-hit marcher (plain PyTorch: no kernel)."""
    from instantvnr_torch import api
    from instantvnr_torch.render.camera import Camera
    from instantvnr_torch.render.slabmarch import (principal_axis,
                                                   slab_path_valid)

    d = max(DIMS)
    cam = Camera(eye=(-0.25 * d, -0.3 * d, -0.35 * d),
                 center=(0.25 * d, 0.2 * d, 0.15 * d), up=(0.0, 1.0, 0.0),
                 fovy=100.0)
    axis, flipped = principal_axis(cam)
    if slab_path_valid(cam, DIMS, axis, flipped, None, aspect=1.0):
        raise AssertionError("the fallback camera has a slab path")
    for mode, kernel in (("DECODED_SLAB", "raymarch_emit"),
                         ("ISOSURFACE_DECODED", None)):
        r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode[mode])
        if mode == "ISOSURFACE_DECODED":
            r.set_isovalue(float(nv.decode_volume().median()))
        r.set_camera(cam)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame, launches = launches_during(lambda: (r.render(),
                                                   r.mapframe())[1])
        rec = {"phase": f"fallback[{mode}]",
               "ms": (time.perf_counter() - t0) * 1e3,
               "alpha_max": float(frame[..., 3].max()),
               "launches": {n: v for n, v in launches.items() if v}}
        log(rec)
        ok = (np.isfinite(frame).all() and rec["alpha_max"] > 0.05
              and set(rec["launches"]) == ({kernel} if kernel else set()))
        if not ok:
            raise AssertionError(f"fallback frame: {rec}")


def phase_npz_roundtrip(torch, sv, tmp):
    """A native .npz checkpoint of a 2^14 volume trained 20 steps: loaded
    back, both volumes take one more step. The card's generator resumes
    exactly (the same state after the step, the same batch, the same loss
    bit for bit); params and moments agree to float32 sums in another
    order, since K4 adds the gradient table with atomics in an order that
    changes from run to run (NPZ_RTOL of each array's largest entry)."""
    from instantvnr_torch import api
    from instantvnr_torch.config import EncodingConfig, ModelConfig
    from instantvnr_torch.serializer import native_leaves

    cfg = ModelConfig(encoding=EncodingConfig(log2_hashmap_size=14))
    nv = api.NeuralVolume(cfg, sv, seed=SEED, device="cuda")
    nv.train(20)
    path = os.path.join(tmp, "smoke.npz")
    nv.save_params(path)
    back = api.NeuralVolume.from_checkpoint(path, simple=sv, device="cuda")
    for v in (nv, back):
        v.train(1, fast_mode=True)
    rel = max(float(np.abs(a.astype(np.float64) - b).max()
                    / max(np.abs(b).max(), 1e-30))
              for a, b in zip(native_leaves(nv.state),
                              native_leaves(back.state)))
    same_gen = torch.equal(nv.state.generator.get_state(),
                           back.state.generator.get_state())
    rec = {"phase": "npz_roundtrip", "bytes": os.path.getsize(path),
           "step": back.step, "loss": back.get_training_loss(),
           "loss_original": nv.get_training_loss(),
           "generator_equal": same_gen, "max_rel_err": rel,
           "tol": NPZ_RTOL}
    log(rec)
    if (not same_gen or rec["loss"] != rec["loss_original"]
            or back.step != 21 or not rel <= NPZ_RTOL):
        raise AssertionError(f"npz resume is not exact: {rec}")


def phase_cli(torch, tmp):
    """The port's CLI in-process on the card: a short training run of the
    2^14 schema saved as .npz, then DECODED_SLAB and NEURAL_WAVEFRONT
    renders of the checkpoint without a ground truth, and view_model."""
    from instantvnr_torch.apps import view_model, vnr_cmd_render
    from instantvnr_torch.apps import vnr_cmd_train

    model = os.path.join(tmp, "model14.json")
    with open(model, "w") as f:
        json.dump({"encoding": {"log2_hashmap_size": 14}}, f)
    npz = os.path.join(tmp, "cli.npz")
    t0 = time.perf_counter()
    vnr_cmd_train.main(["--synthetic", "vorts", "--dims", "64",
                        "--model", model, "--max-num-steps", "100",
                        "--save", npz, "--report-psnr"])
    train_s = time.perf_counter() - t0
    frames = {}
    for mode, extra in (("decoded", []),
                        ("neural", ["--streaming-cache", "none"])):
        frames[mode] = vnr_cmd_render.main(
            ["--load", npz, "--mode", mode, "--size", "256", "--num-frames",
             "2", "--warmup", "1", "--output",
             os.path.join(tmp, f"cli_{mode}.png")] + extra)
    info = view_model.main([npz])
    rec = {"phase": "cli", "train_s": train_s, "view_model": info,
           "alpha_max": {m: float(f[..., 3].max()) for m, f in
                         frames.items()}}
    log(rec)
    if (info["step"] != 100 or not all(np.isfinite(f).all()
                                       for f in frames.values())
            or min(rec["alpha_max"].values()) <= 0.05):
        raise AssertionError(f"cli: {rec}")


def pt_frame_state(torch, sv, n_events):
    """The tracker's state on a 512² frame's rays (orbit camera 1 over the
    main path's volume, brick pool of the grid, seeded draws) after
    n_events events, and the frame's constants."""
    from instantvnr_torch.render import pathtrace as tpt
    from instantvnr_torch.render.brickcache import (
        brick_sample_fn, build_brick_cache_from_grid)
    from instantvnr_torch.render.renderer import _frame_rays
    from instantvnr_torch.render.slabmarch import camera_arrays

    dev = sv.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    settings = tpt.PathTraceSettings()
    jitter = torch.rand((SIZE * SIZE, 2), generator=gen, device=dev)
    org, dirn, t0, t1, light, lo, hi = _frame_rays(
        SIZE, SIZE, camera_arrays(orbit(1, N_FRAMES, max(DIMS)), dev),
        torch.tensor(sv.dims, dtype=torch.float32, device=dev),
        torch.tensor(settings.light_dir, device=dev), sv.transform,
        jitter=jitter)
    mc, tf = sv.macrocell, sv.tf
    consts = tpt._pt_consts(mc, tf, settings, light, sv.transform.scale, lo,
                            hi)
    ctx = build_brick_cache_from_grid(sv.volume.data, mc)
    uni = tpt.TorchUniforms(gen)
    r = org.shape[0]
    st = tpt.init_pt_state(org, dirn, t0, t1,
                           -torch.log1p(-uni.tau(r, dev)))
    for _ in range(n_events):
        st = tpt._pt_event(lambda p: brick_sample_fn(ctx, p), settings, mc,
                           consts, st, uni.event(r, dev))
    return st, consts, ctx, uni, settings


def bits_equal(torch, a, b):
    """Bitwise equality (NaN included) of two tensors of one dtype."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def phase_pt_kernels(torch, sv):
    """pt_track and pt_resolve against their plain versions on a 512²
    frame's rays (R = 2^18), from the state after the first event and
    after PT_LATE_EVENT events (shadow rays in flight): pt_track bit for
    bit; pt_resolve's decisions bit for bit and its floats within
    PT_RESOLVE_RTOL (log1pf / sinf / cosf), with the share of rays whose
    floats differ at all. Device times, plain times and the bound from this
    run's bytes (the kernels' operations, ~60 a probe, stay under them)."""
    from instantvnr_torch.ops import pathtrace as opt
    from instantvnr_torch.render.brickcache import brick_sample_fn

    recs = {}
    mc = sv.macrocell
    for n_events in (1, PT_LATE_EVENT):
        st, consts, ctx, uni, settings = pt_frame_state(torch, sv, n_events)
        r = st.org.shape[0]
        track_args = (st.org, st.dirn, st.t, st.t_far, st.tau,
                      mc.max_opacity, mc.volume_dims, settings.density_scale,
                      settings.cell_skips)
        track = opt.pt_track(*track_args)
        track_ref = opt.pt_track_reference(*track_args)
        values = brick_sample_fn(ctx, track[5])
        u = uni.event(r, sv.device)
        res_args = (st.org, st.dirn, st.t_far, st.throughput, st.radiance,
                    st.scatter_index, st.shadow, st.active, *track[:5],
                    values, u, consts.ctrl, consts.lut, consts.vec,
                    settings.density_scale, settings.light_ambient)
        res = opt.pt_resolve(*res_args)
        res_ref = opt.pt_resolve_reference(*res_args)
        torch.cuda.synchronize()
        track_same = all(bits_equal(torch, a, b)
                         for a, b in zip(track, track_ref))
        decisions = all(torch.equal(res[i], res_ref[i]) for i in (7, 8, 9))
        floats = range(7)
        err = max(float(((res[i] - res_ref[i]).abs()
                         / torch.clamp(res_ref[i].abs(), min=1.0)).max())
                  for i in floats)
        differ = torch.zeros(r, dtype=torch.bool, device=sv.device)
        for i in floats:
            d = res[i] != res_ref[i]
            differ |= d if d.dim() == 1 else d.any(-1)
        shadow_rays = int((st.shadow & st.active).sum())
        track_bytes = (nbytes(st.org, st.dirn, st.t, st.t_far, st.tau,
                              mc.max_opacity) + nbytes(*track))
        probes = r * (settings.cell_skips + 1)
        tb_ms, tb_by = bound_ms(track_bytes, probes * PT_PROBE_OPS,
                                H100_FP32_FLOPS)
        res_bytes = (nbytes(*[a for a in res_args[:15]], consts.ctrl,
                            consts.vec) + nbytes(*res))
        ops = r * (PT_CONTROL_OPS * (consts.ctrl.shape[0] - 1)
                   + PT_RESOLVE_OPS)
        rb_ms, rb_by = bound_ms(res_bytes, ops, H100_FP32_FLOPS)
        rec = {"phase": f"pt_kernels[event {n_events}]", "rays": r,
               "active": int(st.active.sum()), "shadow_rays": shadow_rays,
               "pt_track": {
                   "same_bits": track_same, "max_abs_err": max(
                       float((a.float() - b.float()).abs().max())
                       for a, b in zip(track, track_ref)),
                   "ms": device_ms(torch, lambda: opt.pt_track(*track_args),
                                   ("pt_track_kernel",)),
                   "call_ms": cuda_ms(torch,
                                      lambda: opt.pt_track(*track_args)),
                   "plain_ms": cuda_ms(
                       torch, lambda: opt.pt_track_reference(*track_args),
                       iters=5, warmup=1),
                   "bound_ms": tb_ms, "bound_by": tb_by,
                   "mbytes": track_bytes / 1e6, "library_ms": None},
               "pt_resolve": {
                   "decisions_equal": decisions, "max_rel_err": err,
                   "tol": PT_RESOLVE_RTOL,
                   "rays_with_any_float_differing": int(differ.sum()),
                   "share_bit_equal": 1.0 - float(differ.float().mean()),
                   "max_abs_err": max(float((res[i] - res_ref[i]).abs().max())
                                      for i in floats),
                   "ms": device_ms(torch, lambda: opt.pt_resolve(*res_args),
                                   ("pt_resolve_kernel",)),
                   "call_ms": cuda_ms(torch,
                                      lambda: opt.pt_resolve(*res_args)),
                   "plain_ms": cuda_ms(
                       torch, lambda: opt.pt_resolve_reference(*res_args),
                       iters=5, warmup=1),
                   "bound_ms": rb_ms, "bound_by": rb_by,
                   "mbytes": res_bytes / 1e6, "library_ms": None}}
        log(rec)
        if (not track_same or not decisions or not err <= PT_RESOLVE_RTOL
                or (n_events > 1 and shadow_rays == 0)):
            raise AssertionError(f"pt kernels differ from their plain "
                                 f"versions: {rec}")
        recs[n_events] = rec
    return recs


def superstep_samples(torch, sv):
    """The positions a brick-wavefront superstep samples: the valid slots
    of the first superstep of a 512² orbit frame (n_iters = 8, 1 skip),
    and 1% more points anywhere (misses included)."""
    from instantvnr_torch.render import raymarch as rm

    org, dirn, t0, t1, _ = wavefront_rays(torch, sv, SIZE, SIZE,
                                          orbit(1, N_FRAMES, max(DIMS)))
    state = rm.init_ray_state(t0, t1)
    _, t_x, t_y, valid = rm.raymarch_emit(org, dirn, t1, state, sv.macrocell,
                                          1.0, 8, 1)
    gen = torch.Generator(device=sv.device).manual_seed(SEED)
    jit = torch.rand(t0.shape, generator=gen, device=sv.device)
    t_s = t_x + jit[:, None] * (t_y - t_x)
    pos = (org[:, None, :] + t_s[..., None] * dirn[:, None, :]) / torch.tensor(
        sv.dims, dtype=torch.float32, device=sv.device)
    pos = pos.reshape(-1, 3)[valid.reshape(-1)]
    extra = torch.rand((pos.shape[0] // 100, 3), generator=gen,
                       device=sv.device)
    return torch.cat([pos, extra]).contiguous()


def touched_sectors(torch, ctx, p):
    """The distinct 32-byte sectors of pool rows the samples read (the
    bytes the function needs from the pool; a miss reads no row)."""
    from instantvnr_torch.ops.brick_sample import _rows

    slot, idx, _ = _rows(ctx["lut"], p, ctx["dims"], ctx["mcdims"],
                         ctx["ss"])
    row_bytes = 8 * ctx["packed"].element_size()
    return int(torch.unique(idx[slot >= 0] * row_bytes // 32).numel())


def phase_brick_sample(torch, nv):
    """brick_sample against its plain version on a superstep's samples
    (BRICK_POOLS: f16 and f32 pools, ss = 1 and 2, the 2^19 model's decode
    into them through K3 and K1), misses included (every 7th macrocell
    taken out of the LUT): bit for bit. The bound
    from the bytes this data needs: the samples, the LUT, the distinct
    32-byte sectors of pool rows read and the values."""
    from instantvnr_torch.models.network import render_params
    from instantvnr_torch.ops import brick_sample as bs
    from instantvnr_torch.render.brickcache import build_brick_cache

    sv = nv.simple
    p = superstep_samples(torch, sv)
    params = render_params(nv.params, nv.field)
    recs = {}
    for name, dtype, ss, conv in BRICK_POOLS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx = build_brick_cache(nv.field, params, sv.macrocell,
                                dtype=getattr(torch, dtype), supersample=ss,
                                convention=conv)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        lut = ctx["lut"].clone()
        lut[::7] = -1
        ctx["lut"] = lut
        args = (lut, ctx["packed"], p, ctx["dims"], ctx["mcdims"], ss)
        got = bs.brick_sample(*args)
        ref = bs.brick_sample_reference(*args)
        torch.cuda.synchronize()
        sectors = touched_sectors(torch, ctx, p)
        n_bytes = nbytes(p, ctx["lut"]) + 32 * sectors + 4 * p.shape[0]
        b_ms, b_by = bound_ms(n_bytes, p.shape[0] * BRICK_SAMPLE_OPS,
                              H100_FP32_FLOPS)
        rec = {"phase": f"brick_sample[{name}]", "samples": p.shape[0],
               "misses": int((ref == 0).sum()), "pool_bytes": nbytes(
                   ctx["packed"]), "build_ms": build_ms,
               "distinct_sectors": sectors, "same_bits": torch.equal(got, ref),
               "max_abs_err": float((got - ref).abs().max()),
               "tol": "bit for bit",
               "ms": device_ms(torch, lambda: bs.brick_sample(*args),
                               ("brick_sample_kernel",)),
               "call_ms": cuda_ms(torch, lambda: bs.brick_sample(*args)),
               "plain_ms": cuda_ms(
                   torch, lambda: bs.brick_sample_reference(*args), iters=5,
                   warmup=1),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "mbytes": n_bytes / 1e6}
        log(rec)
        del ctx
        if not rec["same_bits"] or rec["misses"] == 0:
            raise AssertionError(f"brick_sample differs from its plain "
                                 f"version: {rec}")
        recs[name] = rec
    return recs


def profiled_frame(torch, r, render):
    """One frame under torch.profiler: the host's wall time against the
    device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(kernel_us(e) for e in cuda) / 1e3
    compaction_ms = sum(kernel_us(e) for e in cuda
                        if is_compaction_kernel(e.name)) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "compaction_device_ms": compaction_ms,
            **r.last_stats}


def run_pathtrace_mode(torch, nv, mode):
    """PT_FRAMES progressive frames of one path-tracing mode at SIZE² on
    orbit camera 0 (each timed from render() to the device's end), the
    launch counts from 0 before and read after; one more frame profiled;
    then PT_LONG_FRAMES more for the longer run's mean."""
    from instantvnr_torch import api

    t0 = time.perf_counter()
    r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode[mode])
    r.set_camera(orbit(0, N_FRAMES, max(DIMS)))
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    for c in counters().values():
        c.reset()
    frame_ms, events = [], []
    for _ in range(PT_FRAMES):
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        events.append(r.last_stats["events"])
    launches = {n: c.launches for n, c in counters().items()}
    events.append(r._impl.redo_stats.get("events", 0))  # rollbacks' redos
    frame = r.mapframe()
    if frame.shape != (SIZE, SIZE, 4) or not np.isfinite(frame).all():
        raise AssertionError(f"{mode}: bad shape or non-finite frame")
    prof = profiled_frame(torch, r, r.render)
    mean_short = float(frame[..., :3].mean())
    for _ in range(PT_LONG_FRAMES):
        r.render()
    long = r.mapframe()
    mean_long = float(long[..., :3].mean())
    return {"phase": f"pathtrace[{mode}]", "frames": PT_FRAMES,
            "setup_ms": setup_ms, "frame_ms": frame_ms,
            "ms_per_frame": float(np.mean(frame_ms[1:])), "events": events,
            "launches": launches, "profiled_frame": prof,
            "alpha_mean": float(frame[..., 3].mean()),
            "rgb_mean": mean_short,
            "rgb_mean_after": {"frames": r._impl.frame_index,
                               "rgb_mean": mean_long},
            "mean_band": PT_MEAN_BAND}


def phase_pathtrace(torch, nv):
    """The three path-tracing modes at SIZE² on the main path's volume and
    2^19 model: every event one pt_track and one pt_resolve launch; the
    grid modes' samples one brick_sample launch an event (the grid's brick
    pool), PATHTRACE_NEURAL's through K3 and K1 (one each an event with
    candidates), no other kernel."""
    recs = []
    torch.cuda.reset_peak_memory_stats()
    for mode in PT_MODES:
        rec = run_pathtrace_mode(torch, nv, mode)
        log(rec)
        ln = rec["launches"]
        n_ev = sum(rec["events"])
        neural = mode == "PATHTRACE_NEURAL"
        sampler = ({"fused_mlp", "hash_encode_forward"} if neural
                   else {"brick_sample"})
        others = {n: v for n, v in ln.items()
                  if n not in sampler | {"pt_track", "pt_resolve",
                                         "compact_rows", "scatter_rows"}}
        ok = (ln["pt_track"] == ln["pt_resolve"] == n_ev
              and not any(others.values())
              and all(0 < ln[s] <= n_ev for s in sampler)
              and (not neural or ln["fused_mlp"] == ln["hash_encode_forward"])
              and (neural or ln["brick_sample"] == n_ev)
              and rec["alpha_mean"] > 0.05
              and abs(rec["rgb_mean"] - rec["rgb_mean_after"]["rgb_mean"])
              <= PT_MEAN_BAND * rec["rgb_mean_after"]["rgb_mean"])
        if not ok:
            raise AssertionError(f"{mode}: wrong launches, an empty frame or "
                                 f"a mean out of its band: {rec}")
        recs.append(rec)
    log({"phase": "pathtrace_memory",
         "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return recs


def phase_brick_wavefront(torch, nv):
    """NEURAL_WAVEFRONT, _GRADIENT and _SSH on the default streaming_cache
    ("auto"), and "hq" and "lazy" on NEURAL_WAVEFRONT, at SIZE² on the
    main path's 2^19 model: the pool's build (K3 and K1), its bytes and
    dtype, streaming_cache_info, and WAVEFRONT_FRAMES orbit frames whose
    samples all go through brick_sample (one emission a superstep, no
    network launch)."""
    from instantvnr_torch import api

    recs = []
    for mode, policy in BRICK_WAVEFRONT:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode[mode],
                           streaming_cache=policy)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        ctx = r._brick_ctx()
        for c in counters().values():
            c.reset()
        frame_ms, supersteps, alpha_max = [], [], []
        for i in range(WAVEFRONT_FRAMES):
            t0 = time.perf_counter()
            r.set_camera(orbit(i, N_FRAMES, max(DIMS)))
            r.render()
            frame = r.mapframe()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            supersteps.append(r.last_stats["supersteps"])
            if not np.isfinite(frame).all():
                raise AssertionError(f"{mode}/{policy}: non-finite frame")
            alpha_max.append(float(frame[..., 3].max()))
        launches = {n: c.launches for n, c in counters().items()}
        supersteps.append(r._impl.redo_stats.get("supersteps", 0))
        rec = {"phase": f"brick_wavefront[{mode},{policy}]",
               "build_ms": build_ms, "pool_bytes": nbytes(ctx["packed"]),
               "pool_dtype": str(ctx["packed"].dtype),
               "streaming_cache_info": r.streaming_cache_info,
               "frame_ms": frame_ms, "ms_per_frame": float(np.mean(frame_ms)),
               "supersteps": supersteps, "alpha_max_min": min(alpha_max),
               "launches": launches,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if policy == "lazy":
            rec["lazy_decoded"] = [r._lazy.n_decoded, r._lazy.n_bricks]
        log(rec)
        ln = launches
        others = {n: v for n, v in ln.items()
                  if n not in ("raymarch_emit", "brick_sample", "fused_mlp",
                               "hash_encode_forward", "compact_rows",
                               "scatter_rows")}
        lazy_decodes = policy == "lazy" and ln["fused_mlp"] > 0
        if (ln["raymarch_emit"] != sum(supersteps) or any(others.values())
                or not ln["brick_sample"] >= 1
                or (ln["fused_mlp"] > 0 and not lazy_decodes)
                or rec["streaming_cache_info"]["resolved"] == "none"
                or not rec["alpha_max_min"] > 0.05):
            raise AssertionError(f"{mode}/{policy}: wrong launches, no pool "
                                 f"or an invisible frame: {rec}")
        recs.append(rec)
    return recs


def phase_pathtrace_cuda_vs_cpu(torch):
    """Each path-tracing mode at a small size (the 4-level model with
    seeded weights, vorts 32³, 40 × 37) on the card against the CPU, from
    one uniform stream drawn on the CPU and copied to both, and the same
    jitter: the share of pixels within PT_PIXEL_TOL."""
    from instantvnr_torch import api
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig)
    from instantvnr_torch.models.network import params_from_numpy

    class Stream:
        """Uniforms drawn on the CPU from a seeded generator, copied to
        the frame's device."""

        def __init__(self):
            self.g = torch.Generator().manual_seed(SEED)

        def tau(self, r, device):
            return torch.rand(r, generator=self.g).to(device)

        def event(self, r, device):
            return torch.rand((6, r), generator=self.g).to(device)

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=4,
                                              n_features_per_level=2,
                                              log2_hashmap_size=12),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=2))
    w, h = 40, 37
    jitter = torch.rand((w * h, 2),
                        generator=torch.Generator().manual_seed(SEED + 1))
    frames = {}
    for dev in ("cpu", "cuda"):
        sv = api.SimpleVolume.synthetic((32, 32, 32), "vorts", device=dev)
        nv = api.NeuralVolume(cfg, sv, device=dev)
        nv.params = params_from_numpy(seeded_params(nv.field, SEED + 3), dev)
        for mode in PT_MODES:
            r = api.VNRenderer(nv, w, h, api.RenderMode[mode])
            r._impl._next_jitter = lambda j=jitter.to(dev): j
            r._impl._uniforms = Stream
            r.set_camera(orbit(2, N_FRAMES, 32))
            r.render()
            frames[dev, mode] = r.mapframe()
    for mode in PT_MODES:
        diff = np.abs(frames["cuda", mode] - frames["cpu", mode]).max(-1)
        share = float((diff <= PT_PIXEL_TOL).mean())
        rec = {"phase": f"pathtrace_cuda_vs_cpu[{mode}]",
               "max_abs_err": float(diff.max()), "tol": PT_PIXEL_TOL,
               "pixels_over_tol": int((diff > PT_PIXEL_TOL).sum()),
               "share_within_tol": share, "share_min": PT_SHARE_MIN,
               "alpha_mean": float(frames["cpu", mode][..., 3].mean())}
        log(rec)
        if share < PT_SHARE_MIN or not rec["alpha_mean"] > 0.05:
            raise AssertionError(f"small path-traced frame disagrees: {rec}")


# -- the ninth slice: isosurfaces, scenes, analytic and out-of-core -------


def mt_plain(grid, iso, z0):
    """The plain version of one slab and its masked gather, on the grid's
    device."""
    from instantvnr_torch.ops import isosurface as mt

    tris, valid, ids = mt._extract_slab_reference(grid, iso, z0)
    return tris[valid], ids[valid]


def same_mesh(a, b):
    """Two (verts, faces) numpy meshes equal bit for bit."""
    return (a[0].shape == b[0].shape and a[1].shape == b[1].shape
            and np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
            and np.array_equal(a[1], b[1]))


def mt_slabs_equal(torch, grid, iso, slab):
    """Each slab of an extraction through the kernels against the plain
    version: (slabs, live triangles, all bit for bit)."""
    from instantvnr_torch.ops import isosurface as mt

    ok, k, n_slabs, z = True, 0, 0, 0
    while z < grid.shape[0] - 1:
        g = grid[z:z + slab + 1]
        kt, ki = mt.extract_slab(g, iso, z)
        pt, pi = mt_plain(g, iso, z)
        ok = ok and bits_equal(torch, kt, pt) and bits_equal(torch, ki, pi)
        k += kt.shape[0]
        n_slabs += 1
        z += slab
    return n_slabs, k, ok


def phase_isosurface_kernel(torch, vol, nv):
    """mt_count + mt_emit against the plain version on the card: on the
    vorts 128³ grid at its median (slabs of 32 planes, the grid path) and
    on the 17-plane slabs of the serving model's decode (the network
    path); tris and ids bit for bit slab by slab, then the welded mesh of
    the whole grid against the plain slabs welded alike. Times one 33-plane
    slab of the grid: the kernels' device time (torch.profiler) and the
    wrapper's call (CUDA events, the host read of the count included)
    against the plain version's."""
    from instantvnr_torch.ops import isosurface as mt

    iso = float(vol.median())
    grid_slabs, grid_tris, grid_ok = mt_slabs_equal(torch, vol, iso, 32)
    dec = nv.decode_volume()
    dec_iso = float(dec.median())
    dec_slabs, dec_tris, dec_ok = mt_slabs_equal(torch, dec, dec_iso, 16)
    kernel_mesh = mt.extract_isosurface(vol, iso, slab=32)
    pt, pi, z = [], [], 0
    while z < vol.shape[0] - 1:
        t, i = mt_plain(vol[z:z + 33], iso, z)
        pt.append(t)
        pi.append(i)
        z += 32
    v, f = mt.weld_triangles(torch.cat(pt), torch.cat(pi))
    faces_ok = same_mesh(kernel_mesh, (v.cpu().numpy(),
                                              f.cpu().numpy()))
    g = vol[:33].contiguous()
    ms = device_ms(torch, lambda: mt.extract_slab(g, iso, 0),
                   ("mt_count", "mt_emit"))
    # the two kernels apart, and the zeroing of mt_count's workspace (a
    # PyTorch fill) before them
    split = {name: device_ms(torch, lambda: mt.extract_slab(g, iso, 0),
                             pats)
             for name, pats in (("mt_count", ("mt_count",)),
                                ("mt_emit", ("mt_emit",)),
                                ("zero_workspace", ("FillFunctor",)))}
    call_ms = cuda_ms(torch, lambda: mt.extract_slab(g, iso, 0))
    plain_ms = cuda_ms(torch, lambda: mt_plain(g, iso, 0), iters=3,
                       warmup=1)
    k = int(mt.extract_slab(g, iso, 0)[0].shape[0])
    # bytes the function needs: the slab read once, the live triangles'
    # 84 B written (the second read of the two-pass design is its own
    # cost, as are the counts and their sums); the operations (a few
    # hundred a cell) take far less
    b_ms, b_by = bound_ms(nbytes(g) + 84 * k, 0, H100_FP32_FLOPS)
    rec = {"phase": "isosurface_kernel", "grid": f"vorts {DIMS}",
           "isovalue": iso, "slab_planes": 33, "live_triangles": k,
           "grid_slabs": grid_slabs, "grid_triangles": grid_tris,
           "decoded_slabs": dec_slabs, "decoded_isovalue": dec_iso,
           "decoded_triangles": dec_tris,
           "bit_for_bit": {"grid_slabs": grid_ok, "decoded_slabs": dec_ok,
                           "welded_faces": faces_ok},
           "grid_vertices": int(len(kernel_mesh[0])),
           "max_abs_err": 0.0 if grid_ok and dec_ok else None,
           "tol": "bit for bit", "ms": ms, "device_ms_by_kernel": split,
           "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": b_ms, "bound_by": b_by}
    log(rec)
    if not (grid_ok and dec_ok and faces_ok) or grid_tris == 0 \
            or dec_tris == 0:
        raise AssertionError(f"isosurface kernels miss the plain version: "
                             f"{rec}")
    return rec


def network_extraction(torch, nv, iso, name):
    """extract_isosurface_network on nv at its dims (slabs of 17 planes),
    every launch count set to 0 before and read after, the host clock
    around it; then the same call once under torch.profiler, whose ranges
    (ops/isosurface.py::_extract_loop) split it into its stages (decode,
    kernels, weld, the copy to the host), each by its host time and the
    device time of the kernels it launched; and its peak memory. The mesh
    must equal the kernels' extraction of the same model's decoded
    grid."""
    from torch.profiler import ProfilerActivity, profile

    from instantvnr_torch.ops import isosurface as mt

    dims = nv.dims
    mt.extract_isosurface_network(nv.field, nv.params, dims, iso)  # warm
    for c in counters().values():
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    verts, faces = mt.extract_isosurface_network(nv.field, nv.params, dims,
                                                 iso)
    total_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base_mem
    launches = {n: c.launches for n, c in counters().items() if c.launches}
    starts = list(range(0, dims[2] - 1, 16))
    grid_mesh = mt.extract_isosurface(nv.decode_volume(), iso, slab=16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mt.extract_isosurface_network(nv.field, nv.params, dims, iso)
        torch.cuda.synchronize()
    stage_of = {"isosurface.slab": "decode", "isosurface.extract": "kernels",
                "isosurface.weld": "weld", "isosurface.to_host": "host_copy"}
    stages = {s: {"host_ms": 0.0, "device_ms": 0.0, "ranges": 0}
              for s in stage_of.values()}
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    ranges = []
    for e in events:
        if e.name in stage_of and e.device_type == cpu:
            st = stages[stage_of[e.name]]
            st["host_ms"] += e.cpu_time_total / 1e3
            st["ranges"] += 1
            ranges.append((e.time_range.start, e.time_range.end,
                           stage_of[e.name]))
    # a device event shares its correlation id with the runtime call that
    # launched it (cudaLaunchKernel, cudaMemcpyAsync, ...): the kernels of
    # the ctypes wrappers too, which no aten op encloses
    launched_at = {e.id: e.time_range.start for e in events
                   if e.device_type == cpu and e.name.startswith("cu")}
    device_total = 0.0
    for e in events:
        # (the ranges come back on the device's timeline too: not kernels)
        if e.device_type != cuda or e.name in stage_of:
            continue
        device_total += kernel_us(e) / 1e3
        t = launched_at.get(e.id)
        for a, b, stage in ranges:
            if t is not None and a <= t <= b:
                stages[stage]["device_ms"] += kernel_us(e) / 1e3
                break
    rec = {"phase": f"isosurface_network[{name}]", "dims": dims,
           "isovalue": iso, "slab": 16, "ms": total_ms,
           "stages_profiled": stages,
           "profiled_device_ms_total": device_total,
           "unstaged_device_ms": device_total - sum(
               st["device_ms"] for st in stages.values()),
           "triangles": int(len(faces)), "vertices": int(len(verts)),
           "peak_memory_bytes": int(peak), "launches": launches,
           "equals_grid_extraction": same_mesh((verts, faces),
                                               grid_mesh),
           "finite": bool(np.isfinite(verts).all())}
    log(rec)
    want = {"mt_count/mt_emit": 2 * len(starts),
            "fused_mlp": len(starts), "hash_encode_forward": len(starts)}
    staged = sum(st["device_ms"] for st in stages.values())
    if (launches != want or not rec["equals_grid_extraction"]
            or not rec["finite"] or len(faces) == 0
            or not 0.0 < staged <= device_total * 1.001):
        raise AssertionError(f"{rec['phase']}: launches expected {want}, "
                             f"the stages' device time in (0, the trace's]")
    return rec


def phase_isosurface_network(torch, nv, trained):
    """The main path of the extraction at 128³ on the 2^19 model: the
    serving model's seeded random weights at its decode's median (a noisy
    field: a dense surface), and the model trained on vorts
    (train_2e19[seed 0]) at TRAINED_ISO (the tubes' surface); then the
    grid path, extract_isosurface of vorts 128³ at its median in slabs of
    32, with its launches."""
    from instantvnr_torch.ops import isosurface as mt

    serving = network_extraction(torch, nv,
                                 float(nv.decode_volume().median()),
                                 "seeded")
    network_extraction(torch, trained, TRAINED_ISO, "trained")
    for c in counters().values():
        c.reset()
    vol = nv.simple.volume.data
    mt.extract_isosurface(vol, float(vol.median()), slab=32)
    serving["grid_path_launches"] = mt.counter.launches
    log({"phase": "isosurface_grid_path",
         "launches": mt.counter.launches})
    if mt.counter.launches != 8:
        raise AssertionError(f"the grid path launched "
                             f"{mt.counter.launches}, not 8")
    return serving


def vorts_u16_volumes(dims):
    """Two timesteps of a 256³ scene as uint16 in data units: vorts and
    vorts mirrored in z (numpy, from the seed)."""
    from instantvnr_torch.data.volume import synthetic_array

    a, _ = synthetic_array(dims, "vorts", SEED)
    u16 = np.round(a * 65535.0).astype(np.uint16)
    return a, [u16, np.ascontiguousarray(u16[::-1])]


def write_scene(tmp, vols, offset=4096):
    """A diva scene of big-endian UNSIGNED_SHORT raw files with a header
    of `offset` bytes, one file a timestep."""
    names = []
    for t, v in enumerate(vols):
        name = f"scene_t{t}.raw"
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(bytes(range(256)) * (offset // 256))
            f.write(v.astype(">u2").tobytes())
        names.append(name)
    dz, dy, dx = vols[0].shape
    path = os.path.join(tmp, "scene.json")
    with open(path, "w") as f:
        f.write("// a time series of two raw files\n" + json.dumps(
            {"volume": {"filename": names, "dims": {"x": dx, "y": dy,
                                                    "z": dz},
                        "type": "UNSIGNED_SHORT", "bigendian": True,
                        "offset": offset}}))
    return path


def phase_scene_load(torch, path, vols):
    """A diva scene of two 256³ big-endian UNSIGNED_SHORT timesteps with
    an offset: SimpleVolume(path) (load ms; the data equal to numpy's
    normalization), 100 training steps of the 2^19 model, a DECODED_SLAB
    frame; then the renderer switches to timestep 1 (a new macrocell),
    100 more steps, a frame, and an ISOSURFACE_REFERENCE frame of each
    timestep (the ground truth changes)."""
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.data.volume import normalize_array

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sv = api.SimpleVolume(path, device="cuda")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    ref0 = normalize_array(vols[0])[0]
    exact0 = bool(np.array_equal(sv.volume.data.cpu().numpy(), ref0))
    nv = api.NeuralVolume(ModelConfig(), sv, seed=SEED, device="cuda")
    nv.train(100)
    r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode.DECODED_SLAB)
    r_iso = api.VNRenderer(sv, SIZE, SIZE, api.RenderMode.ISOSURFACE_REFERENCE)
    frames = {}
    for tag in ("t0", "t1"):
        if tag == "t1":
            t1 = time.perf_counter()
            r.set_current_timestep(1)
            r_iso.set_mode(r_iso.mode)
            torch.cuda.synchronize()
            switch_ms = (time.perf_counter() - t1) * 1e3
            nv.train(100)
            r.set_mode(r.mode)  # the new weights
        for name, rr in (("decoded", r), ("isosurface", r_iso)):
            rr.set_camera(orbit(1, N_FRAMES, max(vols[0].shape)))
            rr.render()
            frames[f"{name}_{tag}"] = rr.mapframe()
    exact1 = bool(np.array_equal(sv.volume.data.cpu().numpy(),
                                 normalize_array(vols[1])[0]))
    iso_change = float(np.abs(frames["isosurface_t1"]
                              - frames["isosurface_t0"]).max())
    rec = {"phase": "scene_load", "scene": "diva, 256^3 UNSIGNED_SHORT "
           "big-endian, offset 4096, 2 timesteps",
           "file_bytes": int(vols[0].nbytes + 4096), "load_ms": load_ms,
           "timestep_switch_ms": switch_ms, "data_exact": [exact0, exact1],
           "timesteps": sv.num_timesteps, "psnr_t1": nv.get_psnr(),
           "alpha_max": {k: float(f[..., 3].max()) for k, f in
                         frames.items()},
           "isosurface_frame_change": iso_change}
    log(rec)
    if (not (exact0 and exact1) or sv.current_timestep != 1
            or not all(np.isfinite(f).all() for f in frames.values())
            or min(rec["alpha_max"].values()) <= 0.05 or iso_change == 0.0):
        raise AssertionError(f"scene_load: {rec}")
    return rec


def step_ms_host(torch, fn, n):
    """ms per step of fn(n) on the host clock, synchronized at both ends
    (the steps are host-bound: the clock sees what a user waits for), and
    the launches of the run, every count set to 0 just before it."""
    for c in counters().values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(n)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    return ms, {k: c.launches for k, c in counters().items() if c.launches}


def check_train_launches(rec, launches, n):
    """A training run of n steps launched each training kernel n times and
    nothing else."""
    if launches != {k: n for k in TRAIN_KERNELS}:
        raise AssertionError(f"{rec['phase']}: launches {launches}, not "
                             f"{n} of each of {TRAIN_KERNELS}")


def idle_share(torch, fn, n, step_ms):
    """The device's busy time a step over n profiled steps, and its idle
    share of the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(n)
        torch.cuda.synchronize()
    busy = sum(kernel_us(e) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    return busy, max(0.0, 1.0 - busy / step_ms)


def phase_analytic_training(torch):
    """train_steps_source on the analytic 'tubes' field: the 2^19 model,
    B = 2^16, 200 steps after 10 of warm-up; ms a step (host clock around
    synchronized runs, and CUDA events), then the PSNR against
    lattice_grid at 128³."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.data.procedural import AnalyticSampler
    from instantvnr_torch.models.metrics import psnr_vs
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.models.trainer import (create_train_state,
                                                 train_steps_source)

    field = NeuralField.from_config(ModelConfig())
    sampler = AnalyticSampler.create("tubes", SEED)
    box = [create_train_state(field, SEED, "cuda")]

    def run(n):
        box[0] = train_steps_source(field, sampler, box[0], n, TRAIN_BATCH)

    lattice = sampler.lattice_grid(DIMS, device="cuda")
    psnr0 = float(psnr_vs(field, box[0].params, lattice))
    run(10)
    ms, launches = step_ms_host(torch, run, 200)
    events_ms = cuda_ms(torch, lambda: run(1), iters=20, warmup=0)
    busy, idle = idle_share(torch, run, 20, ms)
    psnr = float(psnr_vs(field, box[0].params, lattice))
    rec = {"phase": "analytic_training", "field": "tubes",
           "model": "ModelConfig() 2^19", "batch": TRAIN_BATCH,
           "steps": 210 + 20 + 20, "ms_per_step": ms,
           "ms_per_step_events": events_ms, "device_busy_ms_per_step": busy,
           "device_idle_share": idle, "psnr_vs_lattice_128": psnr,
           "untrained_psnr_vs_lattice_128": psnr0,
           "loss": float(box[0].loss), "launches": launches}
    log(rec)
    check_train_launches(rec, launches, 200)
    if not (math.isfinite(psnr) and psnr > DATA_PSNR_MIN
            and psnr >= psnr0 + DATA_PSNR_GAIN):
        raise AssertionError(f"analytic training did not learn: {rec}")
    return rec


def write_ooc_file(tmp, vorts256):
    """The 512³ UNSIGNED_BYTE file: vorts 256³ with each voxel repeated
    2× along each axis (134 MB)."""
    u8 = np.round(vorts256 / vorts256.max() * 255.0).astype(np.uint8)
    path = os.path.join(tmp, "vorts512_u8.raw")
    with open(path, "wb") as f:
        for z in range(u8.shape[0]):
            plane = np.repeat(np.repeat(u8[z], 2, axis=0), 2, axis=1)
            f.write(plane.tobytes())
            f.write(plane.tobytes())
    return path, u8


class RecordingSampler:
    """An out-of-core sampler whose batches' coords are kept on the host as
    they are drawn."""

    def __init__(self, inner):
        self.inner, self.coords = inner, []

    def sample_into(self, coords, values):
        self.inner.sample_into(coords, values)
        self.coords.append(coords.copy())

    def sample(self, batch):
        coords, values = self.inner.sample(batch)
        self.coords.append(coords.copy())
        return coords, values


def phase_out_of_core_training(torch, tmp, vorts256):
    """train_out_of_core on the 512³ uint8 file through the native loader
    (demanded: use_native=True), 4 reader threads, 16 resident blocks of
    32 × 32 rows (256 blocks in the file: they rotate during the run); the
    2^19 model, B = 2^16, 200 steps. Reports ms a step, the loader's
    Msamples/s, the blocks loaded, the device's idle share over 20
    profiled steps, the in-core step on the same volume for comparison,
    and the PSNRs against the volume of the model untrained, trained out
    of core and trained in core as many steps (the out-of-core run sees
    the blocks it draws, not the whole volume); one of the loader's
    batches against the in-memory volume's trilinear sample at its
    coords; and a second out-of-core run of 230 steps with its batches
    recorded beside an in-core twin fed the same coords, targets sampled
    from the volume in memory: their PSNRs must agree within
    OOC_PSNR_GAP."""
    from instantvnr_torch.config import ModelConfig, VolumeDesc
    from instantvnr_torch.data.outofcore import OutOfCoreSampler
    from instantvnr_torch.models.metrics import psnr_vs
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.models.trainer import (create_train_state,
                                                 train_out_of_core,
                                                 train_step_hostbatch,
                                                 train_steps)
    from instantvnr_torch.ops.trilinear import sample_volume_tex

    path, u8 = write_ooc_file(tmp, vorts256)
    desc = VolumeDesc(filename=path, dims=tuple(2 * s for s in u8.shape),
                      dtype="UNSIGNED_BYTE")
    t0 = time.perf_counter()
    sampler = OutOfCoreSampler(desc, block_y=32, block_z=32, n_resident=16,
                               n_threads=4, use_native=True, seed=SEED)
    open_ms = (time.perf_counter() - t0) * 1e3
    msps = sampler.measure_throughput(TRAIN_BATCH, 2.0) / 1e6
    field = NeuralField.from_config(ModelConfig())
    box = [create_train_state(field, SEED, "cuda")]
    vol = torch.as_tensor(np.repeat(np.repeat(np.repeat(
        u8, 2, 0), 2, 1), 2, 2), device="cuda").to(torch.float32)
    lo, hi = sampler.value_range
    vol = (vol - lo) / (hi - lo)
    psnr0 = float(psnr_vs(field, box[0].params, vol))

    def run(n):
        box[0] = train_out_of_core(field, sampler, box[0], n, TRAIN_BATCH)

    run(10)
    loads0 = sampler.loads()
    ms, launches = step_ms_host(torch, run, 200)
    loads = sampler.loads() - loads0
    busy, idle = idle_share(torch, run, 20, ms)
    psnr = float(psnr_vs(field, box[0].params, vol))
    coords, values = sampler.sample(TRAIN_BATCH)
    coords = torch.as_tensor(coords, device="cuda")
    values = torch.as_tensor(values[:, 0], device="cuda")
    batch_err = float((sample_volume_tex(vol, coords) - values).abs().max())
    coords_in_unit = bool(((coords >= 0) & (coords <= 1)).all())
    incore = [create_train_state(field, SEED, "cuda")]

    def run_incore(n):
        incore[0] = train_steps(field, vol, incore[0], n, TRAIN_BATCH)

    run_incore(10)
    incore_ms, in_launches = step_ms_host(torch, run_incore, 200)
    in_busy, in_idle = idle_share(torch, run_incore, 20, incore_ms)
    incore_psnr = float(psnr_vs(field, incore[0].params, vol))
    recording = RecordingSampler(sampler)
    twin_ooc = train_out_of_core(field, recording,
                                 create_train_state(field, SEED, "cuda"),
                                 230, TRAIN_BATCH)
    twin_in = create_train_state(field, SEED, "cuda")
    for c in recording.coords:
        c = torch.as_tensor(c, device="cuda")
        twin_in = train_step_hostbatch(field, twin_in, c,
                                       sample_volume_tex(vol, c)[:, None])
    twins = {"steps": len(recording.coords),
             "out_of_core_psnr": float(psnr_vs(field, twin_ooc.params, vol)),
             "incore_same_coords_psnr": float(psnr_vs(field, twin_in.params,
                                                      vol))}
    rec = {"phase": "out_of_core_training", "file": "512^3 UNSIGNED_BYTE "
           "(vorts 256^3, each voxel 2x along each axis)",
           "file_bytes": desc.n_bytes, "native": sampler.is_native,
           "value_range": sampler.value_range, "n_resident": 16,
           "blocks_in_file": (desc.dims[1] // 32) * (desc.dims[2] // 32),
           "threads": 4, "open_ms": open_ms,
           "loader_msamples_per_s": msps, "blocks_loaded_in_200_steps": loads,
           "ms_per_step": ms, "device_busy_ms_per_step": busy,
           "device_idle_share": idle, "psnr_vs_volume": psnr,
           "untrained_psnr_vs_volume": psnr0,
           "incore_psnr_vs_volume": incore_psnr,
           "batch_vs_volume_max_abs": batch_err, "batch_tol": OOC_BATCH_ATOL,
           "twins": twins,
           "incore_ms_per_step": incore_ms,
           "incore_device_busy_ms_per_step": in_busy,
           "incore_device_idle_share": in_idle,
           "out_of_core_over_incore": ms / incore_ms, "launches": launches}
    sampler.close()
    del vol
    log(rec)
    check_train_launches(rec, launches, 200)
    check_train_launches(rec, in_launches, 200)
    rotating = rec["blocks_in_file"] > 16
    if (not rec["native"] or (rotating and loads <= 16)
            or not math.isfinite(psnr) or not psnr > DATA_PSNR_MIN
            or psnr < psnr0 + DATA_PSNR_GAIN
            or not coords_in_unit or not batch_err <= OOC_BATCH_ATOL
            or twins["steps"] != 230
            or not abs(twins["out_of_core_psnr"]
                       - twins["incore_same_coords_psnr"]) <= OOC_PSNR_GAP):
        raise AssertionError(f"out_of_core_training: {rec}")
    return rec


def phase_cli_data(torch, tmp, scene):
    """The data CLI on the card, in-process, at full width (the default
    ModelConfig()): vnr_cmd_train --scene in each sampling mode (gpu and
    out-of-core on timestep 1, analytic on tubes), vnr_cmd_isosurface of
    the grid and of a checkpoint, generate_shadow_map and vnr_cmd_render
    --scene --timestep 1."""
    from instantvnr_torch.apps import generate_shadow_map, vnr_cmd_isosurface
    from instantvnr_torch.apps import vnr_cmd_render, vnr_cmd_train

    out = {}
    for mode in ("gpu", "out-of-core", "analytic"):
        src = (["--synthetic", "vorts", "--dims", "128"] if mode == "analytic"
               else ["--scene", scene, "--timestep", "1"])
        npz = os.path.join(tmp, f"cli_{mode}.npz")
        t0 = time.perf_counter()
        nv = vnr_cmd_train.main(src + ["--sampling-mode", mode,
                                       "--max-num-steps", "50", "--save",
                                       npz, "--report-psnr"])
        out[f"train_{mode}_s"] = time.perf_counter() - t0
        out[f"train_{mode}_loss"] = nv.get_training_loss()
    obj = os.path.join(tmp, "cli_grid.obj")
    v, f = vnr_cmd_isosurface.main(["--scene", scene, "--isovalue", "0.3",
                                    "--output", obj])
    out["iso_grid"] = [int(len(v)), int(len(f))]
    v2, f2 = vnr_cmd_isosurface.main(["--load", os.path.join(
        tmp, "cli_gpu.npz"), "--isovalue", "0.3", "--output",
        os.path.join(tmp, "cli_net.obj")])
    out["iso_network"] = [int(len(v2)), int(len(f2))]
    s = generate_shadow_map.main(["--scene", scene, "--output",
                                  os.path.join(tmp, "shadow.raw")])
    out["shadow_mean"] = float(s.mean())
    frame = vnr_cmd_render.main(["--scene", scene, "--timestep", "1",
                                 "--mode", "reference", "--size", "256",
                                 "--num-frames", "2", "--warmup", "1",
                                 "--output", os.path.join(tmp, "scene.png")])
    out["render_alpha_max"] = float(frame[..., 3].max())
    rec = {"phase": "cli_data", **out}
    log(rec)
    if (not all(math.isfinite(out[f"train_{m}_loss"])
                for m in ("gpu", "out-of-core", "analytic"))
            or len(f) == 0 or not np.isfinite(v).all()
            or not np.isfinite(s).all() or out["render_alpha_max"] <= 0.05
            or not np.isfinite(frame).all()):
        raise AssertionError(f"cli_data: {rec}")
    return rec


# -- the twelfth slice: the edge pixel, the paired hash, the differentiable
#    march, fV-SRN and VDB files -----------------------------------------------

EDGE_SIZE = (10, 7)
EDGE_PIXEL = (5, 6)  # (row, column): the ray that grazes the volume's top
EDGE_ATOL = 1e-5  # the slab path on one grid, the card against the CPU
PAIRED_BATCHES = (1 << 16, 1 << 19)
PAIRED_STEPS = 100
FIXED_SIZE = 128
FIXED_CMP_SIZE = 64  # the card against the CPU
FIXED_ITERS, FIXED_SUPERSTEPS = 4, 24
# each gradient's relative L2 error, the card against the CPU: the fused
# MLP's bf16 forward parts from its plain version on 0.3% of rows (PERF.md
# §6, PR 4) and a ray's gradient flows through every sample after it
# (measured 0.2-2.6% on the 2^19 model, PR 12); the volume's: sums in
# another order
FIXED_GRAD_TOL = {"network": 5e-2, "volume": 1e-4}
# the hash encoding's coordinate backward against its plain version and a
# float64 oracle, as a share of the largest entry: float32 sums of 64
# corner terms a sample in another order (read 2.6e-7 on an H100, PERF.md
# §6); its f32 operations a lane: the cell 12, per corner the
# address 5, the dot 2F, the weights and their derivatives 15, then the
# scale 3
HASH_COORDS_RTOL = 1e-5
COORDS_CELL_OPS, COORDS_CORNER_OPS = 15, 20
# the emission's backward against its plain version (autograd of the plain
# emission on the same card tensors), as a share of each leaf's largest
# entry: float32 sums of the same derivatives in another order (forward
# mode against autograd's reverse); its f32 operations (csrc/
# raymarch_emit.cu): a probe the forward's EMIT_PROBE_OPS and about 60 on
# its derivatives (the exits' two quotients an axis, the amin's and the
# clamps' selections, the step's difference and quotient over ten
# entries), a slot about 70 (t + ss and the min over ten entries, two
# cotangent products into the sum), a ray 60 (the final state's three)
EMIT_BWD_RTOL = 1e-5
EMIT_BWD_PROBE_OPS, EMIT_BWD_SLOT_OPS, EMIT_BWD_RAY_OPS = 140, 70, 60
FVSRN_STEPS = 100
FVSRN_FRAMES = 6
FVSRN_CMP_DIMS = (32, 32, 32)
VDB_STEPS = 100


def phase_edge_pixel(torch):
    """The 10 × 7 DECODED_SLAB frame whose pixel (6, 5) sees a ray graze
    the volume's top face in slab 8 (vorts 16³, a two-level model, eye
    (3, 2.5, −38)): on the card and the CPU from the CPU's decoded grid,
    so that the slab path alone is held (EDGE_ATOL); the pixel is 0 on
    both, as exact arithmetic says (render/slabmarch.py::_exact_src)."""
    from instantvnr_torch import api
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig)
    from instantvnr_torch.models.network import params_from_numpy
    from instantvnr_torch.render.camera import Camera

    cfg = ModelConfig(encoding=EncodingConfig(n_levels=2,
                                              n_features_per_level=4,
                                              log2_hashmap_size=10),
                      network=NetworkConfig(n_neurons=16, n_hidden_layers=2))
    cam = Camera(eye=(3.0, 2.5, -38.0), center=(0.0, 0.0, 0.0),
                 up=(0.0, 1.0, 0.0), fovy=45.0)
    # tests/test_torch_facade.py's weights: there the grazing slab is the
    # only one that would cover the pixel, so the pixel is 0 exactly
    rng = np.random.default_rng(4)
    p_np = None
    frames, grid, launches = {}, None, None
    for dev in ("cpu", "cuda"):
        sv = api.SimpleVolume.synthetic((16,) * 3, "vorts", device=dev)
        nv = api.NeuralVolume(cfg, sv, device=dev)
        if p_np is None:
            spec = nv.field.spec
            p_np = {"table": rng.uniform(-0.5, 0.5, (
                spec.n_entries, spec.n_features)).astype(np.float32),
                "mlp": [(rng.standard_normal(sh) * np.sqrt(2.0 / sh[0])
                         ).astype(np.float32)
                        for sh in ((8, 16), (16, 16), (16, 1))]}
        nv.params = params_from_numpy(p_np, dev)
        r = api.VNRenderer(nv, *EDGE_SIZE)
        r.set_camera(cam)
        r.render()
        if grid is None:
            grid = r._impl.decoded.clone()
        else:
            r._impl.decoded = grid.to(dev)
        for c in counters().values():
            c.reset()
        r.render()
        frames[dev] = r.mapframe()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {n: c.launches for n, c in counters().items()
                        if c.launches}
    # slab 8's coverage of intermediate row 6, on the card
    from instantvnr_torch.render import slabmarch as sm

    dims_w = torch.tensor((16.0,) * 3, device="cuda")
    geo = sm.frame_geometry(dims_w, 16, 16, 16, sm.camera_arrays(cam, "cuda"),
                            r._impl.transform, (0, 1, 2), False, 1.0,
                            *EDGE_SIZE)
    z_ks = torch.arange(16, dtype=torch.float32, device="cuda") + 0.5
    covy, _ = sm._coverage_masks(geo, z_ks, 16, 16, torch.ones(
        16, dtype=torch.bool, device="cuda"))
    err = float(np.abs(frames["cuda"] - frames["cpu"]).max())
    rec = {"phase": "edge_pixel_cuda_vs_cpu", "size": list(EDGE_SIZE),
           "covy_slab8_row6": float(covy[8, 6]),
           "covy_slab7_row6": float(covy[7, 6]),
           "max_abs_err": err, "tol": EDGE_ATOL,
           "pixel_cpu": frames["cpu"][EDGE_PIXEL].tolist(),
           "pixel_cuda": frames["cuda"][EDGE_PIXEL].tolist(),
           "alpha_max": float(frames["cpu"][..., 3].max()),
           "launches": launches}
    log(rec)
    if (not err <= EDGE_ATOL or rec["alpha_max"] <= 0.05
            or any(rec["pixel_cpu"]) or any(rec["pixel_cuda"])
            or rec["covy_slab8_row6"] != 0.0 or rec["covy_slab7_row6"] != 1.0
            or launches != {"composite_slabs": 1}):
        raise AssertionError(f"the 10 x 7 frame: {rec}")


def _paired_times(torch, spec, table, coords, g, b, plain_iters):
    """K3 and K4 of one layout against their plain versions, with the
    library yardsticks and the bounds → (forward, backward) records."""
    from instantvnr_torch.ops import hash_encoding as he

    bf16, n = torch.bfloat16, spec.n_entries
    out = he._kernel_forward(table, coords, spec, bf16)
    ref = he.hash_encode_reference(table, coords, spec, bf16)
    grad = he._kernel_backward(n, coords, spec, g, bf16)
    grad_ref = he._plain_backward(n, coords, spec, g, bf16)
    torch.cuda.synchronize()
    fwd_err = float((out.float() - ref.float()).abs().max())
    bwd_err = float((grad - grad_ref).abs().max())
    bwd_ok = bool((grad - grad_ref).abs().le(
        HASH_BWD_ATOL + HASH_BWD_RTOL * grad_ref.abs()).all())
    del ref, grad_ref
    idx, w = he._corners(spec, coords)
    rows = int(torch.unique(idx).numel())
    row_bytes = spec.n_features * 4

    def fwd():
        return he._kernel_forward(table, coords, spec, bf16)

    def bwd():
        return he._kernel_backward(n, coords, spec, g, bf16)

    rec_f = {"max_abs_err": fwd_err, "tol": HASH_FWD_ATOL,
             "ms": device_ms(torch, fwd, ("hash_encode_forward_kernel",)),
             "call_ms": cuda_ms(torch, fwd),
             "plain_ms": cuda_ms(torch, lambda: he.hash_encode_reference(
                 table, coords, spec, bf16), iters=plain_iters, warmup=1)}
    rec_b = {"max_abs_err": bwd_err,
             "tol": f"atol={HASH_BWD_ATOL}, rtol={HASH_BWD_RTOL}",
             "within_tol": bwd_ok, "ms": device_ms(torch, bwd, K4_KERNELS),
             "call_ms": cuda_ms(torch, bwd),
             "plain_ms": cuda_ms(torch, lambda: he._plain_backward(
                 n, coords, spec, g, bf16), iters=plain_iters, warmup=1)}
    bags, bag_w = idx.reshape(-1, 8), w.reshape(-1, 8)
    rec_f["library_ms"], rec_f["library_call_ms"] = library_times(
        torch, lambda: torch.nn.functional.embedding_bag(
            bags, table, per_sample_weights=bag_w, mode="sum"))
    contrib = (g.float().reshape(b, spec.n_levels, 1, spec.n_features)
               * w.reshape(b, spec.n_levels, 8, 1)).reshape(-1,
                                                            spec.n_features)
    flat = idx.reshape(-1)
    rec_b["library_ms"], rec_b["library_call_ms"] = library_times(
        torch, lambda: torch.zeros_like(table).index_add_(0, flat, contrib))
    del contrib, bags, bag_w, idx, w, flat
    lanes = b * spec.n_levels
    fwd_bytes = rows * row_bytes + nbytes(coords, out)
    bwd_bytes = nbytes(coords, g, grad) + rows * row_bytes
    rec_f["bound_ms"], rec_f["bound_by"] = bound_ms(
        fwd_bytes, lanes * (12 + 8 * (5 + 3 * spec.n_features)),
        H100_FP32_FLOPS)
    rec_b["bound_ms"], rec_b["bound_by"] = bound_ms(
        bwd_bytes, lanes * 8 * (5 + 2 * spec.n_features), H100_FP32_FLOPS)
    for rec, mb in ((rec_f, fwd_bytes), (rec_b, bwd_bytes)):
        rec.update(distinct_rows=rows, mbytes=mb / 1e6)
    return rec_f, rec_b


def phase_hash_paired(torch):
    """K3 and K4 in the paired layout (hash_variant="paired") on the 2^19
    reference schema at B = 2^16 and 2^19, in bf16 compute from the f32
    master table as a training step runs them, against their plain
    versions; the tcnn layout's kernels timed in the same call on the same
    table, coords and cotangent → {batch: (paired fwd, paired bwd)}."""
    from instantvnr_torch.config import EncodingConfig
    from instantvnr_torch.ops import hash_encoding as he

    out = {}
    for b in PAIRED_BATCHES:
        specs = {v: he.HashGridSpec.from_config(EncodingConfig(
            hash_variant=v)) for v in ("tcnn", "paired")}
        spec = specs["paired"]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 19 + b)
        table = torch.rand((spec.n_entries, spec.n_features), generator=gen,
                           device="cuda") * 2.0 - 1.0
        coords = torch.rand((b, 3), generator=gen, device="cuda")
        g = torch.randn((b, spec.n_output_dims), generator=gen,
                        device="cuda").to(torch.bfloat16)
        recs = {v: _paired_times(torch, s, table, coords, g, b,
                                 20 if b == 1 << 16 else 3)
                for v, s in specs.items()}
        for k, kind in enumerate(("forward", "backward")):
            rec = {"phase": f"hash_encode_{kind}_paired[2^19,B={b}]",
                   "layout": "2^19", "batch": b, "levels": spec.n_levels,
                   "features": spec.n_features, **recs["paired"][k],
                   "tcnn": recs["tcnn"][k],
                   "paired_over_tcnn": recs["paired"][k]["ms"]
                   / recs["tcnn"][k]["ms"]}
            log(rec)
            bad = (not rec["max_abs_err"] <= HASH_FWD_ATOL if k == 0
                   else not rec["within_tol"])
            if bad:
                raise AssertionError(f"paired hash-grid kernel disagrees: "
                                     f"{rec}")
            out.setdefault(b, []).append(rec)
        del table, coords, g
        torch.cuda.empty_cache()
    return out


def _coords_oracle(torch, spec, table, coords, g, compute):
    """float64 coordinate gradient on the card, from the corners' indices:
    the rows and the cotangent rounded to the compute type, the rest in
    float64 (corner c's bit along axis k is bit (k − a) mod 3, a the
    pairing axis of a paired hashed level, else 0)."""
    from instantvnr_torch.ops import hash_encoding as he

    b, nl, nf = coords.shape[0], spec.n_levels, spec.n_features
    idx = he._corners(spec, coords)[0].reshape(b, nl, 8)
    gl = g.to(compute).double().reshape(b, nl, nf)
    out = torch.zeros((b, 3), dtype=torch.float64, device=coords.device)
    for lvl in range(nl):
        s = float(np.float32(spec.scales[lvl]))
        x = coords * s + 0.5  # float32, as every form computes it
        frac = (x - torch.floor(x)).double()
        dw = (table[idx[:, lvl]].to(compute).double()
              * gl[:, lvl, None, :]).sum(-1)
        a = (lvl % 3 if spec.paired and not spec.level_is_dense[lvl]
             else 0)
        for c in range(8):
            up = [(c >> ((k - a) % 3)) & 1 for k in range(3)]
            w = [frac[:, k] if up[k] else 1.0 - frac[:, k] for k in range(3)]
            for k in range(3):
                o = [w[m] for m in range(3) if m != k]
                out[:, k] += (s if up[k] else -s) * dw[:, c] * o[0] * o[1]
    return out


def frame_positions(torch, sv):
    """The sample positions of one sampling superstep of the
    differentiable march's ray frame (FIXED_SIZE², the 2^19 model with
    its seeded weights, n_iters FIXED_ITERS): the superstep with the most
    samples → float32 [n, 3] on the card. Positions along a ray and on
    neighbouring rays are near each other, which uniform coords are not."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField

    if not _VORTS:
        _VORTS.append(sv.volume.data.cpu().numpy())
    field = NeuralField.from_config(ModelConfig())
    pos = []
    _fixed_steps_frame(torch, "cuda", field, seeded_params(field, SEED + 20),
                       FIXED_SIZE, rays=True, positions=pos)
    return max(pos, key=len).contiguous()


def phase_hash_coords_grad(torch, sv):
    """hash_encode_coords_backward on the main path's model, ModelConfig()
    (8 levels × 8 features, 2^19), in both layouts and both compute types
    from the f32 master table, on two inputs: B = 2^16 uniform coords, and
    one sampling superstep's sample positions of the differentiable
    march's ray frame (`frame_positions`): against its plain version on
    the card and a float64 oracle (HASH_COORDS_RTOL of the largest entry),
    its bits equal over two launches; timed beside the plain version, with
    its bound. No single PyTorch call computes it, so library_ms is null
    → {(layout, compute): record} for the uniform coords, {(layout,
    compute, "frame"): record} for the frame's."""
    from instantvnr_torch.config import EncodingConfig
    from instantvnr_torch.ops import hash_encoding as he

    out = {}
    frame = frame_positions(torch, sv)
    for variant, input_name in (("tcnn", "uniform"), ("paired", "uniform"),
                                ("tcnn", "frame"), ("paired", "frame")):
        spec = he.HashGridSpec.from_config(EncodingConfig(
            hash_variant=variant))
        gen = torch.Generator(device="cuda").manual_seed(
            SEED + 30 + (variant == "paired"))
        table = torch.rand((spec.n_entries, spec.n_features), generator=gen,
                           device="cuda") * 2.0 - 1.0
        coords = torch.rand((TRAIN_BATCH, 3), generator=gen, device="cuda")
        if input_name == "frame":
            coords = frame
        b = coords.shape[0]
        g32 = torch.randn((b, spec.n_output_dims), generator=gen,
                          device="cuda")
        rows = int(torch.unique(he._corners(spec, coords)[0]).numel())
        lanes = b * (1 << (spec.n_levels - 1).bit_length())
        for cname, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            g = g32.to(cdt)

            def kern():
                return he._kernel_coords_backward(table, coords, spec, g, cdt)

            def plain():
                return he._plain_coords_backward(table, coords, spec, g, cdt)

            got, again, ref = kern(), kern(), plain()
            oracle = _coords_oracle(torch, spec, table, coords, g, cdt)
            torch.cuda.synchronize()
            largest = float(oracle.abs().max())
            err = float((got - ref).abs().max())
            oracle_err = float((got.double() - oracle).abs().max())
            n_bytes = rows * spec.n_features * 4 + nbytes(coords, g, got)
            n_ops = lanes * (COORDS_CELL_OPS + 8 * (
                COORDS_CORNER_OPS + 2 * spec.n_features))
            bms, bby = bound_ms(n_bytes, n_ops, H100_FP32_FLOPS)
            suffix = "" if input_name == "uniform" else ",frame"
            rec = {"phase": f"hash_coords_grad[{variant},{cname}{suffix}]",
                   "input": input_name,
                   "layout": "2^19", "batch": b, "levels": spec.n_levels,
                   "features": spec.n_features, "distinct_rows": rows,
                   "largest": largest, "max_abs_err": err,
                   "oracle_max_abs_err": oracle_err,
                   "tol": f"{HASH_COORDS_RTOL} of the largest entry",
                   "same_bits": bool(torch.equal(got, again)),
                   "ms": device_ms(torch, kern,
                                   ("hash_encode_coords_backward_kernel",),
                                   per_call=1),
                   "call_ms": cuda_ms(torch, kern),
                   "plain_ms": cuda_ms(torch, plain, iters=10, warmup=1),
                   "library_ms": None, "bound_ms": bms, "bound_by": bby,
                   "mbytes": n_bytes / 1e6}
            log(rec)
            if (not err <= HASH_COORDS_RTOL * largest
                    or not oracle_err <= HASH_COORDS_RTOL * largest
                    or not rec["same_bits"] or not largest > 0):
                raise AssertionError(f"coordinate kernel disagrees: {rec}")
            out[(variant, cname) + ((input_name,) if suffix else ())] = rec
        del table, coords, g32
        torch.cuda.empty_cache()
    return out


def phase_paired_training(torch, sv):
    """A 2^19 training step (B = 2^16) in the paired layout beside the
    tcnn one, through NeuralVolume.train: PAIRED_STEPS steps on the host
    clock a run, the two layouts in turns (tcnn, paired, paired, tcnn,
    tcnn, paired) after a warm-up of each, every step launching its
    layout's K3 and K4, K1's training form and K2 once; then the paired
    model's decode (K3 on its bf16 table, K1) and one 512² DECODED_SLAB
    frame. The paired runs' launches, counted from 0 before each run,
    and its decode's and frame's are its main path's."""
    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig

    nvs, ms, total = {}, {"tcnn": [], "paired": []}, {}
    for variant in ms:
        cfg = ModelConfig(encoding=dataclasses.replace(
            ModelConfig().encoding, hash_variant=variant))
        nvs[variant] = api.NeuralVolume(cfg, sv, device="cuda", seed=SEED)
        nvs[variant].train(20, fast_mode=True)
    for variant in ("tcnn", "paired", "paired", "tcnn", "tcnn", "paired"):
        nv = nvs[variant]
        step_ms, launches = step_ms_host(torch, lambda n: nv.train(
            n, fast_mode=True), PAIRED_STEPS)
        k3, k4 = (("hash_encode_forward", "hash_encode_backward")
                  if variant == "tcnn" else ("hash_encode_forward_paired",
                                             "hash_encode_backward_paired"))
        want = {k3: PAIRED_STEPS, k4: PAIRED_STEPS,
                "fused_mlp_train_forward": PAIRED_STEPS,
                "fused_mlp_backward": PAIRED_STEPS,
                "adam_step": PAIRED_STEPS}
        if launches != want:
            raise AssertionError(f"{variant} training launches {launches} "
                                 f"!= {want}")
        ms[variant].append(step_ms)
        if variant == "paired":
            add_launches(total, launches)
    # where a step's time goes in each layout: the device's busy time over
    # 10 profiled steps, and the PyTorch operations one step dispatches
    profiled = {}
    for variant, v_nv in nvs.items():
        busy, idle = idle_share(torch, lambda n, v_nv=v_nv: v_nv.train(
            n, fast_mode=True), 10, float(np.median(ms[variant])))
        ops = dispatched_ops(torch, lambda v_nv=v_nv: v_nv.train(
            1, fast_mode=True))
        profiled[variant] = {"device_busy_ms": busy, "idle_share": idle,
                             "ops_a_step": ops}
    nv = nvs["paired"]
    _, dec = launches_during(lambda: nv.ensure_decoded(SIZE, SIZE))
    r = api.VNRenderer(nv, SIZE, SIZE)
    r.set_camera(orbit(0, N_FRAMES, max(DIMS)))
    _, frame_l = launches_during(r.render)
    frame = r.mapframe()
    add_launches(total, dec)
    add_launches(total, frame_l)
    rec = {"phase": "paired_training", "steps_a_run": PAIRED_STEPS,
           "order": "tcnn, paired, paired, tcnn, tcnn, paired",
           "ms_per_step": ms,
           "median_ms_per_step": {v: float(np.median(m))
                                  for v, m in ms.items()},
           "profiled": profiled,
           "decode_launches": {k: v for k, v in dec.items() if v},
           "frame_launches": {k: v for k, v in frame_l.items() if v},
           "alpha_max": float(frame[..., 3].max()),
           "psnr_after_steps": {v: n.get_psnr() for v, n in nvs.items()},
           "steps": 20 + 3 * PAIRED_STEPS + 11,
           "launches": {k: total.get(k, 0) for k in counters()}}
    log(rec)
    if (dec.get("hash_encode_forward_paired") != nv.n_blobs
            or dec.get("fused_mlp") != nv.n_blobs
            or dec.get("hash_encode_forward")
            or frame_l.get("composite_slabs") != 1
            or not np.isfinite(frame).all() or not rec["alpha_max"] > 0.05
            or not rec["psnr_after_steps"]["paired"] > DATA_PSNR_MIN):
        raise AssertionError(f"the paired model's path: {rec}")
    return rec


def _fixed_steps_frame(torch, dev, field, params_np, size, volume=None,
                       rays=False, backward=None, positions=None):
    """One fixed_steps frame of the 2^19 model (or, with `volume`, of the
    sampled volume) on `dev`, camera 0 of the orbit over vorts 128³, and
    its loss sum(frame²) backward → (leaves with their grads, forward ms,
    backward ms, the samples' count: the supersteps that sampled, the
    frame's largest alpha, the emission launches up to the last superstep
    that sampled). With `rays` the params stay frozen and the leaves are
    the camera rays' origins and directions (their t range fixed), made on
    the CPU and marched as `_render_frame` marches them. `backward`: a
    function of the loss that runs its backward (else loss.backward());
    `positions`: a list that receives each sample call's positions."""
    from functools import partial

    from instantvnr_torch.accel import macrocell as mcmod
    from instantvnr_torch.config import TransferFunctionConfig
    from instantvnr_torch.models.network import params_from_numpy
    from instantvnr_torch.render import raymarch as rm
    from instantvnr_torch.render.raymarch import RaymarchSettings, raymarch
    from instantvnr_torch.render.renderer import (_frame_rays,
                                                  _render_frame,
                                                  make_neural_sample_fn,
                                                  reference_sample_fn)
    from instantvnr_torch.render.slabmarch import camera_arrays
    from instantvnr_torch.render.transform import default_transform
    from instantvnr_torch.utils.tfn import bake_transfer_function

    tf = bake_transfer_function(TransferFunctionConfig(), device=dev)
    vol = (volume if volume is not None else
           torch.from_numpy(_VORTS[0])).to(dev)
    mc = mcmod.build(vol, DIMS, tf)
    settings = RaymarchSettings(n_iters=FIXED_ITERS,
                                max_supersteps=FIXED_SUPERSTEPS,
                                fixed_steps=True)
    cam = camera_arrays(orbit(0, N_FRAMES, max(DIMS)), dev)
    jitter = torch.rand(size * size, generator=torch.Generator().manual_seed(
        SEED + 21)).to(dev)
    calls = [0]
    if volume is None:
        params = params_from_numpy(params_np, dev)
        leaves = [params["table"], *params["mlp"]]
        fn = make_neural_sample_fn(field)
    else:
        leaves = [vol.clone()]
        params, fn = leaves[0], reference_sample_fn
    if rays:
        # made on the CPU for both devices: the frame is only piecewise
        # smooth in its rays (a step's quantization, a skipped cell), so
        # rays made 1 ulp apart on the card take other steps on a few
        # pixels and give those another gradient (PERF.md §6)
        cpu = torch.device("cpu")
        xform = default_transform(DIMS, cpu)
        org, dirn, t0, t1, light, lo, hi = (x.to(dev) for x in _frame_rays(
            size, size, camera_arrays(orbit(0, N_FRAMES, max(DIMS)), cpu),
            torch.tensor(DIMS, dtype=torch.float32),
            torch.tensor(settings.light_dir), xform))
        xform = default_transform(DIMS, dev)
        leaves = [org.detach().clone(), dirn.detach().clone()]
    for t in leaves:
        t.requires_grad_(True)

    emits0, reach = rm.emit_counter.launches, [0]

    def counted(ctx, p):
        calls[0] += 1
        reach[0] = rm.emit_counter.launches - emits0
        if positions is not None:
            positions.append(p.detach().clone())
        return fn(ctx, p)

    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    sync()
    t0_ = time.perf_counter()
    if rays:
        frame = raymarch(partial(counted, params), *leaves, t0, t1, mc, tf,
                         jitter, settings, light_dir=light,
                         scale=xform.scale, clip_lower=lo, clip_upper=hi)
    else:
        _, frame = _render_frame(counted, size, size, settings, params, cam,
                                 mc, tf, jitter, None, 1)
    loss = (frame ** 2).sum()
    sync()
    t1_ = time.perf_counter()
    (backward or (lambda x: x.backward()))(loss)
    sync()
    t2_ = time.perf_counter()
    return (leaves, (t1_ - t0_) * 1e3, (t2_ - t1_) * 1e3, calls[0],
            float(frame[:, 3].detach().max()), reach[0])


_VORTS = []  # vorts 128³ as numpy, made once


# kernels of the backward split's named parts (backward_split)
SPLIT_COORDS = ("hash_encode_coords_backward_kernel",)
SPLIT_K2 = ("fused_mlp_backward_kernel", "sum_partials_kernel")


def kernels_by_range(trace, range_name):
    """A Chrome trace of torch.profiler → {(in_range, kernel name): [n,
    device µs]}: each kernel, by whether the host call that launched it
    (matched by correlation id) lies inside a `range_name` annotation of
    the same thread."""
    events = trace["traceEvents"]
    ranges = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") == range_name]
    launch = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        tid, ts = launch.get(e.get("args", {}).get("correlation"),
                             (None, None))
        inside = ts is not None and any(
            t == tid and a <= ts <= b for t, a, b in ranges)
        n_us = out.setdefault((inside, e["name"]), [0, 0.0])
        n_us[0] += 1
        n_us[1] += e["dur"]
    return out


def backward_split(torch, loss, record):
    """loss.backward() under torch.profiler, its device time split into
    the emission's backward (every kernel launched inside
    render/raymarch.py::_Emit.backward, wrapped here in a
    record_function range: one raymarch_emit_backward a call, or in a
    tree without that kernel the plain emission's recompute and its
    autograd), the coordinate pass, K2 and the rest; the host clock of the
    profiled backward beside it → fills `record`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from instantvnr_torch.render import raymarch as rm

    inner = rm._Emit.backward

    def annotated(ctx, *grads):
        with record_function("emit_backward"):
            return inner(ctx, *grads)

    rm._Emit.backward = staticmethod(annotated)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        rm._Emit.backward = staticmethod(inner)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            by = kernels_by_range(json.load(f), "emit_backward")
    parts = {"emission_backward": 0.0, "coordinate_pass": 0.0, "k2": 0.0,
             "rest": 0.0}
    launches = dict.fromkeys(parts, 0)
    for (inside, name), (n, us) in by.items():
        part = ("emission_backward" if inside else
                "coordinate_pass" if any(p in name for p in SPLIT_COORDS)
                else "k2" if any(p in name for p in SPLIT_K2) else "rest")
        parts[part] += us / 1e3
        launches[part] += n
    record.update({"profiled_backward_ms": wall,
                   "device_ms": sum(parts.values()),
                   **{f"{k}_ms": v for k, v in parts.items()},
                   "kernels": launches,
                   "emission_backward_kernels": sorted(
                       {name[:60] for (inside, name) in by if inside})[:4]})


def _timed_fixed_frames(torch, field, p_np, rays):
    """Three FIXED_SIZE frames of `_fixed_steps_frame` on the card, each
    with every count from 0 and the peak memory over what was allocated
    before it → their records."""
    runs = []
    for i in range(3):
        for c in counters().values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, fwd_ms, bwd_ms, sampled, alpha, reach = _fixed_steps_frame(
            torch, "cuda", field, p_np, FIXED_SIZE, rays=rays)
        runs.append({"forward_ms": fwd_ms, "backward_ms": bwd_ms,
                     "sampled_supersteps": sampled, "alpha_max": alpha,
                     "emissions_reaching_the_loss": reach,
                     "peak_memory_over_baseline":
                         torch.cuda.max_memory_allocated() - base,
                     "launches": {n: c.launches
                                  for n, c in counters().items()}})
    return runs


def _grad_errs(torch, field, p_np, **kw):
    """Each leaf's gradient at FIXED_CMP_SIZE on the card against the
    CPU's plain forms: relative L2 and largest-entry errors."""
    grads = []
    for dev in ("cpu", "cuda"):
        leaves, *_ = _fixed_steps_frame(torch, dev, field, p_np,
                                        FIXED_CMP_SIZE, **kw)
        grads.append([t.grad.double().cpu() for t in leaves])
    return [{"l2_rel": float((b - a).norm() / a.norm()),
             "max_rel": float((b - a).abs().max() / a.abs().max())}
            for a, b in zip(*grads)]


def phase_differentiable_march(torch, sv):
    """RaymarchSettings(fixed_steps=True) on the 2^19 model: a 128² frame
    (n_iters 4, 24 supersteps) and its loss's backward on the card, timed
    three times with its peak memory; the launches of one run exact (a
    raymarch_emit a superstep; K3, K1's training form, K2 and K4 once a
    superstep that samples; never the inference K1 or the coordinate
    pass); the gradients at 64² on the card against the CPU's plain forms
    (FIXED_GRAD_TOL, each leaf's relative L2 error; the largest entry's
    error is reported), for the network's params and for the sampled
    volume. Then the same frame differentiated in its camera rays, the
    params frozen: timed three times, its launches exact (K3, K1's
    training form, K2 and hash_encode_coords_backward once a superstep
    that samples, never K4), the rays' gradients (origins, directions) on
    the card against the CPU's. The peak memory is the frame's own: the
    peak over what was allocated before it."""
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField

    _VORTS.append(sv.volume.data.cpu().numpy())
    field = NeuralField.from_config(ModelConfig())
    p_np = seeded_params(field, SEED + 20)
    runs = _timed_fixed_frames(torch, field, p_np, rays=False)
    launches = runs[-1]["launches"]
    k = runs[-1]["sampled_supersteps"]
    want = {n: 0 for n in counters()}
    want.update({"raymarch_emit": FIXED_SUPERSTEPS, "hash_encode_forward": k,
                 "fused_mlp_train_forward": k, "fused_mlp_backward": k,
                 "hash_encode_backward": k})
    cmp = {"network": _grad_errs(torch, field, p_np),
           "volume": _grad_errs(torch, field, p_np,
                                volume=torch.from_numpy(_VORTS[0]))}
    ray_runs = _timed_fixed_frames(torch, field, p_np, rays=True)
    ray_launches = ray_runs[-1]["launches"]
    k_rays = ray_runs[-1]["sampled_supersteps"]
    want_rays = {n: 0 for n in counters()}
    # an emission's backward runs where its outputs reach the loss: each
    # emission up to the last superstep that sampled (a later one's reach
    # only the final marching state, which the frame does not read)
    want_rays.update({"raymarch_emit": FIXED_SUPERSTEPS,
                      "raymarch_emit_backward":
                          ray_runs[-1]["emissions_reaching_the_loss"],
                      "hash_encode_forward": k_rays,
                      "fused_mlp_train_forward": k_rays,
                      "fused_mlp_backward": k_rays,
                      "hash_encode_coords_backward": k_rays})
    ray_cmp = dict(zip(("org", "dirn"),
                       _grad_errs(torch, field, p_np, rays=True)))
    split = {}
    _fixed_steps_frame(torch, "cuda", field, p_np, FIXED_SIZE, rays=True,
                       backward=lambda loss: backward_split(torch, loss,
                                                            split))

    def times(rs):
        return {"forward_ms": [r["forward_ms"] for r in rs],
                "backward_ms": [r["backward_ms"] for r in rs],
                "forward_backward_ms_median": float(np.median(
                    [r["forward_ms"] + r["backward_ms"] for r in rs])),
                "peak_memory_over_baseline": max(
                    r["peak_memory_over_baseline"] for r in rs)}

    rec = {"phase": "differentiable_march",
           "model": "ModelConfig() 2^19", "frame": f"{FIXED_SIZE}^2",
           "n_iters": FIXED_ITERS, "max_supersteps": FIXED_SUPERSTEPS,
           **times(runs),
           "sampled_supersteps": k, "alpha_max": runs[-1]["alpha_max"],
           "launches": launches,
           "grad_rel_err_cuda_vs_cpu": cmp, "tol": FIXED_GRAD_TOL,
           "rays": {**times(ray_runs), "params": "frozen",
                    "sampled_supersteps": k_rays,
                    "alpha_max": ray_runs[-1]["alpha_max"],
                    "launches": ray_launches,
                    "emissions_reaching_the_loss":
                        ray_runs[-1]["emissions_reaching_the_loss"],
                    "grad_rel_err_cuda_vs_cpu": ray_cmp,
                    "tol": FIXED_GRAD_TOL["network"],
                    "backward_split": split},
           "ray_launches": ray_launches}
    log(rec)
    if launches != want or not k > 0 or rec["alpha_max"] <= 0.05:
        raise AssertionError(f"differentiable march launches {launches} != "
                             f"{want}: {rec}")
    if (ray_launches != want_rays or not k_rays > 0
            or not split["emission_backward_ms"] > 0):
        raise AssertionError(f"ray-differentiated march launches "
                             f"{ray_launches} != {want_rays}: {rec}")
    if any(not e["l2_rel"] <= FIXED_GRAD_TOL[n] for n in cmp
           for e in cmp[n]) or any(
               not e["l2_rel"] <= FIXED_GRAD_TOL["network"]
               for e in ray_cmp.values()):
        raise AssertionError(f"fixed_steps gradients, card against CPU: "
                             f"{rec}")
    return rec


def fvsrn_state_dict(torch, c=16, res=(32, 32, 32), m=42, width=64,
                     hidden=4):
    """An fV-SRN torch state dict as fV-SRN training leaves it: a latent
    grid [1, C, Z, Y, X], a Fourier matrix [M, 3] and an nn.Linear stack
    (random, from a seed; the layout models/fvsrn_import.py reads)."""
    g = torch.Generator().manual_seed(SEED + 30)
    rx, ry, rz = res
    sd = {"latent_grid": torch.randn(1, c, rz, ry, rx, generator=g) * 0.3,
          "fourier_matrix": torch.randn(m, 3, generator=g)}
    dims = [c + 2 * m] + [width] * hidden + [1]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        sd[f"layers.{i}.weight"] = torch.randn(b, a, generator=g) \
            * math.sqrt(2.0 / a)
        sd[f"layers.{i}.bias"] = torch.randn(b, generator=g) * 0.05
    return sd


def phase_fvsrn(torch, sv, tmp):
    """fV-SRN (the default FvsrnConfig: a 32³ × 16 latent grid, 14 Fourier
    bands, a 64 × 4 SnakeAlt MLP) through the facade on vorts 128³:
    FVSRN_STEPS training steps at B = 2^16 on the host clock (plain
    PyTorch on the card: no kernel in either package), the 128³ decode and
    512² DECODED_SLAB frames (composite_slabs only); the same params
    decoded and rendered small on the card against the CPU; a native .npz
    round trip; view_model on an imported torch state dict."""
    from instantvnr_torch import api
    from instantvnr_torch.apps import view_model
    from instantvnr_torch.models.fvsrn import FvsrnConfig
    from instantvnr_torch.models.fvsrn_import import load_fvsrn_torch
    from instantvnr_torch.models.network import network_apply

    nv = api.NeuralVolume(FvsrnConfig(), sv, device="cuda", seed=SEED)
    psnr0 = nv.get_psnr()
    nv.train(10, fast_mode=True)
    ms, launches = step_ms_host(torch, lambda n: nv.train(n, fast_mode=True),
                                FVSRN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psnr = nv.get_psnr()  # one 128³ decode
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    r = api.VNRenderer(nv, SIZE, SIZE)
    r.set_camera(orbit(0, N_FRAMES, max(DIMS)))
    r.render()
    for c in counters().values():
        c.reset()
    frame_ms = []
    for i in range(FVSRN_FRAMES):
        t0 = time.perf_counter()
        r.set_camera(orbit(i, N_FRAMES, max(DIMS)))
        r.render()
        frame = r.mapframe()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    frame_launches = {n: c.launches for n, c in counters().items()
                      if c.launches}
    # the same params on the CPU and the card, small
    frames, grids = {}, {}
    for dev in ("cpu", "cuda"):
        small = api.SimpleVolume.synthetic(FVSRN_CMP_DIMS, "vorts",
                                           device=dev)
        nv_s = api.NeuralVolume(FvsrnConfig(), small, device=dev)
        nv_s.params = {"table": nv.params["table"].detach().to(dev),
                       "mlp": [w.detach().to(dev) for w in nv.params["mlp"]]}
        grids[dev] = nv_s.decode_volume().cpu().numpy()
        rs = api.VNRenderer(nv_s, 48, 48)
        rs.set_camera(orbit(1, N_FRAMES, 32))
        rs.render()
        frames[dev] = rs.mapframe()
    grid_err = float(np.abs(grids["cuda"] - grids["cpu"]).max())
    grid_mean = float(np.abs(grids["cuda"] - grids["cpu"]).mean())
    frame_err = float(np.abs(frames["cuda"] - frames["cpu"]).max())
    # native .npz
    path = os.path.join(tmp, "fvsrn.npz")
    nv.save_params(path)
    back = api.NeuralVolume.from_checkpoint(path, simple=sv, device="cuda")
    npz_equal = bool(torch.equal(back.decode_volume(), nv.decode_volume()))
    # an imported state dict through view_model, on the card
    pt = os.path.join(tmp, "fvsrn.pt")
    torch.save(fvsrn_state_dict(torch), pt)
    info = view_model.main([pt, "--synthetic", "vorts", "--dims", "64",
                            "--device", "cuda", "--evaluate"])
    field, params = load_fvsrn_torch(pt, device="cuda")
    pts = torch.rand((1 << 16, 3), generator=torch.Generator().manual_seed(
        SEED + 31))
    imp_err = float((network_apply(params, pts.to("cuda"), field).cpu()
                     - network_apply({k: ([t.cpu() for t in v]
                                          if isinstance(v, list)
                                          else v.cpu())
                                      for k, v in params.items()},
                                     pts, field)).abs().max())
    rec = {"phase": "fvsrn", "config": "FvsrnConfig() 32^3 x 16 latent, "
           "14 bands, 64x4 SnakeAlt", "volume": f"vorts {DIMS}",
           "batch": TRAIN_BATCH, "ms_per_step": ms,
           "train_launches": launches, "psnr_untrained": psnr0,
           "psnr_after_steps": psnr, "steps": FVSRN_STEPS + 10,
           "decode_ms": decode_ms, "frame_ms": frame_ms,
           "ms_per_frame_median": float(np.median(frame_ms[1:])),
           "frame_launches": frame_launches,
           "alpha_max": float(frame[..., 3].max()),
           "cuda_vs_cpu": {"grid_max_abs_err": grid_err,
                           "grid_mean_abs_err": grid_mean,
                           "frame_max_abs_err": frame_err,
                           "tol": f"atol={MLP_ATOL}, mean={MLP_MEAN_TOL}"},
           "npz_roundtrip_equal": npz_equal,
           "view_model": {k: info[k] for k in ("n_params", "psnr", "ssim")},
           "import_cuda_vs_cpu_max_abs_err": imp_err}
    log(rec)
    if (launches != {"adam_step": FVSRN_STEPS}
            or frame_launches != {"composite_slabs": FVSRN_FRAMES}
            or not psnr > psnr0 + DATA_PSNR_GAIN or not npz_equal
            or not grid_err <= MLP_ATOL or not grid_mean <= MLP_MEAN_TOL
            or not frame_err <= MLP_ATOL or not imp_err <= MLP_ATOL
            or not np.isfinite([info["psnr"], info["ssim"]]).all()
            or not rec["alpha_max"] > 0.05):
        raise AssertionError(f"fV-SRN: {rec}")
    return rec


def vdb_fixture():
    """A FloatGrid file built byte by byte from OpenVDB's layout (version
    224, active-value compression, no ZIP), as tests/test_torch_vdb.py
    builds it: three leaves at (8, 0, 0), (8, 0, 8) and (16, 0, 0), the
    last half active, an active tile of 0.5 at (8, 8, 0), background 0 →
    (the file's bytes, its oracle [z, y, x] at index origin (8, 0, 0))."""
    import struct

    rng = np.random.default_rng(SEED + 40)
    d = np.zeros((16, 16, 16), np.float32)
    d[:8, :8, :8] = rng.uniform(0.1, 1.0, (8, 8, 8))
    half = rng.uniform(0.1, 1.0, (8, 8, 8)).astype(np.float32)
    half[rng.random((8, 8, 8)) < 0.5] = 0.0
    half[7, 7, 7] = 0.9
    d[:8, :8, 8:] = half
    d[:8, 8:, :8] = 0.5
    d[8:, :8, :8] = rng.uniform(0.1, 1.0, (8, 8, 8))

    def s(b):
        return struct.pack("<I", len(b)) + b

    def mask(bits):
        return np.packbits(np.asarray(bits, np.uint8),
                           bitorder="little").tobytes()

    def leaf(x0, y0, z0):
        blk = d[z0:z0 + 8, y0:y0 + 8, x0 - 8:x0]
        v = blk.transpose(2, 1, 0).reshape(-1).astype("<f4")
        return v, v > 0

    az, ay, ax = np.nonzero(d > 0)
    meta = [(b"class", b"string", b"fog volume"),
            (b"file_bbox_max", b"vec3i", struct.pack(
                "<3i", 8 + ax.max(), ay.max(), az.max())),
            (b"file_bbox_min", b"vec3i", struct.pack(
                "<3i", 8 + ax.min(), ay.min(), az.min())),
            (b"file_compression", b"string", b"active values"),
            (b"file_voxel_count", b"int64",
             struct.pack("<q", int((d > 0).sum()))),
            (b"is_saved_as_half_float", b"bool", b"\x00"),
            (b"name", b"string", b"density")]
    grid = struct.pack("<I", 2) + struct.pack("<I", len(meta)) + b"".join(
        s(n) + s(t) + struct.pack("<I", len(v)) + v for n, t, v in meta)
    grid += s(b"UniformScaleMap") + b"".join(
        struct.pack("<3d", v, v, v) for v in (1.0, 1.0, 1.0, 1.0, 0.5))
    grid += struct.pack("<ifII", 1, 0.0, 0, 1) + struct.pack("<3i", 0, 0, 0)
    l1 = np.zeros(32 ** 3, bool)
    l1[0] = True
    grid += mask(l1) + mask(np.zeros(32 ** 3, bool)) + b"\x00"
    leaves = {256: (8, 0, 0), 257: (8, 0, 8), 512: (16, 0, 0)}
    l2c = np.zeros(16 ** 3, bool)
    l2c[list(leaves)] = True
    l2v = np.zeros(16 ** 3, bool)
    l2v[272] = True
    grid += mask(l2c) + mask(l2v) + b"\x00" + struct.pack("<f", 0.5)
    grid += b"".join(mask(leaf(*leaves[o])[1]) for o in sorted(leaves))
    bufs = b""
    for o in sorted(leaves):
        v, m = leaf(*leaves[o])
        bufs += mask(m) + b"\x00" + v[m].tobytes()
    head = struct.pack("<qIII", 0x56444220, 224, 11, 0) + b"\x01"
    head += b"0f8fad5b-d9cb-469f-a165-70867728950e"
    head += struct.pack("<Ii", 0, 1) + s(b"density") + s(
        b"Tree_float_5_4_3") + s(b"")
    gpos = len(head) + 24
    raw = head + struct.pack("<3q", gpos, gpos + len(grid),
                             gpos + len(grid) + len(bufs)) + grid + bufs
    return raw, d


def phase_vdb(torch, sv, tmp):
    """VDB files in real OpenVDB's layout: the byte-built fixture read to
    its array; vorts 128³ written with write_vdb (zip + active values, the
    zeros inactive) and read back and densified (timed, exact); a
    SimpleVolume of it on the card, VDB_STEPS training steps of the 2^14
    model and a 512² DECODED_SLAB frame; save_inference_volume to .vdb read
    back to the decode."""
    from instantvnr_torch import api
    from instantvnr_torch.config import EncodingConfig, ModelConfig
    from instantvnr_torch.data import vdb

    raw, oracle = vdb_fixture()
    fixture = os.path.join(tmp, "fixture.vdb")
    with open(fixture, "wb") as f:
        f.write(raw)
    dense, info = vdb.read_vdb(fixture)
    fixture_ok = (np.array_equal(dense, oracle)
                  and info.bbox_min == (8, 0, 0))
    src = sv.volume.data.cpu().numpy()
    path = os.path.join(tmp, "vorts.vdb")
    t0 = time.perf_counter()
    vdb.write_vdb(path, src, compression="zip+mask", active_threshold=0.0)
    write_ms = (time.perf_counter() - t0) * 1e3
    read_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        dense, info = vdb.read_vdb(path)
        read_ms.append((time.perf_counter() - t0) * 1e3)
    # the read covers the active voxels' bounding box
    az, ay, ax = np.nonzero(src > 0.0)
    read_ok = bool(np.array_equal(dense, src[az.min():az.max() + 1,
                                             ay.min():ay.max() + 1,
                                             ax.min():ax.max() + 1]))
    simple = api.SimpleVolume(vdb.vdb_to_volume(path, device="cuda"),
                              device="cuda")
    nv = api.NeuralVolume(ModelConfig(encoding=EncodingConfig(
        log2_hashmap_size=14)), simple, device="cuda", seed=SEED)
    psnr0 = nv.get_psnr()
    ms, launches = step_ms_host(torch, lambda n: nv.train(n), VDB_STEPS)
    psnr = nv.get_psnr()
    r = api.VNRenderer(nv, SIZE, SIZE)
    r.set_camera(orbit(0, N_FRAMES, max(DIMS)))
    _, frame_l = launches_during(r.render)
    frame = r.mapframe()
    out = os.path.join(tmp, "decoded.vdb")
    nv.save_inference_volume(out)
    back, _ = vdb.read_vdb(out)
    decoded = nv.decode_volume().cpu().numpy()
    inference_ok = bool(back.shape == decoded.shape
                        and np.array_equal(back, decoded))
    rec = {"phase": "vdb", "fixture_equal": bool(fixture_ok),
           "volume": f"vorts {DIMS}", "active_bbox_dims": list(dense.shape),
           "active_share": float((src > 0.0).mean()),
           "file_bytes": os.path.getsize(path),
           "write_ms": write_ms, "read_densify_ms": read_ms,
           "read_equal": read_ok, "ms_per_step": ms,
           "train_launches": launches, "psnr_untrained": psnr0,
           "psnr_after_steps": psnr,
           "frame_launches": {k: v for k, v in frame_l.items() if v},
           "alpha_max": float(frame[..., 3].max()),
           "inference_vdb_equal": inference_ok}
    log(rec)
    if (not fixture_ok or not read_ok or not inference_ok
            or not psnr > psnr0 + DATA_PSNR_GAIN
            or frame_l.get("composite_slabs") != 1
            or not rec["alpha_max"] > 0.05):
        raise AssertionError(f"vdb: {rec}")


# -- the thirteenth slice: parallelism on torch.distributed ------------------
#
# The phases run in child processes (instantvnr_torch.parallel.mesh.spawn):
# a world-1 NCCL group, then two gloo ranks sharing cuda:0 (NCCL refuses
# two ranks on one device). This process joins no group. Each phase sets
# every kernel and collective count to 0 just before its run and reads
# them just after.
PAR_DP_STEPS = PAR_TP_STEPS = 20
PAR_EP_STEPS = 50
PAR_W2_DP_STEPS = 3
# the DP step against the single-device step, in turns: rounds of steps
PAR_TIME_ROUNDS, PAR_TIME_STEPS = 5, 10
# a step's launches on every path that trains: K3, K1's training form, K2,
# K4 and Adam once each; a gradient's without Adam
STEP_LAUNCHES = {k: 1 for k in TRAIN_KERNELS}
GRAD_LAUNCHES = {k: 1 for k in GRAD_KERNELS}
# the TP gradient against the single-device gradient of the same function
# (the split-grad backward's float32 products on the whole table, the
# torch.matmul MLP): the table at K4's tolerance; W1 and the tail within
# TP_MLP_RTOL of their largest entry (a bf16 activation on a rounding
# boundary may round the other way when W1's product is summed in two
# parts); every norm within TP_NORM_TOL of the reference's (the JAX
# package's TP step gives 2.0 on the table and W1)
TP_MLP_RTOL, TP_NORM_TOL = 1e-2, 1e-2
# DP on two halves against the whole batch: each leaf within DP_GRAD_REL of
# its own largest entry (a step's gradients are far below K4's atol, which
# a zero, doubled or half gradient would meet) and its norm within
# TP_NORM_TOL of the whole batch's; the loss within DP_GRAD_REL of its own
DP_GRAD_REL = 1e-5
# EP: JAX's bars (tests/test_parallel.py:266-293): PSNR of the stitched
# decode, and the two planes at the seam against the rest
EP_PSNR_MIN, EP_SEAM_MAX = 22.0, 4.0
# the slab-sharded frame against the single-device frame: JAX's bar (a
# chunk's early termination starts afresh); the ray-sharded frame marches
# each ray as the single-device frame does
SLAB_SHARD_ATOL = 1e-3
RAY_SHARD_ATOL = 1e-5


def _par_reset():
    from instantvnr_torch.parallel.mesh import collective_counters

    for c in (*counters().values(), *collective_counters().values()):
        c.reset()


def _par_counts(torch):
    """The launches and collectives since _par_reset, the nonzero ones."""
    from instantvnr_torch.parallel.mesh import collective_counters

    torch.cuda.synchronize()
    return {n: c.launches for n, c in (*counters().items(),
                                       *collective_counters().items())
            if c.launches}


def _leaves(torch, tree):
    return torch.utils._pytree.tree_leaves(tree)


def _par_steps(torch, rec, step, state, volume, n, want):
    """n calls of step(state, volume), each with its counts from 0 and held
    to `want`; → (state, the run's kernel launches, ms a step)."""
    total = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        _par_reset()
        state = step(state, volume)
        got = _par_counts(torch)
        if got != want:
            raise AssertionError(f"{rec['phase']}: a step launched {got}, "
                                 f"not {want}")
        add_launches(total, got)
    ms = (time.perf_counter() - t0) * 1e3 / n
    return state, {k: v for k, v in total.items() if k in counters()}, ms


def _slab_sharded(torch, rec_name, mesh, grid, tf, host_grid=None):
    """The 2^19 decode's DECODED_SLAB frame at SIZE², slab-sharded (plain
    and with a shadow volume) against the single-device frame; → (records,
    launches)."""
    from instantvnr_torch.parallel.slab import (make_sharded_slab_render,
                                                shard_volume_slabs)
    from instantvnr_torch.render.raymarch import DEFAULT_LIGHT
    from instantvnr_torch.render.shadow import shadow_volume_for
    from instantvnr_torch.render.slabmarch import (SlabSettings,
                                                   camera_arrays,
                                                   permuted_dims,
                                                   principal_axis,
                                                   slab_render)
    from instantvnr_torch.render.transform import default_transform

    dev = grid.device
    cam = orbit(1, N_FRAMES, max(DIMS))
    ca = camera_arrays(cam, dev)
    axis, flipped = principal_axis(cam)
    xform = default_transform(DIMS, dev)
    d_slab = permuted_dims(grid.shape, axis)[0]
    s = SlabSettings()
    shadow = shadow_volume_for(grid, tf, DEFAULT_LIGHT)
    src = grid if host_grid is None else host_grid
    chunk, _ = shard_volume_slabs(src, mesh, axis, flipped)
    fn = make_sharded_slab_render(mesh, SIZE, SIZE, s, axis, flipped,
                                  grid.shape)
    occ = torch.ones((d_slab,), dtype=torch.bool, device=dev)
    recs, total, frames = [], {}, {}
    for name, sv_ in (("plain", None), ("shadow", shadow)):
        sh = None if sv_ is None else shard_volume_slabs(
            sv_.cpu().numpy() if host_grid is not None else sv_, mesh, axis,
            flipped)[0]
        _par_reset()
        got = fn(chunk, tf, ca, occ, xform, sh)
        launched = _par_counts(torch)
        kernel = "composite_slabs" if sv_ is None else "composite_slabs_ext"
        want = {kernel: 1, "all_gather": 1}
        ref = slab_render(grid, tf, ca, SIZE, SIZE, s, axis, flipped, None,
                          xform, shadow_volume=sv_)
        err = float((got - ref).abs().max())
        rec = {"phase": f"{rec_name}[{name}]", "ranks": mesh.shape["data"],
               "chunk": list(chunk.shape), "launches": launched,
               "max_abs_err": err, "tol": SLAB_SHARD_ATOL,
               "alpha_max": float(got[:, 3].max()),
               "ms": cuda_ms(torch, lambda: fn(chunk, tf, ca, occ, xform,
                                               sh), iters=5, warmup=1),
               "single_device_ms": cuda_ms(
                   torch, lambda: slab_render(grid, tf, ca, SIZE, SIZE, s,
                                              axis, flipped, None, xform,
                                              shadow_volume=sv_),
                   iters=5, warmup=1)}
        recs.append(rec)
        frames[name] = got
        if name == "shadow":  # shadows do something
            rec["shadow_vs_plain"] = float((got - frames["plain"]).abs().max())
        if (launched != want or not err <= SLAB_SHARD_ATOL
                or rec.get("shadow_vs_plain", 1.0) <= 1e-3):
            raise AssertionError(f"slab-sharded frame: {rec}")
        add_launches(total, {k: v for k, v in launched.items()
                             if k in counters()})
    return recs, total


def _memo_grads():
    """Route trainer.value_and_grad (and the DP step's) through one cached
    call: two steps on the same batch then share one gradient, which K4's
    float atomics would otherwise sum in two orders → restore()."""
    from instantvnr_torch.models import trainer
    from instantvnr_torch.parallel import train as pt

    real, memo = trainer.value_and_grad, []

    def once(*args):
        if not memo:
            memo.append(real(*args))
        return memo[0]

    trainer.value_and_grad = pt.value_and_grad = once

    def restore():
        trainer.value_and_grad = pt.value_and_grad = real

    return restore


def par_world1(rank, dev, payload):
    """The world-1 NCCL group: dp_train[world=1,nccl] and
    slab_sharded[world=1,nccl]."""
    import torch

    from instantvnr_torch.config import ModelConfig, TransferFunctionConfig
    from instantvnr_torch.data.sampler import sample_static
    from instantvnr_torch.models import trainer
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.parallel import mesh as pm
    from instantvnr_torch.parallel import train as pt
    from instantvnr_torch.utils.tfn import bake_transfer_function

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pm.make_mesh(device=dev)
    vol = torch.from_numpy(payload["vorts"]).to(dev)
    field = NeuralField.from_config(ModelConfig())
    params = trainer.create_train_state(field, seed=SEED, device=dev).params
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c, t = sample_static(vol, gen, TRAIN_BATCH)
    # the host-batch step against train_step_hostbatch on one gradient (the
    # DP step takes the single-device step's, so it launches only Adam)
    restore = _memo_grads()
    try:
        s1 = trainer.train_step_hostbatch(field, trainer.state_for_params(
            params), c, t)
        _par_reset()
        s2 = pt.make_dp_hostbatch_step(field, mesh)(
            trainer.state_for_params(params), c, t)
        hostbatch = _par_counts(torch)
    finally:
        restore()

    def state_leaves(s):
        return _leaves(torch, (s.params, s.opt.mu, s.opt.nu, s.loss,
                               s.generator.get_state()))

    same = all(torch.equal(a, b) for a, b in zip(state_leaves(s1),
                                                 state_leaves(s2)))
    # the reduce alone, on a gradient of its own
    loss, grads = trainer.value_and_grad(field, params, c, t)
    red_grads, red_loss = pt.fused_pmean((grads, loss), mesh)
    reduce_same = all(torch.equal(a, b) for a, b in zip(
        _leaves(torch, (red_grads, red_loss)), _leaves(torch,
                                                       (grads, loss))))
    rec = {"phase": "dp_train[world=1,nccl]", "batch": TRAIN_BATCH,
           "hostbatch_bit_for_bit": same, "reduce_bit_for_bit": reduce_same,
           "hostbatch_collectives": hostbatch}
    state = pt.replicate_state(trainer.create_train_state(
        field, seed=SEED, device=dev), mesh)
    step = pt.make_dp_train_step(field, mesh, TRAIN_BATCH)
    state, launches, ms = _par_steps(
        torch, rec, step, state, vol, PAR_DP_STEPS,
        dict(STEP_LAUNCHES, all_reduce=1))
    # the DP step against the single-device step, in turns
    runs = {"dp": [state, lambda s: step(s, vol)],
            "single": [trainer.state_for_params(state.params),
                       lambda s: trainer.train_step(field, vol, s,
                                                    TRAIN_BATCH)]}
    times = {k: [] for k in runs}
    for _ in range(PAR_TIME_ROUNDS):
        for k, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PAR_TIME_STEPS):
                run[0] = run[1](run[0])
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3
                            / PAR_TIME_STEPS)
    state = runs["dp"][0]
    rec.update(steps=PAR_DP_STEPS, launches=launches, ms_per_step=ms,
               loss=float(state.loss), dp_step_ms=times["dp"],
               single_step_ms=times["single"],
               dp_step_ms_median=float(np.median(times["dp"])),
               single_step_ms_median=float(np.median(times["single"])))
    if not (same and reduce_same
            and hostbatch == {"all_reduce": 1, "adam_step": 1}
            and np.isfinite(rec["loss"])):
        raise AssertionError(f"dp_train[world=1]: {rec}")
    total = dict(launches)
    grid = torch.from_numpy(payload["grid"]).to(dev)
    tf = bake_transfer_function(TransferFunctionConfig(), device=dev)
    slab_recs, slab_launches = _slab_sharded(
        torch, "slab_sharded[world=1,nccl]", mesh, grid, tf)
    add_launches(total, slab_launches)
    return {"records": [rec] + slab_recs, "launches": total}


def _tp_single_grads(torch, field, params, coords, targets):
    """The single-device gradient of the TP step's function: the split-grad
    encode on the whole table (every level, caps their sizes), then the
    torch.matmul MLP of parallel/tp.py::tp_apply, L1."""
    from instantvnr_torch.ops import hash_encoding as he
    from instantvnr_torch.ops.mlp import apply_activation
    from instantvnr_torch.parallel.tp import _matmul

    spec, net, cd = field.spec, field.cfg.network, field.compute_dtype
    live = [p.detach().requires_grad_() for p in
            (params["table"], *params["mlp"])]
    with torch.enable_grad():
        h = he.hash_encode_traced_splitgrad(
            live[0], coords, he.level_param_arrays(spec), spec.level_sizes,
            spec.n_features, cd)
        for w in live[1:-1]:
            h = apply_activation(_matmul(h, w, cd), net.activation).to(cd)
        y = apply_activation(_matmul(h, live[-1], cd), net.output_activation)
        loss = torch.mean(torch.abs(y - targets))
        g = torch.autograd.grad(loss, live)
    return loss.detach(), g


def _par_tp(torch, dev, rank, vol):
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.data.sampler import sample_static
    from instantvnr_torch.models.network import NeuralField, params_from_numpy
    from instantvnr_torch.parallel import mesh as pm
    from instantvnr_torch.parallel import tp

    field = NeuralField.from_config(ModelConfig())
    spec = field.spec
    mesh = pm.make_mesh(tp=2, device=dev)
    lps, e_max = tp.tp_layout(field, 2)
    full = params_from_numpy(seeded_params(field, SEED), dev)
    local = tp.local_params(tp.split_params_tp(field, full, 2), rank)
    lp = tp.local_level_params(tp.shard_level_params(field, 2), rank)
    caps = tp.level_caps(field, 2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    c, t = sample_static(vol, gen, TRAIN_BATCH)
    _par_reset()
    loss, g = tp._tp_grads(field, mesh, local, lp, caps, c, t)
    launched = _par_counts(torch)
    ref_loss, ref = _tp_single_grads(torch, field, full, c, t)
    lo = spec.level_offsets[rank * lps]
    hi = spec.level_offsets[(rank + 1) * lps]
    nf = spec.n_features
    pairs = [("table", g["table"][:hi - lo], ref[0][lo:hi]),
             ("w1", g["w1"], ref[1][rank * lps * nf:(rank + 1) * lps * nf])]
    pairs += [(f"w{i + 2}", a, b) for i, (a, b) in
              enumerate(zip(g["mlp_rest"], ref[2:]))]
    errs, ratios, ok = {}, {}, True
    for name, a, b in pairs:
        d = (a - b).abs()
        errs[name] = float(d.max())
        ratios[name] = float(torch.linalg.vector_norm(a)
                             / torch.linalg.vector_norm(b))
        if name == "table":
            ok &= bool(d.le(HASH_BWD_ATOL + HASH_BWD_RTOL * b.abs()).all())
        else:
            ok &= errs[name] <= TP_MLP_RTOL * float(b.abs().max())
        ok &= abs(ratios[name] - 1.0) <= TP_NORM_TOL
    pad_zero = bool((g["table"][hi - lo:] == 0).all())
    want = {"hash_encode_forward": 1, "hash_encode_backward": 1,
            "all_reduce": 2}
    rec = {"phase": "tp_train[tp=2,gloo,one card]", "rank": rank,
           "levels": [rank * lps, (rank + 1) * lps - 1],
           "shard_rows": hi - lo, "e_max": e_max,
           "shard_mb": e_max * nf * 4 / 1e6, "grad_launches": launched,
           "loss": float(loss), "single_loss": float(ref_loss),
           "max_abs_err": errs, "norm_ratio": ratios,
           "padding_grad_zero": pad_zero,
           "tol": f"table atol={HASH_BWD_ATOL}, rtol={HASH_BWD_RTOL}; MLP "
                  f"{TP_MLP_RTOL} of max; norms within {TP_NORM_TOL}"}
    if not (ok and pad_zero and launched == want):
        raise AssertionError(f"tp gradient: {rec}")
    state = tp.create_tp_train_state(field, mesh, seed=SEED)
    step = tp.make_tp_train_step(field, mesh, TRAIN_BATCH)
    total = {k: v for k, v in launched.items() if k in counters()}
    state, launches, ms = _par_steps(torch, rec, step, state, vol,
                                     PAR_TP_STEPS, dict(want, adam_step=1))
    add_launches(total, launches)
    rec.update(steps=PAR_TP_STEPS, ms_per_step=ms, step_loss=float(
        state.loss), launches=launches)
    if not np.isfinite(rec["step_loss"]):
        raise AssertionError(f"tp steps: {rec}")
    return rec, total


def _par_ep(torch, dev, vol, vol_np):
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.parallel import ep
    from instantvnr_torch.parallel.inspect import count_collectives

    field = NeuralField.from_config(ModelConfig())
    mesh = ep.make_expert_mesh(dev)
    state = ep.create_ep_train_state(field, mesh, seed=SEED)
    step = ep.make_ep_train_step(field, mesh, TRAIN_BATCH)
    rec = {"phase": "ep[world=2,gloo,one card]",
           "expert": mesh.axis_index("expert")}
    state, launches, ms = _par_steps(torch, rec, step, state, vol,
                                     PAR_EP_STEPS, STEP_LAUNCHES)
    decode = ep.make_ep_decode(field, mesh, DIMS, gather=True)
    _par_reset()
    t0 = time.perf_counter()
    full = decode(state)
    dec_launched = _par_counts(torch)
    decode_ms = (time.perf_counter() - t0) * 1e3
    local_pins = count_collectives(ep.make_ep_decode(field, mesh, DIMS),
                                   state)
    full = full.cpu().numpy()
    err = (full - vol_np) ** 2
    rng = float(vol_np.max() - vol_np.min())
    psnr = float(10.0 * np.log10(rng * rng / max(float(err.mean()), 1e-20)))
    seam = np.zeros(DIMS[2], bool)
    z = DIMS[2] // 2
    seam[[z - 1, z]] = True
    rec.update(steps=PAR_EP_STEPS, ms_per_step=ms, loss=float(state.loss),
               launches=launches, decode_launches=dec_launched,
               decode_ms=decode_ms, local_decode_collectives=local_pins,
               psnr=psnr, mse_seam=float(err[seam].mean()),
               mse_interior=float(err[~seam].mean()))
    n_blobs = DIMS[2] // 2 // 16
    if (psnr <= EP_PSNR_MIN or local_pins != {}
            or not rec["mse_seam"] < EP_SEAM_MAX * rec["mse_interior"] + 1e-6
            or dec_launched != {"hash_encode_forward": n_blobs,
                                "fused_mlp": n_blobs, "all_gather": 1}):
        raise AssertionError(f"ep: {rec}")
    total = dict(launches)
    add_launches(total, {k: v for k, v in dec_launched.items()
                         if k in counters()})
    return rec, total


def _par_ray(torch, dev, mesh, sv):
    from functools import partial

    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.models.network import params_from_numpy
    from instantvnr_torch.parallel.render import make_sharded_render_fn
    from instantvnr_torch.render.raymarch import raymarch

    nv = api.NeuralVolume(ModelConfig(), sv, device=dev)
    nv.params = params_from_numpy(seeded_params(nv.field, SEED), dev)
    impl = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode.NEURAL_WAVEFRONT,
                          streaming_cache="none")._impl
    org, dirn, t0, t1, _ = wavefront_rays(torch, sv, SIZE, SIZE,
                                          orbit(0, N_FRAMES, max(DIMS)))
    jitter = torch.rand((SIZE * SIZE,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED))
    args = (impl.sample_ctx, org, dirn, t0, t1, impl.mc, impl.tf, jitter)
    fn = make_sharded_render_fn(impl.sample_fn, mesh, impl.settings)
    _par_reset()
    got = fn(*args)
    launched = _par_counts(torch)

    def single():
        return raymarch(partial(impl.sample_fn, impl.sample_ctx), *args[1:],
                        impl.settings)

    ref = single()
    err = float((got - ref).abs().max())
    rec = {"phase": "sharded_render[world=2]", "mode": "NEURAL_WAVEFRONT",
           "rays": SIZE * SIZE, "launches": launched, "max_abs_err": err,
           "same_bits": bool(torch.equal(got, ref)), "tol": RAY_SHARD_ATOL,
           "alpha_max": float(got[:, 3].max()),
           "ms": cuda_ms(torch, lambda: fn(*args), iters=3, warmup=1),
           "single_device_ms": cuda_ms(torch, single, iters=3, warmup=1)}
    need = ("raymarch_emit", "hash_encode_forward", "fused_mlp")
    if (not err <= RAY_SHARD_ATOL or launched.get("all_gather") != 1
            or any(not launched.get(k) for k in need)
            or rec["alpha_max"] <= 0.05):
        raise AssertionError(f"sharded render: {rec}")
    return rec, {k: v for k, v in launched.items() if k in counters()}


def par_world2(rank, dev, payload):
    """Two gloo ranks on one card: dp_train[world=2], tp_train[tp=2],
    ep[world=2], sharded_render[world=2] and slab_sharded[world=2]."""
    import torch

    from instantvnr_torch import api
    from instantvnr_torch.config import ModelConfig
    from instantvnr_torch.data.sampler import sample_static
    from instantvnr_torch.data.volume import Volume
    from instantvnr_torch.models import trainer
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.parallel import mesh as pm
    from instantvnr_torch.parallel import train as pt

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pm.make_mesh(device=dev)
    vol_np = payload["vorts"]
    sv = api.SimpleVolume(Volume(data=torch.from_numpy(vol_np), dims=DIMS,
                                 original_range=(0.0, 1.0)), device=dev)
    vol = sv.volume.data
    field = NeuralField.from_config(ModelConfig())
    # DP on split halves against the single-device step on the whole batch
    state = pt.replicate_state(trainer.create_train_state(
        field, seed=SEED, device=dev), mesh)
    params = state.params
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c, t = sample_static(vol, gen, TRAIN_BATCH)  # the same on both ranks
    half = slice(rank * TRAIN_BATCH // 2, (rank + 1) * TRAIN_BATCH // 2)
    _par_reset()
    loss_h, g_h = trainer.value_and_grad(field, params, c[half], t[half])
    g_m, loss_m = pt.fused_pmean((g_h, loss_h), mesh)
    launched = _par_counts(torch)
    loss_w, g_w = trainer.value_and_grad(field, params, c, t)
    errs, maxes, ratios = [], [], []
    for a, b in zip(_leaves(torch, g_m), _leaves(torch, g_w)):
        errs.append(float((a - b).abs().max()))
        maxes.append(float(b.abs().max()))
        ratios.append(float(torch.linalg.vector_norm(a)
                            / torch.linalg.vector_norm(b)))
    loss_err = abs(float(loss_m) - float(loss_w))
    ok = (all(e <= DP_GRAD_REL * m for e, m in zip(errs, maxes))
          and all(abs(r - 1.0) <= TP_NORM_TOL for r in ratios)
          and loss_err <= DP_GRAD_REL * abs(float(loss_w)))
    n_floats = sum(x.numel() for x in _leaves(torch, (g_h, loss_h)))
    ar_ms = cuda_ms(torch, lambda: pt.fused_pmean((g_h, loss_h), mesh),
                    iters=5, warmup=1)
    rec = {"phase": "dp_train[world=2,gloo,one card]", "rank": rank,
           "batch": TRAIN_BATCH, "max_abs_err": max(errs),
           "leaf_max_abs_err": errs, "leaf_max_abs": maxes,
           "norm_ratio": ratios, "loss_abs_err": loss_err,
           "tol": f"each leaf and the loss within {DP_GRAD_REL} of its "
                  f"largest entry; norms within {TP_NORM_TOL}",
           "loss_halves": float(loss_m), "loss_whole": float(loss_w),
           "grad_launches": launched, "all_reduce_mb": n_floats * 4 / 1e6,
           "all_reduce_ms": ar_ms}
    if not ok or launched != dict(GRAD_LAUNCHES, all_reduce=1):
        raise AssertionError(f"dp_train[world=2]: {rec}")
    step = pt.make_dp_train_step(field, mesh, TRAIN_BATCH)
    state, launches, ms = _par_steps(torch, rec, step, state, vol,
                                     PAR_W2_DP_STEPS,
                                     dict(STEP_LAUNCHES, all_reduce=1))
    rec.update(steps=PAR_W2_DP_STEPS, ms_per_step=ms, launches=launches)
    total = dict(launches)
    add_launches(total, {k: v for k, v in launched.items()
                         if k in counters()})
    recs = [rec]
    for part in (lambda: _par_tp(torch, dev, rank, vol),
                 lambda: _par_ep(torch, dev, vol, vol_np),
                 lambda: _par_ray(torch, dev, mesh, sv)):
        r, got = part()
        recs.append(r)
        add_launches(total, got)
    grid = torch.from_numpy(payload["grid"]).to(dev)
    slab_recs, slab_launches = _slab_sharded(
        torch, "slab_sharded[world=2,gloo,one card]", mesh, grid, sv.tf,
        host_grid=payload["grid"])
    recs += slab_recs
    add_launches(total, slab_launches)
    return {"records": recs, "launches": total}


def phase_parallel(torch, grid, vorts, device="cuda"):
    """The parallel slice on the card: a world-1 NCCL group, then two gloo
    ranks sharing it, each in child processes spawned once (the kernels
    are built already, so the ranks load them). → the kernel launches of
    the phases' runs, summed over the ranks."""
    from instantvnr_torch.parallel.mesh import spawn

    payload = {"grid": grid, "vorts": vorts}
    t0 = time.perf_counter()
    outs = spawn(par_world1, 1, payload, device=device,
                 backend="nccl" if device == "cuda" else "gloo", timeout=600)
    t1 = time.perf_counter()
    outs += spawn(par_world2, 2, payload, device=device, backend="gloo",
                  timeout=600)
    t2 = time.perf_counter()
    total = {}
    for o in outs:
        for r in o["records"]:
            log(r)
        add_launches(total, o["launches"])
    log({"phase": "parallel", "world1_seconds": t1 - t0,
         "world2_seconds": t2 - t1, "launches": total})
    return total



# -- ray compaction, schedule replay and CUDA graphs ----------------------

COMPACT_ROWS = 1 << 18  # m of the kernel phase: a 512² frame's rays
COMPACT_LIVE = 0.45  # the live share of its rows
# a compacted mode's frames: serialized, replayed (the second one captures
# the fused frame), then fused
COMPACT_FRAMES = 6
COMPACT_MODES = (("NEURAL_WAVEFRONT", "none", SIZE),
                 ("NEURAL_WAVEFRONT", "auto", SIZE),
                 ("NEURAL_WAVEFRONT_GRADIENT", "none", SIZE),
                 ("NEURAL_WAVEFRONT_SSH", "none", SIZE),
                 ("REFERENCE_RAYMARCH", None, SIZE),
                 ("NEURAL_WAVEFRONT", "auto", 768))
PT_COMPACT_FRAMES = 16
PT_PARITY_SIZE = 64  # 4096 rays: under the 8192 bucket floor, no compaction
# JAX's test_compacted_statistical_parity: the mean within rtol 0.15, a
# pixel within 0.35 after 48 frames; the pixel band scaled to 16 frames as
# Monte Carlo noise scales, by sqrt(48 / 16), on PT_COMPACT_SHARE of the
# 262,144 pixels (JAX's test holds 256)
PT_COMPACT_RTOL, PT_COMPACT_SHARE = 0.15, 0.99
PT_COMPACT_ATOL = 0.35 * math.sqrt(48 / PT_COMPACT_FRAMES)
# the select form's slots: m·K of a 512² frame at K = 8 (render/raymarch.py
# ::_Slots partitions the slots' 12-byte positions by the valid mask)
SELECT_SLOTS = 1 << 21
# the edge sizes held bit for bit: ragged tiles, a 768² frame's rays, the
# select form's n
COMPACT_EDGE_ROWS = (1, 31, 1023, 1024, 1025, 768 * 768, 1 << 21)
# the kernels' names, for their device time in a call or a profiled frame
COMPACT_KERNELS = ("compact_count_kernel", "compact_partition_kernel",
                   "compact_copy_back_kernel")
SCATTER_KERNELS = ("scatter_invert_kernel", "scatter_gather_kernel")
COMPACTION_KERNEL_NAMES = COMPACT_KERNELS + SCATTER_KERNELS


def is_compaction_kernel(name):
    return any(k in name for k in COMPACTION_KERNEL_NAMES)


def seeded_rows(torch, spec, m, g, live=COMPACT_LIVE):
    """Seeded rows of each leaf of `spec` ({name: (shape, dtype)}) on the
    card: bools live with probability `live`, int32 in [0, m), floats in
    [0, 1)."""
    out = {}
    for n, (shape, dt) in spec.items():
        if dt == torch.bool:
            out[n] = torch.rand((m,) + shape, generator=g,
                                device="cuda") < live
        elif dt == torch.int32:
            out[n] = torch.randint(0, max(m, 1), (m,) + shape, generator=g,
                                   device="cuda", dtype=dt)
        else:
            out[n] = torch.rand((m,) + shape, generator=g, device="cuda")
    return out


def compact_both(torch, base):
    """compact_rows (order, count and copy back; the flags the leaf
    "active") through the kernel and through the plain version on copies
    of `base` ({name: tensor}) → (same bits: leaves, scratch, count and
    order; the live count; the kernel's launches)."""
    from instantvnr_torch.ops import compaction as ops

    m = base["active"].shape[0]
    res = {}
    for name, fn in (("k", ops.compact_rows),
                     ("p", ops.compact_rows_reference)):
        leaves = {n: x.clone() for n, x in base.items()}
        scratch = [torch.empty_like(x) for x in leaves.values()]
        count = torch.full((1,), -1, dtype=torch.int32, device="cuda")
        order = torch.full((m,), -1, dtype=torch.int32, device="cuda")
        before = ops.compact_counter.launches
        fn(leaves["active"], list(leaves.values()), scratch, count=count,
           order=order, copy_back=True)
        res[name] = (list(leaves.values()) + scratch, count, order,
                     ops.compact_counter.launches - before)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(res["k"][0], res["p"][0]))
    same &= (torch.equal(res["k"][1], res["p"][1])
             and torch.equal(res["k"][2], res["p"][2]))
    return same, int(res["p"][1]), res["k"][3]


def frame_permutation(torch, m, g):
    """The slot → pixel order of a frame of m rays after three stable
    partitions of a shrinking prefix, each keeping the rays of a smaller
    disc of the image live (a frame's coherent silhouettes)."""
    side = math.isqrt(m)
    idx = torch.arange(m, device="cuda")
    yx = torch.stack([idx // side, idx % side], 1).float() - side / 2
    r = yx.norm(dim=1) * (1 + 0.05 * torch.rand(m, generator=g,
                                                device="cuda"))
    perm = idx.clone()
    prefix = m
    for k in range(3):
        live = r[perm[:prefix]] < side * (0.5 - 0.12 * k)
        order = torch.argsort(~live, stable=True)
        perm[:prefix] = perm[:prefix][order]
        prefix = int(live.sum())
    return perm.to(torch.int32)


def compaction_cases(torch):
    """The compaction kernels' timed inputs at the smoke's shapes, from
    one seed: {name: (fn, plain, library, bound bytes, extra)}, each fn a
    call through ops/compaction.py (also in scripts/compare_trees.py)."""
    from instantvnr_torch.ops import compaction as ops
    from instantvnr_torch.render.compaction import (_OUT_LEAVES,
                                                    WAVEFRONT_LEAVES)
    from instantvnr_torch.render.pathtrace import PT_LEAVES

    m = COMPACT_ROWS
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    cases = {}
    for name, spec in (("band", WAVEFRONT_LEAVES), ("pathtrace", PT_LEAVES)):
        work = list(seeded_rows(torch, spec, m, g).values())
        # the flags apart from the leaf they came from, which each call
        # partitions in place: every timed call partitions random flags
        flags = work[list(spec).index("active")].clone()
        scratch = [torch.empty_like(x) for x in work]

        def kernel(work=work, flags=flags, scratch=scratch):
            ops.compact_rows(flags, work, scratch, copy_back=True)

        def plain(work=work, flags=flags, scratch=scratch):
            ops.compact_rows_reference(flags, work, scratch, copy_back=True)

        def library(work=work, flags=flags):
            order = torch.argsort(~flags, stable=True)
            return [x.index_select(0, order) for x in work]

        leaf = nbytes(*work)
        # the bound: the flags and the leaves read once, the leaves and the
        # count written once; beside it the bytes with the scratch written
        # too, and as the copy back moves them (the leaves read and written
        # twice)
        cases[name] = (kernel, plain, library, m + 2 * leaf + 4,
                       {"rows": m, "leaves": len(work),
                        "row_bytes": leaf // m,
                        "bound_scratch_ms": (m + 3 * leaf + 4)
                        / H100_BYTES_PER_S * 1e3,
                        "bound_copy_back_ms": (m + 4 * leaf)
                        / H100_BYTES_PER_S * 1e3,
                        "library": "torch.argsort(~active, stable=True) + "
                                   f"index_select a leaf ({len(work) + 1} "
                                   "calls)"})
    n = SELECT_SLOTS
    mask = torch.rand(n, generator=g, device="cuda") < COMPACT_LIVE
    pos = torch.rand((n, 3), generator=g, device="cuda")
    cases["select"] = (
        lambda: ops.select_rows(mask, pos),
        lambda: ops.compact_rows_reference(
            mask, [pos], [torch.empty_like(pos)],
            count=torch.empty(1, dtype=torch.int32, device="cuda"),
            order=torch.empty(n, dtype=torch.int32, device="cuda")),
        lambda: pos.index_select(0, torch.argsort(~mask, stable=True)),
        n + 12 * n + 12 * n + 4 * n + 4,
        {"rows": n, "leaves": 1, "row_bytes": 12,
         "library": "torch.argsort(~mask, stable=True) + index_select "
                    "(2 calls)"})
    src = list(seeded_rows(torch, {k: WAVEFRONT_LEAVES[k]
                                   for k in _OUT_LEAVES}, m, g).values())
    outs = [torch.empty_like(x) for x in src]
    live = torch.rand(m, generator=g, device="cuda") < COMPACT_LIVE
    perms = {"scatter_partition": torch.argsort(~live, stable=True),
             "scatter_frame": frame_permutation(torch, m, g),
             "scatter_random": torch.randperm(m, generator=g,
                                              device="cuda")}
    for name, p in perms.items():
        p32, p64 = p.to(torch.int32), p.to(torch.int64)
        cases[name] = (
            lambda p32=p32: ops.scatter_rows(p32, src, outs),
            lambda p32=p32: ops.scatter_rows_reference(p32, src, outs),
            lambda p64=p64: [o.index_copy_(0, p64, x)
                             for o, x in zip(outs, src)],
            2 * nbytes(*src) + 4 * m,
            {"rows": m, "leaves": len(src), "row_bytes": nbytes(*src) // m,
             "library": f"index_copy_ a leaf ({len(src)} calls)",
             "perm": p32, "src": src})
    return cases


def graph_replays(torch, g):
    """The band's compaction twice (order and count, copy back) and the
    select form, captured in one CUDA graph and replayed three times,
    new rows and flags copied into its buffers before each: after each
    replay every output equal bit for bit to the plain versions' on the
    same inputs → the replays' verdicts."""
    from instantvnr_torch.ops import compaction as ops
    from instantvnr_torch.render.compaction import WAVEFRONT_LEAVES

    m = COMPACT_ROWS
    fi = list(WAVEFRONT_LEAVES).index("active")
    n = 8 * m
    work = list(seeded_rows(torch, WAVEFRONT_LEAVES, m, g).values())
    scratch = [torch.empty_like(x) for x in work]
    count = torch.empty(1, dtype=torch.int32, device="cuda")
    order = torch.empty(m, dtype=torch.int32, device="cuda")
    mask = torch.zeros(n, dtype=torch.bool, device="cuda")
    pos = torch.zeros((n, 3), device="cuda")
    sel = {}

    def program():
        ops.compact_rows(work[fi], work, scratch, count=count, order=order,
                         copy_back=True)
        ops.compact_rows(work[fi], work, scratch, count=count, order=order,
                         copy_back=True)
        sel["out"] = ops.select_rows(mask, pos)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        program()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        program()
    verdicts = []
    for k in range(3):
        fresh = seeded_rows(torch, WAVEFRONT_LEAVES, m, g,
                            live=(0.2, 0.45, 0.8)[k])
        for w, x in zip(work, fresh.values()):
            w.copy_(x)
        mask.copy_(torch.rand(n, generator=g, device="cuda") < 0.3 + 0.2 * k)
        pos.copy_(torch.rand((n, 3), generator=g, device="cuda"))
        want = [x.clone() for x in fresh.values()]
        wscr = [torch.empty_like(x) for x in want]
        wcount = torch.empty(1, dtype=torch.int32, device="cuda")
        worder = torch.empty(m, dtype=torch.int32, device="cuda")
        for _ in range(2):
            ops.compact_rows_reference(want[fi], want, wscr, count=wcount,
                                       order=worder, copy_back=True)
        wsel = (torch.empty_like(pos),
                torch.empty(n, dtype=torch.int32, device="cuda"),
                torch.empty(1, dtype=torch.int32, device="cuda"))
        ops.compact_rows_reference(mask, [pos], [wsel[0]], count=wsel[2],
                                   order=wsel[1])
        graph.replay()
        torch.cuda.synchronize()
        verdicts.append(
            all(torch.equal(a, b) for a, b in zip(work + scratch,
                                                  want + wscr))
            and torch.equal(count, wcount) and torch.equal(order, worder)
            and all(torch.equal(a, b) for a, b in zip(sel["out"], wsel)))
    return verdicts


def phase_compaction_kernels(torch):
    """compact_rows and scatter_rows against their plain versions, bit for
    bit: the band's compaction (the wavefront's 14 leaves, 93 bytes a row,
    COMPACT_LIVE of them live, with copy back) and the path tracer's (11
    leaves, 70 bytes) at m = COMPACT_ROWS; the select form (12-byte
    positions, order and count) at SELECT_SLOTS; every COMPACT_EDGE_ROWS
    size, and all live and none live; a CUDA graph of three launches
    replayed with new flags; scatter_rows on a compaction's slot → pixel
    order, on a frame's after three compactions and on a random
    permutation. Device times (the kernels by name), the call by CUDA
    events, the plain version, the bounds from this run's bytes, and the
    nearest PyTorch (more than one call each) → (the band's record, the
    scatter's on a compaction's order)."""
    from instantvnr_torch.ops import compaction as ops
    from instantvnr_torch.render.compaction import WAVEFRONT_LEAVES
    from instantvnr_torch.render.pathtrace import PT_LEAVES

    recs = {}
    cases = compaction_cases(torch)
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for name, (fn, plain, library, n_bytes, extra) in cases.items():
        if name.startswith("scatter"):
            kernels = SCATTER_KERNELS
            p, src = extra.pop("perm"), extra.pop("src")
            outs = {k: [torch.empty_like(x) for x in src] for k in "kp"}
            ops.scatter_rows(p, src, outs["k"])
            ops.scatter_rows_reference(p, src, outs["p"])
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(*outs.values()))
        else:
            kernels = COMPACT_KERNELS
            same = None  # checked below, on copies
        b_ms, b_by = bound_ms(n_bytes, 0, H100_FP32_FLOPS)
        lib_ms, lib_call = library_times(torch, library)
        recs[name] = {
            "phase": f"compaction_kernels[{name}]", **extra,
            "same_bits": same, "tol": "bit for bit",
            "ms": device_ms(torch, fn, kernels),
            "call_ms": cuda_ms(torch, fn),
            "plain_ms": cuda_ms(torch, plain, iters=3, warmup=1),
            "library_ms": lib_ms, "library_call_ms": lib_call,
            "bound_ms": b_ms, "bound_by": b_by, "mbytes": n_bytes / 1e6}
    for name, spec in (("band", WAVEFRONT_LEAVES), ("pathtrace", PT_LEAVES)):
        base = seeded_rows(torch, spec, COMPACT_ROWS, g)
        same, live, launches = compact_both(torch, base)
        recs[name].update(same_bits=same and launches == 1, live=live)
    n = SELECT_SLOTS
    mask = torch.rand(n, generator=g, device="cuda") < COMPACT_LIVE
    pos = torch.rand((n, 3), generator=g, device="cuda")
    out, order, count = ops.select_rows(mask, pos)
    want = (torch.empty_like(pos), torch.empty(n, dtype=torch.int32,
                                               device="cuda"),
            torch.empty(1, dtype=torch.int32, device="cuda"))
    ops.compact_rows_reference(mask, [pos], [want[0]], count=want[2],
                               order=want[1])
    torch.cuda.synchronize()
    recs["select"].update(
        same_bits=all(torch.equal(a, b) for a, b in zip((out, order, count),
                                                         want)),
        live=int(want[2]))
    for rec in recs.values():
        rec["max_abs_err"] = 0.0 if rec["same_bits"] else None
        log(rec)
    # edge sizes: random flags at each size, all live and none live at a
    # few; scatter_rows on a random permutation of each size
    edges = []
    for m in COMPACT_EDGE_ROWS:
        base = seeded_rows(torch, WAVEFRONT_LEAVES, m, g)
        shares = ((COMPACT_LIVE, 1.0, 0.0) if m in (1, 1025, 768 * 768)
                  else (COMPACT_LIVE,))
        for share in shares:
            if share != COMPACT_LIVE:
                base["active"].fill_(share == 1.0)
            same, live, launches = compact_both(torch, base)
            edges.append({"rows": m, "live_share": share, "live": live,
                          "same_bits": same, "launches": launches})
        src = [base[k] for k in ("org", "t", "active")]
        p = torch.randperm(m, generator=g, device="cuda").to(torch.int32)
        outs = {k: [torch.empty_like(x) for x in src] for k in "kp"}
        ops.scatter_rows(p, src, outs["k"])
        ops.scatter_rows_reference(p, src, outs["p"])
        torch.cuda.synchronize()
        edges.append({"rows": m, "scatter": True, "same_bits": all(
            torch.equal(a, b) for a, b in zip(*outs.values()))})
    replays = graph_replays(torch, g)
    erec = {"phase": "compaction_edges", "cases": edges,
            "graph_replays_same_bits": replays}
    log(erec)
    if not (all(r["same_bits"] for r in recs.values())
            and all(e["same_bits"] and e.get("launches", 1) == 1
                    for e in edges) and all(replays)):
        raise AssertionError(f"a compaction kernel differs from its plain "
                             f"version: {recs} {erec}")
    return recs["band"], recs["scatter_partition"]


def _sched_counts(cache):
    """The replay counters over a schedule cache and its bands."""
    caches = [cache] + [c for c in cache.values() if isinstance(c, dict)]
    return {k: sum(c.get(k, 0) for c in caches)
            for k in ("serialized", "replays", "fused_frames",
                      "invalidated")}


def run_compacted_mode(torch, nv, mode, policy, size):
    """One wavefront mode at size², COMPACT_FRAMES frames of one jitter
    sequence through the masked march (settings.compact off) and through
    the compacted path: each compacted frame (serialized, replayed or
    fused, from the schedule counters) equal to the masked frame bit for
    bit; ms a frame (render to mapframe) in both, the schedule, the graphs
    captured and their capture ms, launches, a profiled frame's idle
    share and peak memory."""
    from instantvnr_torch import api
    from instantvnr_torch.render import compaction as comp

    subject = nv.simple if mode.startswith("REFERENCE") else nv
    g = torch.Generator(device="cuda").manual_seed(SEED + size)
    jitters = [torch.rand(size * size, generator=g, device="cuda")
               for _ in range(COMPACT_FRAMES + 1)]
    frames, ms = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for compact in (False, True):
        kw = {} if policy is None else {"streaming_cache": policy}
        r = api.VNRenderer(subject, size, size, api.RenderMode[mode], **kw)
        impl = r._impl
        if not compact:
            impl.settings = dataclasses.replace(impl.settings, compact=False)
        r.set_camera(orbit(1, N_FRAMES, max(DIMS)))
        it = iter(jitters)
        impl._next_jitter = lambda it=it: next(it)
        capt = dict(comp.CAPTURED)
        torch.cuda.synchronize()
        for c in counters().values():
            c.reset()
        fs, ts, kinds, steps, host, dev = [], [], [], [], [], []
        for _ in range(COMPACT_FRAMES):
            before = _sched_counts(impl._sched_cache)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            r.render()
            ev[1].record()
            host.append((time.perf_counter() - t0) * 1e3)
            fs.append(r.mapframe())
            ts.append((time.perf_counter() - t0) * 1e3)
            dev.append(ev[0].elapsed_time(ev[1]))
            after = _sched_counts(impl._sched_cache)
            kinds.append("fused" if after["fused_frames"]
                         > before["fused_frames"] else "replayed"
                         if after["replays"] > before["replays"]
                         else "serialized" if compact else "masked")
            steps.append(impl.last_stats.get("supersteps"))
        launches = {n: c.launches for n, c in counters().items()}
        steps.append(impl.redo_stats.get("supersteps", 0)
                     if compact else 0)
        frames[compact], ms[compact] = fs, ts
        if compact:
            caps = {k: comp.CAPTURED[k] - capt[k] for k in capt}
            settings = impl.settings
            prof = profiled_frame(torch, impl, r.render)
            info = {"kinds": kinds, "supersteps": steps,
                    "counters": _sched_counts(impl._sched_cache),
                    "ops": [list(op) for op in impl._sched_cache.get(
                        "ops") or []],
                    "render_host_ms": host, "render_stream_ms": dev,
                    "tiles": settings.tiles,
                    "finish_bucket": settings.finish_bucket,
                    "graphs": caps["graphs"],
                    "capture_ms": caps["ms"],
                    "launches": launches, "profiled_frame": prof}
    same = [bool(np.array_equal(a, b)) for a, b in zip(frames[True],
                                                        frames[False])]
    err = max(float(np.abs(a - b).max()) for a, b in zip(frames[True],
                                                          frames[False]))
    rec = {"phase": f"compacted_wavefront[{mode},{policy},{size}]",
           "frames": COMPACT_FRAMES, "same_bits": same, "max_abs_err": err,
           "masked_ms": ms[False], "compacted_ms": ms[True],
           "alpha_max": float(frames[True][-1][..., 3].max()),
           "max_memory_allocated": torch.cuda.max_memory_allocated(), **info}
    return rec


def phase_compacted_wavefront(torch, nv):
    """COMPACT_MODES through the compacted path against the masked march:
    bit for bit in every frame; the serialized, replayed and fused frames
    each seen; the emissions one a superstep; compact_rows and
    scatter_rows launched."""
    recs = []
    for mode, policy, size in COMPACT_MODES:
        rec = run_compacted_mode(torch, nv, mode, policy, size)
        log(rec)
        ln = rec["launches"]
        kinds = set(rec["kinds"])
        need = {"serialized", "replayed"} | (
            set() if mode.endswith("SSH") else {"fused"})
        if (not all(rec["same_bits"]) or not need <= kinds
                or ln["raymarch_emit"] != sum(rec["supersteps"])
                or not ln["compact_rows"] or not ln["scatter_rows"]
                or rec["counters"]["invalidated"]
                or not rec["alpha_max"] > 0.05):
            raise AssertionError(f"compacted wavefront: {rec}")
        recs.append(rec)
    return recs


def phase_compacted_pathtrace(torch, nv):
    """The three PATHTRACE modes through the compacted tracker: at
    PT_PARITY_SIZE² (nothing compacts) its first frame equal to the masked
    tracker's bit for bit from one seed (the card generator's draws in
    CUDA graphs against eager draws); at SIZE² PT_COMPACT_FRAMES frames of
    each tracker, their means in JAX's statistical band, ms a frame."""
    from instantvnr_torch import api

    recs = []
    for mode in PT_MODES:
        parity = {}
        for compact in (False, True):
            r = api.VNRenderer(nv, PT_PARITY_SIZE, PT_PARITY_SIZE,
                               api.RenderMode[mode])
            r._impl.settings = dataclasses.replace(r._impl.settings,
                                                   compact=compact)
            r.set_camera(orbit(0, N_FRAMES, max(DIMS)))
            r.render()
            parity[compact] = r.mapframe()
        same_small = bool(np.array_equal(parity[True], parity[False]))
        means, ms, kinds = {}, {}, []
        launches = None
        for compact in (False, True):
            r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode[mode])
            impl = r._impl
            impl.settings = dataclasses.replace(impl.settings,
                                                compact=compact)
            r.set_camera(orbit(0, N_FRAMES, max(DIMS)))
            torch.cuda.synchronize()
            for c in counters().values():
                c.reset()
            ts = []
            events = 0
            for _ in range(PT_COMPACT_FRAMES):
                before = _sched_counts(impl._sched_cache)
                t0 = time.perf_counter()
                r.render()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
                events += impl.last_stats["events"]
                if compact:
                    after = _sched_counts(impl._sched_cache)
                    kinds.append("fused" if after["fused_frames"]
                                 > before["fused_frames"] else "replayed"
                                 if after["replays"] > before["replays"]
                                 else "serialized")
            means[compact] = r.mapframe()
            ms[compact] = ts
            if compact:
                launches = {n: c.launches for n, c in counters().items()}
                counts = _sched_counts(impl._sched_cache)
                ops = [list(op) for op in impl._sched_cache.get("ops") or []]
                # a rolled-back frame's serialized redo traces too
                redo = impl.redo_stats.get("events", 0)
                n_events = events + redo
        diff = np.abs(means[True] - means[False]).max(-1)
        mean_c, mean_m = (float(means[k][..., :3].mean())
                          for k in (True, False))
        rec = {"phase": f"compacted_pathtrace[{mode}]",
               "parity_size": PT_PARITY_SIZE, "same_bits_small": same_small,
               "frames": PT_COMPACT_FRAMES, "kinds": kinds,
               "masked_ms": ms[False], "compacted_ms": ms[True],
               "rgb_mean": {"compacted": mean_c, "masked": mean_m},
               "share_within_atol": float((diff <= PT_COMPACT_ATOL).mean()),
               "atol": PT_COMPACT_ATOL, "rtol": PT_COMPACT_RTOL,
               "events": n_events, "redo_events": redo, "counters": counts,
               "ops": ops,
               "launches": launches}
        log(rec)
        ln = launches
        if (not same_small or abs(mean_c - mean_m) > PT_COMPACT_RTOL * mean_m
                or rec["share_within_atol"] < PT_COMPACT_SHARE
                or ln["pt_track"] != n_events or ln["pt_resolve"] != n_events
                or not ln["scatter_rows"] or "fused" not in kinds):
            raise AssertionError(f"compacted path tracer: {rec}")
        recs.append(rec)
    return recs


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
    mma = mma_counts(lib.path)
    log({"phase": "build", "seconds": lib.build_seconds,
         "library": os.path.relpath(lib.path, ROOT), "ptxas": ptxas,
         "tensor_core_mma_instructions": mma})
    if not all(mma.get(k) and all(v > 0 for v in mma[k].values())
               for k in MMA_KERNELS):
        raise AssertionError(f"a fused-MLP kernel has no tensor-core MMA in "
                             f"its SASS: {mma}")

    # -- kernel phases: each kernel against its plain version -------------
    sv = api.SimpleVolume.synthetic(DIMS, "vorts", device="cuda")
    vol = sv.volume.data
    blob_rows = DIMS[0] * DIMS[1] * 16
    mlp = phase_fused_mlp(torch, blob_rows)
    mlp_train = phase_fused_mlp_train(torch)
    hashes = {log2: phase_hash_encode(torch, f"2^{log2}", log2)
              for log2 in (14, 19)}
    paired = phase_hash_paired(torch)
    coords_grad = phase_hash_coords_grad(torch, sv)
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
    emit = phase_raymarch_emit(torch, sv)
    emit_bwd = phase_raymarch_emit_backward(torch, sv)
    pt = phase_pt_kernels(torch, sv)
    compact_k, scatter_k = phase_compaction_kernels(torch)
    phase_small_parity(torch)
    phase_facade_cuda_vs_cpu(torch)
    phase_one_voxel(torch)
    phase_wavefront_cuda_vs_cpu(torch)
    phase_pathtrace_cuda_vs_cpu(torch)
    phase_edge_pixel(torch)

    # -- main path: counts from 0, then decode + an orbit of frames --------
    nv = api.NeuralVolume(ModelConfig(), sv, device="cuda")
    nv.params = params_from_numpy(seeded_params(nv.field, SEED), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, decode = decode_launches(torch, lambda: nv.ensure_decoded(SIZE, SIZE))
    decode_ms = (time.perf_counter() - t0) * 1e3
    r = api.VNRenderer(nv, SIZE, SIZE, api.RenderMode.DECODED_SLAB)
    rec = run_orbit(torch, r, "main_path")
    grid = nv.get_decoder().decoded
    rec.update(model="ModelConfig() 2^19, 8x8 levels, 64x4 MLP",
               volume=f"vorts {DIMS}", frame=f"{SIZE}^2",
               decode_ms=decode_ms, decode_launches=decode,
               grid_mean=float(grid.mean()), grid_std=float(grid.std()))
    log(rec)
    plain = rec
    if nv.n_blobs != 8 or decode != DECODE_LAUNCHES:
        raise AssertionError(f"decode launched {decode} for {nv.n_blobs} "
                             f"blobs, not {DECODE_LAUNCHES}")
    check_launches(rec, {"composite_slabs": N_FRAMES})
    if rec["alpha_max_min"] <= 0.05:
        raise AssertionError(f"invisible frame: {rec}")

    # -- the views of this slice on the same decode -----------------------
    views = phase_views(torch, nv, r, plain)
    log({"phase": "main_path_memory",
         "max_memory_allocated": torch.cuda.max_memory_allocated()})
    phase_decode_vs_plain(torch, nv, grid)
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
            raise AssertionError("checkpoint round trip rendered a bad "
                                 "frame")
        log({"phase": "bson_roundtrip", "alpha_max": float(f2[..., 3].max()),
             "bytes": ckpt_bytes})
        phase_npz_roundtrip(torch, sv, tmp)
        phase_cli(torch, tmp)
        phase_profile_trace(torch, tmp, os.path.join(tmp, "cli.npz"))

    # -- the wavefront modes and the degenerate cameras' fallbacks ---------
    wavefront = phase_wavefront_views(torch, nv)
    phase_fallbacks(torch, nv)

    # -- the path tracer and the brick wavefront --------------------------
    bricks = phase_brick_sample(torch, nv)
    pathtrace = phase_pathtrace(torch, nv)
    brick_wavefront = phase_brick_wavefront(torch, nv)

    # -- the compacted wavefront and path tracer against the masked ones --
    compacted = (phase_compacted_wavefront(torch, nv)
                 + phase_compacted_pathtrace(torch, nv))

    # -- training: 2^14 against its controls, 2^19 over three seeds -------
    train14, nv19 = phase_training(torch, sv)
    adam = phase_train_breakdown(torch, nv19)["adam"]
    phase_online_loop(torch, nv19)

    # -- the paired layout's path, the differentiable march, fV-SRN, VDB --
    paired_path = phase_paired_training(torch, sv)
    diff = phase_differentiable_march(torch, sv)
    with tempfile.TemporaryDirectory(dir=ckpt_dir) as tmp:
        phase_fvsrn(torch, sv, tmp)
        phase_vdb(torch, sv, tmp)

    # -- the parallel slice: DP, TP, EP, ray- and slab-sharded frames -----
    par = phase_parallel(torch, grid.cpu().numpy(), vol.cpu().numpy())

    # -- the interactive apps: the online trainer and the viewer ----------
    with tempfile.TemporaryDirectory(dir=ckpt_dir) as tmp:
        online = {log2: phase_online_app(torch, tmp, log2)
                  for log2 in (14, 19)}
        viewer_rec = phase_viewer(torch, tmp)

    # -- isosurfaces on the kernels; scenes, analytic and out-of-core -----
    iso_k = phase_isosurface_kernel(torch, vol, nv)
    iso_net = phase_isosurface_network(torch, nv, nv19)
    del nv19
    with tempfile.TemporaryDirectory(dir=ckpt_dir) as tmp:
        vorts256, vols = vorts_u16_volumes((256, 256, 256))
        scene = write_scene(tmp, vols)
        phase_scene_load(torch, scene, vols)
        phase_analytic_training(torch)
        phase_out_of_core_training(torch, tmp, vorts256)
        del vorts256, vols
        phase_cli_data(torch, tmp, scene)

    # launches: totals over the main-path runs (the plain orbit with its
    # decode, then the four views; the wavefront modes; the path tracer's
    # modes and the brick wavefront; the 1000 steps of train_2e14; the
    # online app at 2^19 and the viewer)
    runs = ([plain] + views + wavefront + pathtrace + brick_wavefront
            + compacted + [online[19], viewer_rec])
    total = {name: sum(v["launches"][name] for v in runs)
             for name in counters()}
    for d in (decode, views[-1]["decode_launches"]):
        add_launches(total, d)
    for name in TRAIN_KERNELS:
        total[name] += train14["launches"][name]
    # the paired layout's path (its training, decode and frame) and the
    # differentiable march's frame
    add_launches(total, paired_path["launches"])
    add_launches(total, diff["launches"])
    add_launches(total, diff["ray_launches"])
    # the extraction's runs: the network path and the grid path
    add_launches(total, iso_net["launches"])
    total["mt_count/mt_emit"] += iso_net["grid_path_launches"]
    # the parallel phases' runs, over their ranks
    add_launches(total, par)
    csrc = "instantvnr_torch/csrc/"
    tpu = "instantvnr_tpu/ops/pallas/"

    def row(name, source, replaces, rec):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": total[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]}

    kernels = [
        row("fused_mlp", "fused_mlp.cu", tpu + "fused_mlp.py:135", mlp),
        row("fused_mlp_train_forward", "fused_mlp.cu",
            tpu + "fused_mlp.py:135", mlp_train[0]),
        row("fused_mlp_backward", "fused_mlp.cu", tpu + "fused_mlp.py:200",
            mlp_train[1]),
        # the hash grid has no TPU kernel: these replace XLA's gather and
        # its autodiff scatter in hash_encode (rows of the 2^19 layout)
        row("hash_encode_forward", "hash_encode.cu",
            "instantvnr_tpu/ops/hash_encoding.py:332", hashes[19][0]),
        row("hash_encode_backward", "hash_encode.cu",
            "instantvnr_tpu/ops/hash_encoding.py:332", hashes[19][1]),
        # their paired-layout forms (hash_variant="paired"): the gather of
        # hash_encode_paired and the pair-row scatter of its custom_vjp
        row("hash_encode_forward_paired", "hash_encode.cu",
            "instantvnr_tpu/ops/hash_encoding.py:497",
            paired[PAIRED_BATCHES[0]][0]),
        row("hash_encode_backward_paired", "hash_encode.cu",
            "instantvnr_tpu/ops/hash_encoding.py:853",
            paired[PAIRED_BATCHES[0]][1]),
        # XLA's autodiff of hash_encode in its coords (the frame
        # differentiated in its rays); the tcnn layout in bf16 compute,
        # the main path's (the other three forms are in their phases)
        row("hash_encode_coords_backward", "hash_encode.cu",
            "instantvnr_tpu/ops/hash_encoding.py:332",
            coords_grad[("tcnn", "bf16")]),
        row("composite_slabs", "slab_composite.cu",
            tpu + "slab_composite.py:242", comp),
        row("composite_slabs_ext", "slab_composite.cu",
            tpu + "slab_composite.py:292", ext["shaded+shadow"]),
        row("iso_sweep", "iso_sweep.cu", tpu + "iso_sweep.py:99", iso),
        # XLA in JAX, as the hash grid: the wavefront's emission scan
        row("raymarch_emit", "raymarch_emit.cu",
            "instantvnr_tpu/render/raymarch.py:214", emit),
        # JAX's autodiff of the same scan (the frame differentiated in its
        # rays), at the emission phase's shapes
        row("raymarch_emit_backward", "raymarch_emit.cu",
            "instantvnr_tpu/render/raymarch.py:214", emit_bwd),
        # XLA in JAX as well: the tracker's event (its halves, at the late
        # event's state) and the brick pool's sampler (the "auto" pool)
        row("pt_track", "pathtrace.cu",
            "instantvnr_tpu/render/pathtrace.py:236",
            pt[PT_LATE_EVENT]["pt_track"]),
        row("pt_resolve", "pathtrace.cu",
            "instantvnr_tpu/render/pathtrace.py:236",
            pt[PT_LATE_EVENT]["pt_resolve"]),
        row("brick_sample", "brick_sample.cu",
            "instantvnr_tpu/render/brickcache.py:762",
            bricks["f16,ss1,exact"]),
        # XLA in JAX: the dense emission of marching tetrahedra and the
        # host's compaction of its slots (one 33-plane slab of the grid)
        row("mt_count/mt_emit", "isosurface.cu",
            "instantvnr_tpu/ops/isosurface.py:87", iso_k),
        # XLA in JAX as well: the compacted path's stable partition (its
        # row-gather, the live count) and its unpermute
        row("compact_rows", "compaction.cu",
            "instantvnr_tpu/render/compaction.py:168", compact_k),
        row("scatter_rows", "compaction.cu",
            "instantvnr_tpu/render/compaction.py:816", scatter_k),
        # no TPU kernel: the JAX package leaves Adam to XLA; C1's tree
        row("adam_step", "adam.cu",
            "instantvnr_tpu/models/optimizer.py::adam_update", adam),
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
