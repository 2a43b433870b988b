"""Multi-rank scaling benchmark of the port: DP training samples/s and
ray-sharded render rays/s at each world size, as ONE JSON line (the
counterpart of the root bench_multichip.py).

    python -m instantvnr_torch.bench_multichip --world 4
    python -m instantvnr_torch.bench_multichip --world 2 --backend gloo
    python -m instantvnr_torch.bench_multichip --world 2 --device cpu \\
        --preset tiny

For each world size 1, 2, 4, ... up to --world it spawns that many ranks
on this host (parallel/mesh.py::spawn), one card a rank by default. DP is
weak scaling (the global batch grows with the ranks, 2^16 a rank in the
flagship preset); the render is strong scaling (one 512² frame of the
reference sampler split over the ranks). Two gloo ranks on one card pass
their all-reduce and all-gather through host memory: such a figure
measures host staging, not scaling, and the JSON says so. On the card the
line carries the card's name and power limit. The kernel library is built
before the ranks start, so they load it instead of each running nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _presets(preset: str):
    from instantvnr_torch.config import (EncodingConfig, ModelConfig,
                                         NetworkConfig)

    if preset == "flagship":
        # the reference's example-model.json schema at the bench batch
        return ModelConfig(), 1 << 16, (128, 128, 128), 512, 5
    cfg = ModelConfig(
        encoding=EncodingConfig(n_levels=6, n_features_per_level=4,
                                log2_hashmap_size=12, base_resolution=4),
        network=NetworkConfig(n_neurons=32, n_hidden_layers=2))
    return cfg, 8192, (32, 32, 32), 64, 3


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_bench(rank, dev, preset):
    """One rank's DP and render timings → (ms a step, ms a frame)."""
    import torch

    from instantvnr_torch.accel import macrocell as mcmod
    from instantvnr_torch.config import TransferFunctionConfig
    from instantvnr_torch.data.volume import synthetic_volume
    from instantvnr_torch.models.network import NeuralField
    from instantvnr_torch.models.trainer import create_train_state
    from instantvnr_torch.parallel.mesh import make_mesh
    from instantvnr_torch.parallel.render import make_sharded_render_fn
    from instantvnr_torch.parallel.train import (make_dp_train_step,
                                                 replicate_state)
    from instantvnr_torch.render.camera import Camera, camera_rays
    from instantvnr_torch.render.raymarch import RaymarchSettings
    from instantvnr_torch.render.renderer import reference_sample_fn
    from instantvnr_torch.utils.math import ray_box_intersect
    from instantvnr_torch.utils.tfn import bake_transfer_function

    cfg, batch1, dims, side, steps = _presets(preset)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(device=dev)
    n = mesh.shape["data"]
    field = NeuralField.from_config(cfg)
    vol = synthetic_volume(dims, kind="vorts", device=dev).data
    tf = bake_transfer_function(TransferFunctionConfig(), device=dev)
    mc = mcmod.build(vol, dims, tf)
    # DP, weak scaling: batch1 samples a rank
    state = replicate_state(create_train_state(field, seed=1, device=dev),
                            mesh)
    step = make_dp_train_step(field, mesh, batch=batch1 * n, n_steps=steps)
    state = step(state, vol)
    _sync(dev)
    t0 = time.perf_counter()
    state = step(state, vol)
    _sync(dev)
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    # the ray-sharded frame, strong scaling
    cam = Camera.default_for_dims(dims)
    org_w, dirn = camera_rays(cam, side, side, device=dev)
    dims_f = torch.tensor(dims, dtype=torch.float32, device=dev)
    org = org_w + 0.5 * dims_f
    t0v, t1v, hit = ray_box_intersect(org, dirn, torch.zeros_like(dims_f),
                                      dims_f)
    t0v = torch.where(hit, t0v, torch.ones_like(t0v))
    t1v = torch.where(hit, t1v, torch.zeros_like(t1v))
    jitter = torch.full((org.shape[0],), 0.5, device=dev)
    render = make_sharded_render_fn(
        reference_sample_fn, mesh, RaymarchSettings(n_iters=4,
                                                    max_supersteps=32))
    render(vol, org, dirn, t0v, t1v, mc, tf, jitter)
    _sync(dev)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        rgba = render(vol, org, dirn, t0v, t1v, mc, tf, jitter)
    _sync(dev)
    frame_ms = (time.perf_counter() - t0) / reps * 1e3
    return step_ms, frame_ms, float(state.loss), float(rgba[:, 3].max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--preset", choices=("tiny", "flagship"), default=None)
    a = ap.parse_args(argv)
    import torch

    from instantvnr_torch.parallel.mesh import spawn
    from instantvnr_torch.utils.device import resolve_device

    resolve_device(a.device)
    backend = a.backend or ("nccl" if a.device == "cuda" else "gloo")
    preset = a.preset or ("flagship" if a.device == "cuda" else "tiny")
    _, batch1, _, side, _ = _presets(preset)
    secondary = {"backend": backend, "device": a.device, "preset": preset,
                 "world": a.world}
    if a.device == "cuda":
        from instantvnr_torch.ops.cuda_lib import load_library

        load_library()  # build once, before the ranks start
        secondary["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        secondary["cards"] = torch.cuda.device_count()
        if a.world > torch.cuda.device_count():
            # ranks share a card: gloo stages through host memory
            secondary["note"] = ("ranks share a card: the collectives pass "
                                 "through host memory, so these figures "
                                 "measure host staging, not scaling")
    counts = []
    n = 1
    while n <= a.world:
        counts.append(n)
        n *= 2
    train_rows, render_rows = {}, {}
    for n in counts:
        out = spawn(rank_bench, n, preset, device=a.device, backend=backend,
                    timeout=1800)
        step_ms = max(o[0] for o in out)
        frame_ms = max(o[1] for o in out)
        train_rows[n] = batch1 * n / step_ms / 1e3
        render_rows[n] = side * side / frame_ms / 1e3
        print(f"[multichip] n={n}: DP {step_ms:.3f} ms/step = "
              f"{train_rows[n]:.3f} Msamples/s, render {frame_ms:.3f} "
              f"ms/frame = {render_rows[n]:.3f} Mrays/s", file=sys.stderr,
              flush=True)
    nmax = counts[-1]
    dp_scaling = train_rows[nmax] / (train_rows[1] * nmax) * 100.0
    render_scaling = render_rows[nmax] / (render_rows[1] * nmax) * 100.0
    print(json.dumps({
        "metric": f"DP weak-scaling efficiency at {nmax} ranks",
        "value": dp_scaling, "unit": "%",
        "vs_baseline": dp_scaling / 85.0,  # ≥ 1.0 beats the 85% bar
        "secondary": {**secondary,
                      "render_strong_scaling_pct": render_scaling,
                      **{f"dp_msamples_per_s_n{n}": v
                         for n, v in train_rows.items()},
                      **{f"render_mrays_per_s_n{n}": v
                         for n, v in render_rows.items()}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
